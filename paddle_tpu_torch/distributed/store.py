"""TCPStore: the rendezvous key-value store of the PyTorch port.

Counterpart of ``paddle_tpu/distributed/store.py``: ``TCPStore(host,
port, is_master, world_size, timeout)`` with ``set`` / ``get`` / ``add`` /
``wait`` / ``delete_key`` / ``barrier``, over the native server and client
of ``csrc/tcp_store.cc`` (``utils/native.py`` builds it at first use; a
failed build raises). ``_PyClient`` and ``_PyServer`` speak the same wire
protocol in Python, so a Python peer and a native one interoperate:

    request : u8 op | u32 klen | key | u32 vlen | value
    ops     : 0=SET 1=GET 2=ADD(i64 delta in value) 3=WAIT 4=DELETE
    response: u32 vlen | value   (SET / DELETE reply vlen = 0)

``torch.distributed`` makes its groups through its own stores; this store
serves a script's key exchange and barriers, as Paddle's ``core.TCPStore``
does.
"""
from __future__ import annotations

import ctypes
import socket
import struct
import threading
import time

from ..utils import native as _native

# the largest value get / wait read back through the native client
VALUE_CAP = 1 << 20


class _PyClient:
    """A client of the wire protocol, in Python."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        deadline = time.time() + timeout
        last = None
        while time.time() < deadline:
            try:
                self.sock = socket.create_connection((host, port), timeout=5)
                self.sock.settimeout(None)
                self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self.lock = threading.Lock()
                return
            except OSError as e:
                last = e
                time.sleep(0.2)
        raise ConnectionError(f"cannot reach TCPStore {host}:{port}: {last}")

    def _roundtrip(self, op: int, key: bytes, value: bytes) -> bytes:
        with self.lock:
            msg = (struct.pack("<BI", op, len(key)) + key
                   + struct.pack("<I", len(value)) + value)
            self.sock.sendall(msg)
            rlen = struct.unpack("<I", self._recv(4))[0]
            return self._recv(rlen) if rlen else b""

    def _recv(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("TCPStore connection closed")
            buf += chunk
        return buf

    def set(self, key: str, value: bytes):
        self._roundtrip(0, key.encode(), value)

    def get(self, key: str) -> bytes:
        return self._roundtrip(1, key.encode(), b"")

    def add(self, key: str, delta: int) -> int:
        out = self._roundtrip(2, key.encode(), struct.pack("<q", delta))
        return struct.unpack("<q", out)[0]

    def wait(self, key: str) -> bytes:
        return self._roundtrip(3, key.encode(), b"")

    def delete_key(self, key: str):
        self._roundtrip(4, key.encode(), b"")

    def close(self):
        self.sock.close()


class _PyServer:
    """A server of the wire protocol, in Python (``port`` 0 takes a free
    one: ``self.port``)."""

    def __init__(self, port: int):
        self.data = {}
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("0.0.0.0", port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(128)
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        def recv(n):
            buf = b""
            while len(buf) < n:
                c = conn.recv(n - len(buf))
                if not c:
                    raise ConnectionError
                buf += c
            return buf
        try:
            while True:
                op, klen = struct.unpack("<BI", recv(5))
                key = recv(klen).decode()
                vlen = struct.unpack("<I", recv(4))[0]
                value = recv(vlen)
                if op == 0:
                    with self.cond:
                        self.data[key] = value
                        self.cond.notify_all()
                    out = b""
                elif op == 1:
                    with self.lock:
                        out = self.data.get(key, b"")
                elif op == 2:
                    delta = struct.unpack("<q", value)[0] if vlen == 8 else 0
                    with self.cond:
                        cur = struct.unpack(
                            "<q", self.data.get(key, b"\0" * 8))[0]
                        new = cur + delta
                        self.data[key] = struct.pack("<q", new)
                        self.cond.notify_all()
                    out = struct.pack("<q", new)
                elif op == 3:
                    with self.cond:
                        while key not in self.data:
                            self.cond.wait()
                        out = self.data[key]
                elif op == 4:
                    with self.cond:
                        self.data.pop(key, None)
                    out = b""
                else:
                    return
                conn.sendall(struct.pack("<I", len(out)) + out)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        self.sock.close()


class TCPStore:
    """``core.TCPStore(host, port, is_master, world_size, timeout)``: the
    master starts the native server on ``port``; every rank connects a
    native client, retrying until ``timeout`` seconds pass."""

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 300.0):
        self.host = host
        self.port = port
        self.is_master = is_master
        self.world_size = world_size
        self._lib = _native.get_lib()
        # one socket per store: threads interleaving request and response
        # frames on one socket would deadlock the protocol
        self._mu = threading.Lock()
        self._server = None
        if is_master:
            self._server = self._lib.tcpstore_server_start(port)
            if not self._server:
                raise RuntimeError(f"cannot bind TCPStore on :{port}")
        ip = socket.gethostbyname(host)
        deadline = time.time() + timeout
        fd = -1
        while time.time() < deadline:
            fd = self._lib.tcpstore_connect(ip.encode(), port)
            if fd >= 0:
                break
            time.sleep(0.2)
        if fd < 0:
            raise ConnectionError(f"cannot reach TCPStore {host}:{port}")
        self._fd = fd

    def _read(self, fn, key: str) -> bytes:
        buf = ctypes.create_string_buffer(VALUE_CAP)
        with self._mu:
            n = fn(self._fd, key.encode(), buf, VALUE_CAP)
        if n < 0:
            raise ConnectionError("TCPStore request failed")
        if n > VALUE_CAP:
            raise ValueError(f"TCPStore value of {key!r} holds {n} bytes, "
                             f"more than {VALUE_CAP}")
        return buf.raw[:n]

    def set(self, key: str, value) -> None:
        v = value if isinstance(value, bytes) else str(value).encode()
        with self._mu:
            rc = self._lib.tcpstore_set(self._fd, key.encode(), v, len(v))
        if rc != 0:
            raise ConnectionError("TCPStore set failed")

    def get(self, key: str) -> bytes:
        """The value of ``key`` (b"" while unset)."""
        return self._read(self._lib.tcpstore_get, key)

    def add(self, key: str, delta: int) -> int:
        with self._mu:
            out = self._lib.tcpstore_add(self._fd, key.encode(), int(delta))
        if out == -(2 ** 63):
            raise ConnectionError("TCPStore add failed")
        return int(out)

    def wait(self, key: str) -> bytes:
        """Block until ``key`` is set; its value."""
        return self._read(self._lib.tcpstore_wait, key)

    def delete_key(self, key: str) -> None:
        with self._mu:
            self._lib.tcpstore_delete(self._fd, key.encode())

    def barrier(self, name: str, world_size: int | None = None):
        """Every rank adds one; all return once the count reaches the
        world size."""
        world_size = world_size or self.world_size
        if self.add(f"__barrier__/{name}", 1) == world_size:
            self.set(f"__barrier_done__/{name}", b"1")
        self.wait(f"__barrier_done__/{name}")

    def close(self):
        if self._fd is not None:
            self._lib.tcpstore_close(self._fd)
            self._fd = None
