"""The shared-memory record ring and the multiprocess ``DataLoader``
workers of the PyTorch port.

Counterpart of ``paddle_tpu/io/shm_channel.py``: ``ShmRing`` (``:23-70``)
over ``csrc/shm_ring.cc`` (a bounded multi-producer ring in a POSIX
shared-memory segment; records come out in ticket order), the worker body
``_mp_worker_loop`` (``:79-107``) and ``MultiprocessDataLoaderIter``
(``:110-306``) with persistent workers and the shutdown on a worker's
error. Worker processes fetch and collate batches (numpy) and write them,
pickled, into the ring; the parent reads them in ticket order, puts them
back in batch order and makes tensors on the loader's device.

The workers are forked, from a parent that may already hold a CUDA
context. A worker touches nothing of ``torch.cuda``: it freezes the
objects it inherited (``gc.freeze``, so that no collection in the child
frees a card tensor of the parent's), runs only the dataset, the collate
function and pickle, and leaves by ``os._exit`` once its error queue is
flushed, so no CUDA teardown or exit handler of the parent's runs in it.
There is no fallback: without the native library the ring raises.
"""
from __future__ import annotations

import ctypes
import gc
import os
import pickle
import queue
import threading
import time
from typing import Optional

from ..utils import native


class ShmRing:
    """A ctypes view of one ``csrc/shm_ring.cc`` segment: ``create`` makes
    it (``n_slots`` slots of ``slot_size`` bytes), else it is opened by
    name."""

    def __init__(self, name: str, slot_size: int = 1 << 20,
                 n_slots: int = 8, create: bool = False):
        lib = native.get_lib()
        self._lib = lib
        self.name = name.encode()
        if create:
            self._h = lib.shm_ring_create(self.name, slot_size, n_slots)
        else:
            self._h = lib.shm_ring_open(self.name)
        if not self._h:
            raise OSError(f"shm_ring {'create' if create else 'open'} "
                          f"failed for {name}")
        self.slot_size = lib.shm_ring_slot_size(self._h)
        self._buf = ctypes.create_string_buffer(self.slot_size)

    def write(self, payload: bytes) -> int:
        """Append one record (blocks while its slot is full); returns its
        ticket. Raises ValueError when it exceeds ``slot_size``."""
        r = self._lib.shm_ring_write(self._h, payload, len(payload))
        if r < 0:
            raise ValueError(
                f"record of {len(payload)} bytes exceeds slot_size "
                f"{self.slot_size}; construct the ring with a larger "
                "slot_size")
        return r

    def read(self, timeout_us: int = -1) -> Optional[bytes]:
        """The next record in ticket order; None on timeout (b'' is a
        record)."""
        n = self._lib.shm_ring_read(self._h, self._buf, self.slot_size,
                                    timeout_us)
        if n == -2:
            return None
        if n == -1:
            raise ValueError("shm_ring record larger than reader buffer")
        return ctypes.string_at(self._buf, n)

    def close(self):
        if self._h:
            self._lib.shm_ring_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _mp_worker_loop(loader, work_q, ring_name, err_q, worker_id,
                    worker_init_fn):
    """A worker's body: every failure is reported on ``err_q`` or in the
    ring, so the parent never has to guess from a timeout."""
    try:
        ring = ShmRing(ring_name, create=False)
    except (OSError, RuntimeError) as e:
        err_q.put((worker_id, repr(e)))
        return
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        while True:
            item = work_q.get()
            if item is None:
                ring.write(pickle.dumps(("done", worker_id, None)))
                return
            seq, idx_batch = item
            try:
                data = loader._fetch(idx_batch)
                blob = pickle.dumps(("ok", seq, data), protocol=4)
            except Exception as e:  # noqa: BLE001 — shipped to the parent
                blob = pickle.dumps(("err", seq, repr(e)), protocol=4)
            ring.write(blob)
    except Exception as e:  # noqa: BLE001 — init fn, oversize record
        err_q.put((worker_id, repr(e)))
    finally:
        ring.close()


def _mp_worker_entry(*args):
    """The forked process: the worker's body, then ``os._exit`` once the
    error queue is flushed (module docstring)."""
    gc.freeze()
    code = 0
    try:
        _mp_worker_loop(*args)
    except BaseException:  # noqa: BLE001 — leave without teardown
        code = 1
    finally:
        err_q = args[3]
        try:
            err_q.close()
            err_q.join_thread()
        finally:
            os._exit(code)


class MultiprocessDataLoaderIter:
    """The parent's iterator over ``num_workers`` forked workers and one
    ring.

    ``persistent=True`` keeps the workers and the ring across epochs: the
    feeder streams each epoch's index batches under a sequence number that
    goes on counting, and the workers never see an epoch's end."""

    def __init__(self, loader, device, slot_size: int = 4 << 20,
                 persistent: bool = False):
        import multiprocessing as mp
        self.loader = loader
        self.device = device
        self.persistent = persistent
        nw = max(1, loader.num_workers)
        self._ring_name = f"/ptt_dl_{os.getpid()}_{id(self)}"
        self._ring = ShmRing(self._ring_name, slot_size=slot_size,
                             n_slots=max(4, 2 * nw), create=True)
        ctx = mp.get_context("fork")
        self._work_q = ctx.Queue(maxsize=nw * 2)
        self._err_q = ctx.Queue()
        self._procs = []
        for w in range(nw):
            p = ctx.Process(target=_mp_worker_entry,
                            args=(loader, self._work_q, self._ring_name,
                                  self._err_q, w, loader.worker_init_fn),
                            daemon=True)
            p.start()
            self._procs.append(p)
        self._total = len(loader.batch_sampler)
        self._stopping = threading.Event()
        self._feed_error = None
        self._epoch_base = 0
        self._feed_stop = threading.Event()
        self._feeder = threading.Thread(
            target=self._feed, args=(0, self._feed_stop), daemon=True)
        self._feeder.start()
        self._done_workers = 0
        self._next_seq = 0
        self._stash = {}

    @property
    def pids(self):
        """The worker processes' ids."""
        return [p.pid for p in self._procs]

    def start_epoch(self, device=None):
        """Re-arm a persistent iterator for the next epoch (dropping what
        is left of an aborted one)."""
        if device is not None:
            self.device = device
        self._epoch_base += self._total
        self._next_seq = self._epoch_base
        self._stash = {k: v for k, v in self._stash.items()
                       if k >= self._epoch_base}
        if self._feeder.is_alive():
            self._feed_stop.set()
            self._feeder.join(timeout=10)
        self._feed_error = None
        self._feed_stop = threading.Event()
        self._feeder = threading.Thread(
            target=self._feed, args=(self._epoch_base, self._feed_stop),
            daemon=True)
        self._feeder.start()

    def _feed(self, seq_base, stop):
        def bounded_put(item) -> bool:
            while not (self._stopping.is_set() or stop.is_set()):
                try:  # teardown races surface as OSError / ValueError
                    self._work_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
                except (OSError, ValueError):
                    return False
            return False

        try:
            for i, idx_batch in enumerate(self.loader._index_iter()):
                if not bounded_put((seq_base + i, list(idx_batch))):
                    return
        except Exception as e:  # noqa: BLE001 — the sampler's failure
            self._feed_error = e        # raised by __next__
        if not self.persistent:
            for _ in self._procs:
                bounded_put(None)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._next_seq in self._stash:
                data = self._stash.pop(self._next_seq)
                self._next_seq += 1
                return self.loader._to_tensors(data, self.device)
            if self._next_seq >= self._epoch_base + self._total:
                if not self.persistent:
                    self._shutdown(graceful=True)
                raise StopIteration
            blob = None
            for _ in range(30):  # 1-s slices: react to errors fast
                blob = self._ring.read(timeout_us=1_000_000)
                if blob is not None:
                    break
                if self._feed_error is not None:
                    err = self._feed_error
                    self._shutdown()
                    raise RuntimeError(
                        "DataLoader batch sampler failed") from err
                self._check_errors()
                if any(not p.is_alive() and p.exitcode not in (0, None)
                       for p in self._procs):
                    self._shutdown()
                    raise RuntimeError(
                        "DataLoader worker died without reporting "
                        f"(exitcodes {[p.exitcode for p in self._procs]})")
            if blob is None:
                self._shutdown()
                raise TimeoutError("DataLoader workers stalled (30s)")
            kind, seq, data = pickle.loads(blob)
            if kind == "done":
                self._done_workers += 1
                continue
            if seq < self._epoch_base:
                # a stale record of an aborted epoch ('ok' or 'err'): an
                # old error must not end the new epoch
                continue
            if kind == "err":
                self._shutdown()
                raise RuntimeError(f"DataLoader worker failed: {data}")
            self._stash[seq] = data

    def _check_errors(self):
        try:
            wid, err = self._err_q.get_nowait()
        except queue.Empty:
            return
        self._shutdown()
        raise RuntimeError(f"DataLoader worker {wid} failed: {err}")

    def _shutdown(self, graceful: bool = False):
        if getattr(self, "_shut", False):
            return  # a second call must not touch the closed ring
        self._shut = True
        if getattr(self.loader, "_persistent_iter", None) is self:
            self.loader._persistent_iter = None
        if self.persistent:
            # persistent workers never saw an epoch's stop tokens: queue
            # them now (each put on its own: one full queue must not drop
            # the rest)
            for _ in self._procs:
                try:
                    self._work_q.put_nowait(None)
                except Exception:  # noqa: BLE001 — full or closed queue
                    pass
            graceful = True
        if graceful:
            # the stop tokens are queued: let the workers drain them and
            # leave on their own (reading their "done" records), within
            # 5 s, before terminating any
            deadline = time.time() + 5.0
            while (self._done_workers < len(self._procs)
                   and time.time() < deadline):
                blob = self._ring.read(timeout_us=200_000)
                if blob is None:
                    continue
                if pickle.loads(blob)[0] == "done":
                    self._done_workers += 1
            for p in self._procs:
                p.join(timeout=max(0.0, deadline - time.time()) + 0.5)
        self._stopping.set()            # unblock the feeder's puts
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        if hasattr(self, "_feeder"):
            self._feeder.join(timeout=5)
        self._ring.close()

    def close(self):
        """Stop the workers and free the ring."""
        self._shutdown()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:  # noqa: BLE001
            pass
