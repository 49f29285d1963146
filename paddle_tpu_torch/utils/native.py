"""ctypes bindings of the native data path of the PyTorch port.

Counterpart of ``paddle_tpu/utils/native.py:20-137``, for the symbols the
data loader uses: the threaded batch gatherer (``bl_*``,
``csrc/batch_loader.cc``) and the shared-memory record ring
(``shm_ring_*``, ``csrc/shm_ring.cc``). The TCP store and the WordPiece
tokenizer of the same library are not ported yet.

The two sources are compiled with ``g++ -O2 -fPIC -std=c++17 -pthread
-shared ... -lrt`` (``$CXX`` when set) into ``build/paddle_tpu_torch/`` at
the root of the checkout, named by a hash of the sources and the flags, so
an edited source is rebuilt and an unchanged one reused. Nothing is built
when a module is imported: ``get_lib`` builds at its first call. The
sources are read, never written, and ``csrc/Makefile`` is not run.

A failed build raises RuntimeError with the compiler's output. Nothing
falls back: the reference hands over to numpy or to threads when its
library is missing; the port's loader raises instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "csrc"
SOURCES = ("batch_loader.cc", "shm_ring.cc")
BUILD_DIR = ROOT / "build" / "paddle_tpu_torch"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-pthread", "-shared"]
LIBS = ["-lrt"]

_lib = None


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the library is built: named by a hash of both sources, the
    compiler and the flags."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join([_compiler(), *CXX_FLAGS, *LIBS]).encode())
    return BUILD_DIR / f"libpaddle_tpu_torch_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError, with the compiler's output, when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native data-path build failed: {' '.join(cmd)}"
                           f": {e!r}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native data-path build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed and kept for the
    process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _bind_signatures(lib)
        _lib = lib
    return _lib


def _bind_signatures(lib: ctypes.CDLL) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bl_create.restype = vp
    lib.bl_create.argtypes = [vp, i64, i64, i64, i32, i32]
    lib.bl_submit.restype = i64
    lib.bl_submit.argtypes = [vp, vp, i64]
    lib.bl_next.restype = i64
    lib.bl_next.argtypes = [vp, vp]
    lib.bl_destroy.restype = None
    lib.bl_destroy.argtypes = [vp]
    lib.shm_ring_create.restype = vp
    lib.shm_ring_create.argtypes = [ctypes.c_char_p, i64, i64]
    lib.shm_ring_open.restype = vp
    lib.shm_ring_open.argtypes = [ctypes.c_char_p]
    lib.shm_ring_slot_size.restype = i64
    lib.shm_ring_slot_size.argtypes = [vp]
    lib.shm_ring_write.restype = i64
    lib.shm_ring_write.argtypes = [vp, vp, i64]
    lib.shm_ring_read.restype = i64
    lib.shm_ring_read.argtypes = [vp, vp, i64, i64]
    lib.shm_ring_close.restype = None
    lib.shm_ring_close.argtypes = [vp]
