"""Build, load and launch the port's CUDA kernels.

Each ``<name>.cu`` in this directory is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``. Its entry points take device pointers, shapes and, last,
a stream, and return a ``cudaError_t``; ``<name>_error_string`` names
one. ``launch`` calls an entry point on PyTorch's current stream and
raises on an error. Libraries go to ``build/paddle_tpu_torch/`` at the root of
the checkout, named by a hash of their source and of the ``.cuh`` headers
it includes, so an edited source or header is rebuilt and an unchanged
one is reused. Nothing is built when a module is
imported: the first launch builds (``load``), or ``build_all`` builds
every kernel at once, one ``nvcc`` process per source, all in parallel.

``nvcc`` is taken from ``$CUDA_HOME/bin``, else from ``PATH``, else from
the toolkit's default prefix. Set ``PADDLE_TPU_TORCH_PTXAS_VERBOSE=1`` to
have ptxas print each kernel's registers, shared memory and spills.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict = {}


def sources() -> list:
    """Names of every kernel source in this directory."""
    return sorted(p.stem for p in KERNEL_DIR.glob("*.cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _with_headers(src: Path, seen: set) -> bytes:
    """The bytes of ``src`` and, depth first, of every header of this
    directory it includes with quotes (each once)."""
    text = src.read_bytes()
    out = [text]
    for inc in _LOCAL_INCLUDE.findall(text):
        header = src.parent / inc.decode()
        if header not in seen and header.exists():
            seen.add(header)
            out.append(_with_headers(header, seen))
    return b"".join(out)


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is built: named by a hash of its
    source, the headers it includes and the flags, so an edit of any of
    them builds a new library."""
    src = KERNEL_DIR / f"{name}.cu"
    digest = hashlib.sha256(_with_headers(src, set())
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _command(name: str, out: Path) -> list:
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
           str(KERNEL_DIR / f"{name}.cu")]
    if os.environ.get("PADDLE_TPU_TORCH_PTXAS_VERBOSE") == "1":
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(names=None) -> dict:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns {name: compiler output}
    (ptxas' report when verbose). Raises RuntimeError naming each source
    that failed, with nvcc's output."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed and
    kept for the process. Each entry point of ``signatures`` ({C function:
    argtypes}) is declared to take those arguments and then the stream,
    and to return a cudaError_t; pass every pointer and the stream as
    ``c_void_p`` so ctypes never cuts one to 32 bits."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.error_string = getattr(lib, f"{name}_error_string")
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def launch(lib: ctypes.CDLL, fn_name: str, device, *args) -> None:
    """Call the entry point ``fn_name`` of ``lib`` (from ``load``) with
    ``args`` and the current stream of ``device``, with ``device`` the
    current device (the runtime launches there). A nonzero cudaError_t
    raises RuntimeError with the runtime's message."""
    fn = getattr(lib, fn_name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.error_string(err).decode()} "
                           f"(cudaError {err})")
