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
Each source is compiled to an object and linked into its library; a
source may have more translation units, the ``.cu`` files of
``<name>_parts/`` (template instances split off so that their nvcc
processes run beside the source's), compiled at once with it and linked
into the one library.

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
import time
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


def parts(name: str) -> list:
    """The other translation units of kernel ``name``: the ``.cu`` files
    of ``<name>_parts/``, in order (none for most kernels)."""
    return sorted((KERNEL_DIR / f"{name}_parts").glob("*.cu"))


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
    text = b"".join(_with_headers(src, set())
                    for src in [KERNEL_DIR / f"{name}.cu", *parts(name)])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _command(src: Path, out: Path, flags) -> list:
    cmd = [nvcc_path(), *flags, "-o", str(out), str(src)]
    if os.environ.get("PADDLE_TPU_TORCH_PTXAS_VERBOSE") == "1":
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def _build_one(name: str, lib: Path, t0: float):
    """Build kernel ``name``'s library at ``lib``: each translation unit
    (the source and its parts) compiled to an object, all at once, then
    the objects linked. Returns (nvcc's output, {unit: seconds since t0
    at its end, and the link's}, the failure or None)."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    jobs = {("" if u.parent == KERNEL_DIR else u.parent.name + "/")
            + u.stem: (u, tmp.with_suffix(f".{i}.o"))
            for i, u in enumerate([KERNEL_DIR / f"{name}.cu",
                                   *parts(name)])}

    def compile_unit(job):
        src, out = job
        proc = subprocess.run(_command(src, out, compile_flags),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(compile_unit, jobs.values())))
    logs, seconds, failed = [], {}, None
    for unit, (proc, took) in done.items():
        seconds[unit] = took
        logs.append(proc.stdout)
        if proc.returncode != 0 and failed is None:
            failed = f"{jobs[unit][0].name} (nvcc exit {proc.returncode})"
    if failed is None:
        link = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                               *(str(o) for _, o in jobs.values())],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        seconds["(link)"] = time.perf_counter() - t0
        logs.append(link.stdout)
        if link.returncode != 0:
            failed = f"{name} (link exit {link.returncode})"
    for _, out in jobs.values():
        out.unlink(missing_ok=True)
    if failed is None:
        os.replace(tmp, lib)
    else:
        tmp.unlink(missing_ok=True)
    return "".join(logs), seconds, failed


def build_all(names=None, seconds=None) -> dict:
    """Compile every kernel whose library is missing, every translation
    unit's nvcc started together (``_build_one``). Returns {name:
    compiler output} (ptxas' report when verbose); ``seconds``, a dict,
    receives {name: the wall seconds until its library was linked}, and
    for a kernel with parts each unit's and the link's. Raises
    RuntimeError naming each source that failed, with nvcc's output."""
    from concurrent.futures import ThreadPoolExecutor
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: library_path(name) for name in names
            if not library_path(name).exists()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        done = {name: pool.submit(_build_one, name, lib, t0)
                for name, lib in todo.items()}
    logs, failed = {}, []
    for name, future in done.items():
        logs[name], took, bad = future.result()
        if seconds is not None:
            seconds[name] = max(took.values())
            if len(took) > 2:       # parts: each unit's and the link's
                seconds.update({f"{name}:{unit}": s
                                for unit, s in took.items()})
        if bad is not None:
            failed.append(f"{bad}:\n{logs[name]}")
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
