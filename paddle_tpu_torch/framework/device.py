"""``paddle.device`` of the PyTorch port.

Counterpart of ``paddle_tpu/framework/device.py``, mapped onto
``torch.cuda``: the places and ``set_device`` / ``get_device``
(``core.place``); the memory statistics (``memory_allocated``,
``max_memory_allocated``, ``memory_reserved``, ``max_memory_reserved``,
``reset_peak_memory_stats``, ``reset_max_memory_allocated``,
``memory_stats``, ``empty_cache``) of the CUDA caching allocator; the
``cuda`` namespace with ``synchronize``; the device listings; and the
build predicates. The reference answers "cuda" with its TPU (``:8``);
here it is the card.

A device argument is an index, a place, a ``torch.device`` or a name, the
default device when None: the statistics of the CPU are empty (0), and a
CUDA device raises where there is none, as every entry point of the port.
"""
from __future__ import annotations

import gc

import torch

from ..core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                          Place, _parse, device_count, get_device,
                          is_compiled_with_cuda, resolve_device, set_device)


def cuda_device_count() -> int:
    return torch.cuda.device_count()


def _cuda(device=None):
    """``device`` as a CUDA ``torch.device``, or None for the CPU."""
    if isinstance(device, int):
        device = torch.device("cuda", device)
    dev = resolve_device(None if device is None else _parse(device))
    return dev if dev.type == "cuda" else None


def memory_stats(device=None) -> dict:
    d = _cuda(device)
    return dict(torch.cuda.memory_stats(d)) if d is not None else {}


def memory_allocated(device=None) -> int:
    d = _cuda(device)
    return int(torch.cuda.memory_allocated(d)) if d is not None else 0


def max_memory_allocated(device=None) -> int:
    d = _cuda(device)
    return int(torch.cuda.max_memory_allocated(d)) if d is not None else 0


def memory_reserved(device=None) -> int:
    d = _cuda(device)
    return int(torch.cuda.memory_reserved(d)) if d is not None else 0


def max_memory_reserved(device=None) -> int:
    d = _cuda(device)
    return int(torch.cuda.max_memory_reserved(d)) if d is not None else 0


def reset_peak_memory_stats(device=None) -> None:
    d = _cuda(device)
    if d is not None:
        torch.cuda.reset_peak_memory_stats(d)


def reset_max_memory_allocated(device=None) -> None:
    reset_peak_memory_stats(device)


def empty_cache() -> None:
    """Collect dead Python objects, then give the caching allocator's
    free blocks back to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def synchronize(device=None) -> None:
    """Wait for every kernel queued on the card (none on the CPU)."""
    d = _cuda(device)
    if d is not None:
        torch.cuda.synchronize(d)


class cuda:
    """The ``paddle.device.cuda`` namespace."""
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    reset_peak_memory_stats = staticmethod(reset_peak_memory_stats)
    reset_max_memory_allocated = staticmethod(reset_max_memory_allocated)
    memory_stats = staticmethod(memory_stats)
    empty_cache = staticmethod(empty_cache)
    device_count = staticmethod(cuda_device_count)
    synchronize = staticmethod(synchronize)


def get_all_device_type() -> list:
    """The device kinds present: "gpu" with a card, and "cpu"."""
    return (["gpu"] if torch.cuda.is_available() else []) + ["cpu"]


def get_all_custom_device_type() -> list:
    from .custom_device import get_all_custom_device_type as _g
    return _g()


def get_available_device() -> list:
    """"gpu:N" for each card, else ["cpu:0"]."""
    if torch.cuda.is_available():
        return [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu:0"]


def get_available_custom_device() -> list:
    from .custom_device import _REGISTERED, get_device_count
    out = []
    for name in _REGISTERED:
        out.extend(f"{name}:{i}" for i in range(get_device_count(name)))
    return out


def get_cudnn_version():
    """cuDNN's version number, or None without a CUDA build of it."""
    if not is_compiled_with_cuda():
        return None
    return torch.backends.cudnn.version()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False
