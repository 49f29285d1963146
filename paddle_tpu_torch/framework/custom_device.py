"""The custom-device slot of the PyTorch port.

Counterpart of ``paddle_tpu/framework/custom_device.py`` (register, fake,
list, unregister). The reference registers a PJRT plugin; here a plugin
is a shared object that PyTorch loads (``torch.ops.load_library``: it
registers its operators or its ``PrivateUse1`` backend itself).
``register_fake_device`` aliases an existing backend ("cpu" or "cuda")
under a name, a test double for the plugin path that needs no hardware.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

_REGISTERED: Dict[str, dict] = {}
_FAKE_DEVICES: Dict[str, str] = {}


def register_custom_device(name: str, library_path: Optional[str] = None,
                           options: Optional[dict] = None) -> None:
    """Register ``name``; with ``library_path``, load that shared object
    into PyTorch first (it must exist)."""
    if library_path is not None:
        if not os.path.exists(library_path):
            raise FileNotFoundError(
                f"custom device plugin not found: {library_path}")
        torch.ops.load_library(library_path)
    _REGISTERED[name] = {"library_path": library_path,
                         "options": options or {}}


def register_fake_device(name: str, backend: str = "cpu") -> None:
    """Alias ``backend`` under ``name``."""
    _FAKE_DEVICES[name] = backend
    _REGISTERED[name] = {"library_path": None, "fake_backend": backend,
                         "options": {}}


def get_all_custom_device_type() -> list:
    return sorted(_REGISTERED)


def is_custom_device(name: str) -> bool:
    return name in _REGISTERED


def _backend_count(backend: str) -> int:
    if backend == "cpu":
        return 1
    if backend in ("cuda", "gpu"):
        return torch.cuda.device_count()
    mod = getattr(torch, backend, None)
    count = getattr(mod, "device_count", None)
    return int(count()) if callable(count) else 0


def get_device_count(name: str) -> int:
    return _backend_count(_FAKE_DEVICES.get(name, name))


def devices(name: str) -> list:
    """The ``torch.device``s of ``name`` (of its aliased backend for a
    fake one)."""
    backend = _FAKE_DEVICES.get(name, name)
    kind = "cuda" if backend == "gpu" else backend
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device(kind, i) for i in range(_backend_count(backend))]


def unregister_custom_device(name: str) -> None:
    _REGISTERED.pop(name, None)
    _FAKE_DEVICES.pop(name, None)
