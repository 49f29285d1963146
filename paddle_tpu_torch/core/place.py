"""Device resolution and places of the PyTorch port.

Counterpart of ``paddle_tpu/core/place.py`` (``Place`` :18, ``CPUPlace``
:46, ``CUDAPlace`` :56, ``set_device`` :103, ``get_device`` :110). The
JAX package resolves a place to a ``jax.Device``; here a place names a
``torch.device``. Every entry point of the port runs on the process-wide
default device unless its caller passes ``device``. The default starts as
``cuda``; ``set_device("cpu")`` is one of the ways a caller asks for the
CPU (the tests do, or pass ``device="cpu"``). Without CUDA a ``cuda``
request, explicit or by default, raises: the port never falls back to
the CPU on its own.
"""
from __future__ import annotations

import torch

_default = torch.device("cuda")


class Place:
    """A device kind and index (``phi::Place``); ``torch_device`` is the
    ``torch.device`` it names."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class CUDAPinnedPlace(CPUPlace):
    """Host memory: the CPU place (pinning is the caller's
    ``pin_memory()``)."""


def _check(dev: torch.device) -> torch.device:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or call "
            "set_device('cpu')) to run the port's plain PyTorch path on "
            "the CPU")
    return dev


def _parse(device) -> torch.device:
    """A place, a ``torch.device`` or a name ("cpu", "gpu", "gpu:N",
    "cuda", "cuda:N") -> ``torch.device``."""
    if isinstance(device, Place):
        return device.torch_device
    if isinstance(device, torch.device):
        return device
    name = str(device).lower()
    kind, _, idx = name.partition(":")
    if kind == "gpu":
        kind = "cuda"
    return torch.device(f"{kind}:{idx}" if idx else kind)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the default device (``cuda`` unless ``set_device`` said
    otherwise); a place, a ``torch.device`` or a name pass through.
    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and absent."""
    return _check(_default if device is None else _parse(device))


def set_device(device) -> Place:
    """``paddle.set_device``: make ``device`` ("cpu", "gpu", "gpu:N",
    "cuda", "cuda:N" or a place) the process-wide default. Raises when it
    names CUDA and there is none."""
    global _default
    _default = _check(_parse(device))
    return _place_of(_default)


def get_device() -> str:
    """The default device as "cpu:0" or "gpu:N", the reference's form."""
    p = _place_of(_default)
    return f"{p.device_type}:{p.device_id}"


def _place_of(dev: torch.device) -> Place:
    if dev.type == "cpu":
        return CPUPlace()
    return CUDAPlace(dev.index or 0)


def device_count() -> int:
    """Cards of the default device's kind (1 for the CPU)."""
    return torch.cuda.device_count() if _default.type == "cuda" else 1


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()
