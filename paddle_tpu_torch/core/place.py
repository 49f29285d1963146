"""Device resolution for the PyTorch port.

Counterpart of ``paddle_tpu/core/place.py``. The JAX package resolves a
place to a ``jax.Device``; here a place is a ``torch.device``. Every entry
point of the port runs on ``cuda`` unless its caller asks for ``"cpu"``
(the tests do). Without CUDA a default or ``"cuda"`` request raises: the
port never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"`` or a
    ``torch.device`` pass through. Raises RuntimeError when CUDA is asked
    for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
