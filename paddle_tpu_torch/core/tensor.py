"""``Tensor``, ``Parameter`` and ``to_tensor`` of the PyTorch port.

Counterpart of ``paddle_tpu/core/tensor.py`` (``Tensor`` :25,
``Parameter`` :223, ``to_tensor`` :243). The reference wraps a
``jax.Array`` in a ``Tensor`` of its own; here ``Tensor`` *is*
``torch.Tensor``, the type every layer, optimizer and autograd path of the
port already uses, and ``ops.tensor_methods`` attaches to it the Paddle
names torch lacks. ``Parameter`` is a ``torch.nn.Parameter`` with
``trainable`` over ``requires_grad``.

``to_tensor`` gives the reference's dtypes: Python ints and integer
arrays int32, Python floats and float64 arrays the default float type
(float32), complex128 complex64 (``core.dtype.x32``); a torch tensor keeps
its dtype. It copies onto ``place`` (the default device when None:
``cuda`` unless ``set_device`` said otherwise).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as _dt
from .place import resolve_device

Tensor = torch.Tensor


class Parameter(torch.nn.Parameter):
    """A trainable tensor; ``trainable`` is ``requires_grad``."""

    def __new__(cls, value, trainable: bool = True, name: str | None = None):
        data = value.detach() if isinstance(value, torch.Tensor) \
            else to_tensor(value)
        p = super().__new__(cls, data, requires_grad=bool(trainable) and (
            data.is_floating_point() or data.is_complex()))
        p.persistable = True
        if name is not None:
            p.param_name = name
        return p

    def __init__(self, value, trainable: bool = True, name=None):
        pass

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag: bool):
        self.requires_grad_(bool(flag))


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> torch.Tensor:
    """``paddle.to_tensor``: a new tensor holding ``data`` on ``place``,
    of ``dtype`` (the reference's rule above when None); it needs a
    gradient when ``stop_gradient`` is False."""
    dev = resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev, copy=True)
    else:
        arr = np.asarray(data)
        if arr.dtype.kind not in "biufc" and arr.dtype.name != "bfloat16":
            raise TypeError(f"to_tensor: cannot hold {arr.dtype}")
        t = _dt.numpy_to_torch(arr)
        if arr.dtype == np.float64:
            t = t.to(_dt.get_default_dtype())
        t = t.to(dev, _dt.x32(t.dtype))
    if dtype is not None:
        t = t.to(_dt.x32(dtype))
    if not stop_gradient:
        t.requires_grad_(True)
    return t
