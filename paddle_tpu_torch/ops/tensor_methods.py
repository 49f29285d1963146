"""The Paddle tensor methods torch lacks, attached to ``torch.Tensor``.

Counterpart of ``paddle_tpu/ops/tensor_methods.py``. The port's tensors
are ``torch.Tensor``s, whose own methods every layer, optimizer and
autograd path of the port calls. So ``install`` keeps the reference's
rule for the methods (``_attach``, :13: attach only if absent) for every
name, the dunders too: it attaches the op of each name torch lacks
(``x.astype``, ``x.cast``, ``x.gather_nd``, ``x.leaky_relu``, ...), the
reshaping in-place variants, and the Paddle attributes ``stop_gradient``
(a property over ``requires_grad``), ``clear_grad`` /
``clear_gradient``, ``place``, ``gradient``, ``set_value``,
``persistable`` and ``block_until_ready``. It never replaces a torch
method: that would change every torch caller in the process, the port's
own modules first. Where torch's method of a name means something else
than Paddle's (``x.transpose``, ``x.max(axis)``, ``x.sort()``,
``x.gather``, ``x.shape``, ...), the function form keeps Paddle's meaning
(``paddle.transpose(x, perm)``); README.md's port section has the table
of those names.
"""
from __future__ import annotations

import torch

from ..core.place import CPUPlace, CUDAPlace
from . import activation, linalg, manipulation, math, misc, reduction

T = torch.Tensor

# names attached although they are not ops of the families below (the
# reference's list, tensor_methods.py:85-88, less ``einsum`` and
# ``multiplex``, whose first argument is not a tensor)
_EXTRA = ("concat", "split", "topk", "chunk", "unbind", "expand_as",
          "broadcast_to", "qr", "svd", "eigh", "quantile")
_NOT_METHODS = ("einsum", "multiplex")
_RENAMED = {"pow_": "pow", "slice_": "slice"}


def _attach(name, fn):
    if not hasattr(T, name):
        setattr(T, name, fn)
        _ATTACHED.append(name)


_ATTACHED: list = []


def _stop_gradient(self) -> bool:
    return not self.requires_grad


def _set_stop_gradient(self, flag):
    self.requires_grad_(not flag)


def _place(self):
    return CPUPlace() if self.device.type == "cpu" else \
        CUDAPlace(self.device.index or 0)


def _clear_grad(self):
    self.grad = None


def _gradient(self):
    """The gradient as an ndarray (None before a backward)."""
    return None if self.grad is None else self.grad.detach().cpu().numpy()


def _set_value(self, value):
    """Write ``value`` (a tensor, an ndarray, a number) into this tensor
    in place, cast to its dtype; a shape other than its own raises."""
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    if tuple(v.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch {tuple(v.shape)} vs "
                         f"{tuple(self.shape)}")
    with torch.no_grad():
        self.copy_(v)
    return self


def _block_until_ready(self):
    if self.is_cuda:
        torch.cuda.synchronize(self.device)
    return self


def install() -> list:
    """Attach the names above; returns those attached."""
    for mod in (math, reduction, manipulation, linalg, activation):
        for name in dir(mod):
            fn = getattr(mod, name)
            if name.startswith("_") or not callable(fn):
                continue
            if (hasattr(fn, "op_name") or name in _EXTRA) and \
                    name not in _NOT_METHODS:
                _attach(_RENAMED.get(name, name), fn)
    for name in ("reshape_", "squeeze_", "unsqueeze_", "flatten_",
                 "scatter_", "scale_"):
        _attach(name, getattr(misc, name))
    _attach("astype", misc.cast)
    _attach("cast", misc.cast)
    _attach("stop_gradient", property(_stop_gradient, _set_stop_gradient))
    _attach("place", property(_place))
    _attach("clear_grad", _clear_grad)
    _attach("clear_gradient", _clear_grad)
    _attach("gradient", _gradient)
    _attach("set_value", _set_value)
    _attach("persistable", False)
    _attach("block_until_ready", _block_until_ready)
    return list(_ATTACHED)
