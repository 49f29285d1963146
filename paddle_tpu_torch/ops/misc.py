"""The rest of the top-level op namespace of the PyTorch port.

Counterpart of ``paddle_tpu/ops/misc.py``: ``cast``, ``add_n``,
``logit``, ``dist``, ``nanquantile``, ``tensordot``, ``crop``,
``reverse``, ``complex``, ``floor_mod``, the predicates and attributes
(``is_tensor``, ``shape``, ``rank``, ``numel``, ...), ``increment``, the
random ``poisson`` / ``standard_normal`` / ``randint_like``,
``create_parameter``, ``unique_consecutive`` and the in-place variants
(``_install_inplace``, :265). The reference's in-place variants rebind the
tensor's value; here they are torch's in-place ops where torch has them
(``tanh_`` is ``x.tanh_()``), ``x.data = ...`` for the reshaping ones, and
they return ``x``. ``cast(x, "int64")`` is int32 and ``shape`` /
``rank`` / ``numel`` are int32, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as _dt
from ..core.generator import torch_generator
from ..core.place import resolve_device
from ..core.tensor import Parameter
from ._util import as_tensor, op, shape_list


@op("cast")
def cast(x, dtype):
    return x.to(_dt.x32(dtype))


def add_n(inputs):
    """The sum of a list of tensors, one ``add`` op per term."""
    from .math import add
    if isinstance(inputs, (list, tuple)):
        out = inputs[0]
        for t in inputs[1:]:
            out = add(out, t)
        return out
    return as_tensor(inputs)


@op("logit")
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op("dist")
def dist(x, y, p=2):
    d = torch.abs(x - y)
    p = float(p)
    if p == float("inf"):
        return torch.amax(d)
    if p == float("-inf"):
        return torch.amin(d)
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    return torch.sum(d ** p) ** (1.0 / p)


@op("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False):
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.nanquantile(x, qt, dim=axis, keepdim=keepdim)


@op("tensordot")
def tensordot(x, y, axes=2):
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        axes = [a.tolist() if isinstance(a, torch.Tensor) else
                list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


@op("crop")
def crop(x, shape=None, offsets=None):
    nd = x.dim()
    shape = list(x.shape) if shape is None else shape_list(shape)
    shape = [x.shape[i] if shape[i] in (-1, 0) else shape[i]
             for i in range(nd)]
    offsets = [0] * nd if offsets is None else shape_list(offsets)
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@op("reverse")
def reverse(x, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


@op("complex")
def complex(real, imag):  # noqa: A001 - the reference's name
    return torch.complex(real, imag)


@op("floor_mod")
def floor_mod(x, y):
    return torch.remainder(x, y)


# ---- predicates and attributes (host side) -------------------------------

def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _dtype_of(x):
    return x.dtype if isinstance(x, torch.Tensor) else \
        _dt.x32(_dt.numpy_to_torch(np.asarray(x)).dtype)


def is_complex(x) -> bool:
    return _dtype_of(x).is_complex


def is_floating_point(x) -> bool:
    return _dtype_of(x).is_floating_point


def is_integer(x) -> bool:
    d = _dtype_of(x)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def _int32(v, like):
    dev = like.device if isinstance(like, torch.Tensor) else \
        resolve_device(None)
    return torch.tensor(v, dtype=torch.int32, device=dev)


def shape(x):
    """The shape as an int32 tensor."""
    return _int32(list(x.shape) if isinstance(x, torch.Tensor)
                  else list(np.shape(x)), x)


def rank(x):
    return _int32(x.dim() if isinstance(x, torch.Tensor) else np.ndim(x), x)


def numel(x):
    return _int32(math.prod(x.shape), x)


def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def tolist(x):
    return x.tolist() if isinstance(x, torch.Tensor) else \
        np.asarray(x).tolist()


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def increment(x, value=1.0):
    """``x += value`` in place (a 1-element tensor); returns ``x``."""
    with torch.no_grad():
        x.add_(torch.tensor(value, dtype=x.dtype, device=x.device))
    return x


# ---- random ---------------------------------------------------------------

def poisson(x):
    x = as_tensor(x)
    return torch.poisson(x.detach(),
                         generator=torch_generator(None, x.device))


def standard_normal(shape, dtype=None, name=None):
    from .creation import randn
    return randn(shape, dtype=dtype)


def randint_like(x, low=0, high=None, dtype=None):
    from .creation import randint
    target = _dt.x32(dtype if dtype is not None else x.dtype)
    if not (target.is_floating_point or target.is_complex
            or target == torch.bool):
        return randint(low, high, shape=x.shape, dtype=target)
    return randint(low, high, shape=x.shape, dtype="int32").to(target)


# ---- host-side utilities --------------------------------------------------

def create_parameter(shape, dtype, name=None, attr=None,
                     default_initializer=None):
    """A ``Parameter`` of ``shape`` on the default device: made by
    ``default_initializer`` (called as the port's initializers are) when
    given, else U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) with fan_in =
    shape[0] for a float type and zeros otherwise (the reference's
    rule)."""
    shape = [int(s) for s in shape]
    dt = _dt.x32(dtype)
    dev = resolve_device(None)
    if default_initializer is not None:
        val = default_initializer(shape, device=dev).to(dt)
    elif dt.is_floating_point:
        limit = math.sqrt(6.0 / max(1, shape[0] if shape else 1))
        val = torch.empty(shape, dtype=dt, device=dev).uniform_(
            -limit, limit, generator=torch_generator(None, dev))
    else:
        val = torch.zeros(shape, dtype=dt, device=dev)
    return Parameter(val, name=name)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64"):
    """The values of ``x`` with each run of equal ones (along ``axis``;
    flattened when None) kept once, and the int32 inverse and counts."""
    src = x.reshape(-1) if axis is None else x
    out, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    outs = [out]
    if return_inverse:
        outs.append(inv.to(torch.int32))
    if return_counts:
        outs.append(counts.to(torch.int32))
    return outs[0] if len(outs) == 1 else tuple(outs)


# ---- in-place variants ----------------------------------------------------

def _rebind(fn):
    def inplace(x, *args, **kwargs):
        x.data = fn(x, *args, **kwargs).detach()
        return x
    return inplace


def _torch_inplace(method):
    def inplace(x, *args, **kwargs):
        getattr(x, method)(*args, **kwargs)
        return x
    return inplace


def _scale_(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x.mul_(scale).add_(bias)
    return x.add_(bias).mul_(scale)


def _scatter_(x, index, updates, overwrite=True):
    index = index.reshape(-1).long()
    if overwrite:
        return x.index_copy_(0, index, updates.to(x.dtype))
    return x.index_add_(0, index, updates.to(x.dtype))


def _install_inplace():
    from . import manipulation
    ns = {"reshape_": _rebind(manipulation.reshape),
          "squeeze_": _rebind(manipulation.squeeze),
          "unsqueeze_": _rebind(manipulation.unsqueeze),
          "flatten_": _rebind(manipulation.flatten),
          "scatter_": _scatter_, "scale_": _scale_}
    for name, method in (("tanh_", "tanh_"), ("exp_", "exp_"),
                         ("sqrt_", "sqrt_"), ("rsqrt_", "rsqrt_"),
                         ("clip_", "clamp_"), ("ceil_", "ceil_"),
                         ("floor_", "floor_"), ("round_", "round_"),
                         ("reciprocal_", "reciprocal_"),
                         ("subtract_", "sub_"), ("add_", "add_"),
                         ("zero_", "zero_"), ("fill_", "fill_")):
        ns[name] = _torch_inplace(method)
    for name, fn in ns.items():
        fn.__name__ = fn.__qualname__ = name
        globals()[name] = fn
    return list(ns)


_INPLACE_NAMES = _install_inplace()

__all__ = [
    "cast", "add_n", "logit", "dist", "nanquantile", "tensordot", "crop",
    "reverse", "complex", "floor_mod", "is_tensor", "is_complex",
    "is_floating_point", "is_integer", "shape", "rank", "numel", "is_empty",
    "tolist", "broadcast_shape", "increment", "poisson", "standard_normal",
    "randint_like", "create_parameter", "unique_consecutive",
] + _INPLACE_NAMES
