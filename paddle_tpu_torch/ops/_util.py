"""Helpers shared by the op families of the PyTorch port: the op
decorator with the 32-bit rule, argument normalisation, and Python
operands made tensors."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.dtype import _X32, numpy_to_torch, x32
from ..core.place import resolve_device
from .dispatch import apply_op, def_op


def _in_dtypes(args, out):
    for a in args:
        if isinstance(a, torch.Tensor):
            out.add(a.dtype)
        elif isinstance(a, (list, tuple)):
            _in_dtypes(a, out)
    return out


def narrow(out, args):
    """``out`` with each 64-bit tensor given as its 32-bit type (the JAX
    package's, whose 64-bit types are off), unless a tensor of ``args``
    had that 64-bit type."""
    def one(t, seen):
        if isinstance(t, torch.Tensor) and t.dtype in _X32 and \
                t.dtype not in seen:
            return t.to(_X32[t.dtype])
        return t
    if isinstance(out, torch.Tensor):
        return one(out, _in_dtypes(args, set())) if out.dtype in _X32 \
            else out
    if isinstance(out, (tuple, list)) and any(
            isinstance(t, torch.Tensor) and t.dtype in _X32 for t in out):
        seen = _in_dtypes(args, set())
        return type(out)(one(t, seen) for t in out)
    return out


def op(name=None, nondiff=False):
    """``def_op`` with ``narrow`` applied to the op's outputs."""
    def deco(fn):
        @functools.wraps(fn)
        def fn32(*args, **kwargs):
            return narrow(fn(*args, **kwargs), args)
        return def_op(name or fn.__name__, nondiff)(fn32)
    return deco


def call(name, fn, *args, nondiff=False, **kwargs):
    """``apply_op`` of a function made at the call, with ``narrow``."""
    return apply_op(name, lambda *a, **k: narrow(fn(*a, **k), a), *args,
                    nondiff=nondiff, **kwargs)


def as_tensor(v, like=None):
    """``v`` as a tensor: a tensor passes; an ndarray or a Python number
    goes to ``like``'s device (the default device when None) with the
    reference's dtype (``to_tensor``'s rule)."""
    if isinstance(v, torch.Tensor):
        return v
    dev = like.device if isinstance(like, torch.Tensor) else \
        resolve_device(None)
    if isinstance(v, np.ndarray):
        t = numpy_to_torch(v)
        return t.to(dev, x32(t.dtype))
    t = torch.as_tensor(v, device=dev)
    return t.to(x32(t.dtype)) if t.dtype in _X32 else t


def pair(x, y):
    """Two operands of a binary op, a non-tensor one made a tensor on the
    other's device (``as_tensor``)."""
    like = x if isinstance(x, torch.Tensor) else y
    return as_tensor(x, like), as_tensor(y, like)


def shape_list(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s) for s in shape]


def norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(axis, nd):
    """``axis`` (None: every axis) as a tuple of axes."""
    axis = norm_axis(axis)
    if axis is None:
        return tuple(range(nd))
    return axis if isinstance(axis, tuple) else (axis,)


def dtype_or(dtype, default):
    return x32(dtype) if dtype is not None else default
