"""Creation ops of the PyTorch port.

Counterpart of ``paddle_tpu/ops/creation.py``: ``full`` / ``zeros`` /
``ones`` / ``empty`` and their ``_like`` forms, ``arange``, ``linspace``,
``logspace``, ``eye``, ``tril`` / ``triu`` / ``diag`` / ``diagflat``,
``meshgrid``, ``assign``, ``clone`` and the random ops. A new tensor is
made on the default device (``core.place``: ``cuda`` unless
``set_device`` said otherwise; without a card that raises), of the
default float type (float32) unless ``dtype`` is given; a 64-bit
``dtype`` gives the 32-bit one and integer ``arange`` is int32, as in the
reference (``core.dtype.x32``). ``empty`` is zeros, as there.

The random ops (``rand``, ``uniform``, ``randn``, ``normal``,
``randint``, ``randperm``, ``bernoulli``, ``multinomial``) draw from the
default generator's ``torch.Generator`` for the device
(``core.generator``), which ``paddle.seed`` seeds: the same seed gives the
same draws on one device, and other numbers than JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as _dt
from ..core.generator import torch_generator
from ..core.place import resolve_device
from ._util import as_tensor, call, dtype_or, op, shape_list

__all__ = ["full", "zeros", "ones", "full_like", "zeros_like", "ones_like",
           "empty", "empty_like", "arange", "linspace", "logspace", "eye",
           "tril", "triu", "diag", "diagflat", "meshgrid", "assign",
           "clone", "rand", "uniform", "randn", "normal", "randint",
           "randperm", "bernoulli", "multinomial"]


def _float(dtype):
    return dtype_or(dtype, _dt.get_default_dtype())


def full(shape, fill_value, dtype=None):
    return torch.full(shape_list(shape), fill_value, dtype=_float(dtype),
                      device=resolve_device(None))


def zeros(shape, dtype=None):
    return full(shape, 0, dtype)


def ones(shape, dtype=None):
    return full(shape, 1, dtype)


@op("full_like")
def _full_like(x, *, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=dtype)


def full_like(x, fill_value, dtype=None):
    return _full_like(x, fill_value=fill_value,
                      dtype=_dt.x32(dtype) if dtype else None)


def zeros_like(x, dtype=None):
    return full_like(x, 0, dtype)


def ones_like(x, dtype=None):
    return full_like(x, 1, dtype)


def empty(shape, dtype=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if dtype is None:
        dtype = torch.int32 if all(isinstance(v, (int, np.integer)) for v in
                                   (start, end, step)) \
            else _dt.get_default_dtype()
    return torch.arange(start, end, step, dtype=_dt.x32(dtype),
                        device=resolve_device(None))


def linspace(start, stop, num, dtype=None):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=_float(dtype), device=resolve_device(None))


def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(float(start), float(stop), int(num), base=base,
                          dtype=_float(dtype), device=resolve_device(None))


def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(int(num_rows),
                     int(num_columns) if num_columns else int(num_rows),
                     dtype=_float(dtype), device=resolve_device(None))


@op("tril")
def tril(x, diagonal=0):
    return torch.tril(x, int(diagonal))


@op("triu")
def triu(x, diagonal=0):
    return torch.triu(x, int(diagonal))


@op("diag")
def diag(x, offset=0):
    return torch.diag(x, int(offset))


@op("diagflat")
def diagflat(x, offset=0):
    return torch.diagflat(x, int(offset))


def meshgrid(*args):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    ts = [as_tensor(t) for t in ts]
    return list(torch.meshgrid(*ts, indexing="ij"))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, an ndarray or a number: the op
    ``assign``); with ``output``, ``x`` is written into it."""
    if output is not None:
        with torch.no_grad():
            output.copy_(as_tensor(x, output))
        return output
    return call("assign", torch.clone, as_tensor(x))


def clone(x):
    return call("clone", torch.clone, x)


# ---- random creation ops --------------------------------------------------

def _gen(dev):
    return torch_generator(None, dev)


def rand(shape, dtype=None):
    return uniform(shape, dtype, 0.0, 1.0)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    """U[min, max). A nonzero ``seed`` draws from a generator of its own
    made from it."""
    dev = resolve_device(None)
    g = torch.Generator(device=dev).manual_seed(int(seed)) if seed \
        else _gen(dev)
    out = torch.empty(shape_list(shape), dtype=torch.float32, device=dev)
    return out.uniform_(min, max, generator=g).to(_float(dtype))


def randn(shape, dtype=None):
    dev = resolve_device(None)
    return torch.randn(shape_list(shape), generator=_gen(dev), device=dev,
                       dtype=torch.float32).to(_float(dtype))


def normal(mean=0.0, std=1.0, shape=None):
    z = randn([] if shape is None else shape)
    return z * std + mean


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    dev = resolve_device(None)
    return torch.randint(int(low), int(high), shape_list(shape),
                         generator=_gen(dev), device=dev,
                         dtype=_dt.x32(dtype))


def randperm(n, dtype="int64"):
    dev = resolve_device(None)
    return torch.randperm(int(n), generator=_gen(dev), device=dev).to(
        _dt.x32(dtype))


def bernoulli(x):
    x = as_tensor(x)
    return torch.bernoulli(x.detach(), generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False):
    x = as_tensor(x)
    return torch.multinomial(x.detach(), int(num_samples), replacement,
                             generator=_gen(x.device)).to(torch.int32)
