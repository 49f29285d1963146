"""Elementwise, comparison and bitwise ops of the PyTorch port.

Counterpart of ``paddle_tpu/ops/math.py``: the elementwise unary and
binary families are generated from the spec table (``codegen.SPECS``,
group ``math``); the rest are written here with the reference's
signatures and defaults. ``remainder`` is ``mod`` and ``pow_`` ``pow``,
as there. Comparison, logical and bitwise ops carry no gradient.
"""
from __future__ import annotations

import torch

from ._util import as_tensor, call, op, pair
from .codegen import generate as _generate
from .dispatch import OP_REGISTRY

_GENERATED_MATH = _generate(globals(), groups={"math"})

pow_ = globals()["pow"]
remainder = mod  # noqa: F821 - generated above


@op("clip")
def clip(x, min=None, max=None):
    return torch.clamp(x, min, max)


@op("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


@op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def multiplex(inputs, index):
    def _mx(index, *ins):
        stacked = torch.stack(ins, 0)
        idx = index.reshape(-1).long()
        return stacked[idx, torch.arange(stacked.shape[1],
                                         device=stacked.device)]
    return call("multiplex", _mx, index, *inputs)


@op("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


@op("inner")
def inner(x, y):
    return torch.inner(x, y)


@op("outer")
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op("kron")
def kron(x, y):
    return torch.kron(x, y)


@op("trace")
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@op("cumsum")
def cumsum(x, axis=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, int(axis))


@op("cumprod")
def cumprod(x, dim=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, int(dim))


@op("logcumsumexp")
def logcumsumexp(x, axis=None):
    if axis is None:
        return torch.logcumsumexp(x.reshape(-1), 0)
    return torch.logcumsumexp(x, int(axis))


def isfinite(x):
    return call("isfinite", torch.isfinite, x, nondiff=True)


def isinf(x):
    return call("isinf", torch.isinf, x, nondiff=True)


def isnan(x):
    return call("isnan", torch.isnan, x, nondiff=True)


# ---- logical / bitwise / comparison ---------------------------------------

def _nondiff_binop(name, tfn):
    @op(name, nondiff=True)
    def fn(x, y):
        return tfn(x, y)

    def api(x, y):
        return fn(*pair(x, y))
    api.__name__ = api.__qualname__ = name
    api.op_name, api.raw_fn = name, fn.raw_fn
    OP_REGISTRY[name] = api
    return api


logical_and = _nondiff_binop("logical_and", torch.logical_and)
logical_or = _nondiff_binop("logical_or", torch.logical_or)
logical_xor = _nondiff_binop("logical_xor", torch.logical_xor)
bitwise_and = _nondiff_binop("bitwise_and", torch.bitwise_and)
bitwise_or = _nondiff_binop("bitwise_or", torch.bitwise_or)
bitwise_xor = _nondiff_binop("bitwise_xor", torch.bitwise_xor)
left_shift = _nondiff_binop("left_shift", torch.bitwise_left_shift)
right_shift = _nondiff_binop("right_shift", torch.bitwise_right_shift)
equal = _nondiff_binop("equal", torch.eq)
not_equal = _nondiff_binop("not_equal", torch.ne)
greater_than = _nondiff_binop("greater_than", torch.gt)
greater_equal = _nondiff_binop("greater_equal", torch.ge)
less_than = _nondiff_binop("less_than", torch.lt)
less_equal = _nondiff_binop("less_equal", torch.le)


@op("logical_not", nondiff=True)
def logical_not(x):
    return torch.logical_not(x)


@op("bitwise_not", nondiff=True)
def bitwise_not(x):
    return torch.bitwise_not(x)


def equal_all(x, y):
    return call("equal_all", lambda a, b: torch.tensor(
        a.shape == b.shape and bool(torch.equal(a, b)), device=a.device),
        x, y, nondiff=True)


@op("allclose", nondiff=True)
def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.tensor(torch.allclose(x, y, rtol, atol, equal_nan),
                        device=x.device)


@op("isclose", nondiff=True)
def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol, atol, equal_nan)


@op("where")
def _where(condition, x, y):
    return torch.where(condition, x, y)


def where(condition, x, y):
    like = x if isinstance(x, torch.Tensor) else y
    return _where(condition, as_tensor(x, like), as_tensor(y, like))


where.op_name, where.raw_fn = "where", _where.raw_fn
OP_REGISTRY["where"] = where


@op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan, posinf, neginf)


__all__ = _GENERATED_MATH + [
    "pow_", "remainder", "clip", "lerp", "stanh", "scale", "multiplex",
    "addmm", "inner", "outer", "kron", "trace", "diagonal", "cumsum",
    "cumprod", "logcumsumexp", "isfinite", "isinf", "isnan", "logical_and",
    "logical_or", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
    "left_shift", "right_shift", "equal", "not_equal", "greater_than",
    "greater_equal", "less_than", "less_equal", "logical_not",
    "bitwise_not", "equal_all", "allclose", "isclose", "where",
    "nan_to_num"]
