"""Reduction ops of the PyTorch port.

Counterpart of ``paddle_tpu/ops/reduction.py``: ``axis`` is None (every
axis), an int or a list, ``keepdim`` keeps the reduced axes as 1, and the
dtypes are ``jnp``'s: an integer sum or product stays int32, a mean of
integers is float32, ``argmax`` / ``argmin`` / ``count_nonzero`` are
int32. ``median`` is the mean of the two middle values of an even count
(``jnp.median``); ``mode`` is the reference's: the middle element of the
sorted axis, not the most frequent value (ROADMAP Queue 3), and
``kthvalue`` returns the values only.
"""
from __future__ import annotations

import torch

from ._util import call, dims, op

__all__ = ["sum", "mean", "prod", "max", "min", "amax", "amin", "any",
           "all", "nansum", "nanmean", "median", "nanmedian", "std", "var",
           "logsumexp", "argmax", "argmin", "count_nonzero", "quantile",
           "kthvalue", "mode"]


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _reduce(name, fn, nondiff=False, floats=False):
    @op(name, nondiff=nondiff)
    def red(x, axis=None, keepdim=False):
        if floats:
            x = _float(x)
        return fn(x, dims(axis, x.dim()), keepdim)
    red.__name__ = red.__qualname__ = name
    return red


def _prod(x, d, keep):
    for a in sorted((a % x.dim() for a in d), reverse=True):
        x = torch.prod(x, a, keep)
    return x


def _flat_last(x, d):
    """x with the axes ``d`` moved to the end and merged into one."""
    d = sorted(a % x.dim() for a in d)
    rest = [a for a in range(x.dim()) if a not in d]
    x = x.permute(rest + d)
    return x.reshape(*x.shape[:len(rest)], -1)


def _keep(out, x, d):
    """``out`` (the reduction of ``x`` over ``d``) with those axes kept as
    1."""
    shape = [1 if i in {a % x.dim() for a in d} else n
             for i, n in enumerate(x.shape)]
    return out.reshape(shape)


def _quantile_fn(tq):
    def fn(x, d, keep):
        out = tq(_flat_last(x, d), 0.5, dim=-1)
        return _keep(out, x, d) if keep else out
    return fn


sum = _reduce("sum", torch.sum)  # noqa: A001
mean = _reduce("mean", torch.mean, floats=True)
prod = _reduce("prod", _prod)
max = _reduce("max", torch.amax)  # noqa: A001
min = _reduce("min", torch.amin)  # noqa: A001
amax = _reduce("amax", torch.amax)
amin = _reduce("amin", torch.amin)
any = _reduce("any", torch.any, nondiff=True)  # noqa: A001
all = _reduce("all", torch.all, nondiff=True)  # noqa: A001
nansum = _reduce("nansum", torch.nansum)
nanmean = _reduce("nanmean", torch.nanmean, floats=True)
median = _reduce("median", _quantile_fn(torch.quantile), floats=True)
nanmedian = _reduce("nanmedian", _quantile_fn(torch.nanquantile),
                    floats=True)


@op("std")
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(_float(x), dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op("var")
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(_float(x), dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op("logsumexp")
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(_float(x), dims(axis, x.dim()), keepdim)


def _arg(fn):
    def arg(x, axis=None, keepdim=False, dtype="int64"):
        if axis is None:
            out = fn(x.reshape(-1))
            return out.reshape([1] * x.dim()) if keepdim else out
        return fn(x, int(axis), keepdim)
    return arg


argmax = op("argmax", nondiff=True)(_arg(torch.argmax))
argmin = op("argmin", nondiff=True)(_arg(torch.argmin))


@op("count_nonzero", nondiff=True)
def count_nonzero(x, axis=None, keepdim=False):
    d = dims(axis, x.dim())
    out = torch.count_nonzero(x, d)
    return _keep(out, x, d) if keepdim else out


def quantile(x, q, axis=None, keepdim=False):
    def fn(a):
        a = _float(a)
        qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
        d = dims(axis, a.dim())
        out = torch.quantile(_flat_last(a, d), qt, dim=-1)
        if keepdim:
            out = out.reshape(*qt.shape, *[1 if i in {b % a.dim() for b in d}
                                           else n for i, n in
                                           enumerate(a.shape)])
        return out
    return call("quantile", fn, x)


@op("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False):
    return torch.kthvalue(x, int(k), int(axis), keepdim).values


@op("mode")
def mode(x, axis=-1, keepdim=False):
    srt = torch.sort(x, int(axis)).values
    val = srt.select(int(axis), srt.shape[axis] // 2)
    return val.unsqueeze(int(axis)) if keepdim else val

