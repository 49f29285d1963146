"""Pooling of the PyTorch port: ``max_pool1d/2d/3d``, ``avg_pool1d/2d/3d``
and ``adaptive_avg_pool1d/2d/3d``.

Counterpart of ``paddle_tpu/nn/functional/pooling.py`` (``_pool_nd`` :21,
``_adaptive_pool`` :235), which lowers to ``lax.reduce_window`` and jnp
means. No TPU kernel lies under it; here the windows are torch's pooling
calls on channel-first tensors. The stride defaults to the kernel size;
padding is an int, n ints, or ``"SAME"`` / ``"VALID"`` (pads as ``lax``
computes them). Max pooling pads with -inf, average pooling with zeros
and, when ``exclusive`` and some pad is nonzero (or ``"SAME"``), divides
each window's sum by its count of unpadded elements, else by the kernel's
size. Pads that torch's pooling cannot take (asymmetric, or over half the
kernel) are applied with ``F.pad`` first. Adaptive average pooling walks
the spatial axes one by one, as the reference does: a mean over the axis
for an output of 1, a reshaped mean where the output divides the input,
else the reference's bins (start floor(i * in / out), end ceil((i + 1) *
in / out)).

Refused: ``ceil_mode=True`` (the reference accepts it and ignores it:
ROADMAP Queue 3) and ``return_mask=True`` (the reference's functional form
returns the argmax indices: not ported yet, ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .conv import CHANNEL_LAST, _tuplize, pad_spatial, same_pads


def _refuse(ceil_mode, return_mask=False):
    if ceil_mode:
        raise NotImplementedError(
            "ceil_mode=True: the reference accepts it and computes the "
            "floor-mode output (ROADMAP Queue 3, faults of the reference); "
            "the port refuses it rather than compute either function")
    if return_mask:
        raise NotImplementedError(
            "return_mask=True (the argmax indices) is not ported yet: "
            "ROADMAP Queue 1 item 12")


def _pool_nd(x, kind, kernel_size, stride, padding, n, data_format,
             exclusive=True):
    channel_last = data_format in CHANNEL_LAST
    if channel_last:
        x = torch.movedim(x, -1, 1)
    ks = _tuplize(kernel_size, n)
    st = _tuplize(stride if stride is not None else kernel_size, n)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"bad padding {padding}")
        pads = (same_pads(x.shape[2:], ks, st) if mode == "SAME"
                else [(0, 0)] * n)
    else:
        mode = None
        pads = [(p, p) for p in _tuplize(padding, n)]
        if len(pads) != n:
            raise ValueError(f"bad padding {padding}")
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks))
    sym = [lo for lo, _ in pads] if native else [0] * n
    if kind == "max":
        if not native:
            x = pad_spatial(x, pads, value=-math.inf)
        out = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[n - 1](
            x, ks, st, sym)
    else:
        divide_by_count = exclusive and (
            mode == "SAME" or any(p != (0, 0) for p in pads))
        if native:
            out = _avg(x, ks, st, sym, count_pads=not divide_by_count)
        else:
            s = _avg(pad_spatial(x, pads), ks, st, sym, divisor=1)
            if divide_by_count:
                cnt = _avg(pad_spatial(torch.ones_like(x), pads), ks, st,
                           sym, divisor=1)
                out = s / cnt
            else:
                out = s / float(np.prod(ks))
    return torch.movedim(out, 1, -1) if channel_last else out


def _avg(x, ks, st, pads, count_pads=True, divisor=None):
    """torch's average pool over the trailing len(ks) axes of a
    channel-first ``x``, or with ``divisor=1`` the windows' sums (a 1-d
    pool runs as a 2-d one of height 1)."""
    if len(ks) == 1:
        return _avg(x[..., None, :], (1, ks[0]), (1, st[0]), (0, pads[0]),
                    count_pads, divisor)[..., 0, :]
    pool = F.avg_pool2d if len(ks) == 2 else F.avg_pool3d
    return pool(x, ks, st, pads, count_include_pad=count_pads,
                divisor_override=divisor)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCL"):
    _refuse(ceil_mode, return_mask)
    return _pool_nd(x, "max", kernel_size, stride, padding, 1, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    _refuse(ceil_mode, return_mask)
    return _pool_nd(x, "max", kernel_size, stride, padding, 2, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    _refuse(ceil_mode, return_mask)
    return _pool_nd(x, "max", kernel_size, stride, padding, 3, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    _refuse(ceil_mode)
    return _pool_nd(x, "avg", kernel_size, stride, padding, 1, data_format,
                    exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCHW"):
    _refuse(ceil_mode)
    _refuse_divisor(divisor_override)
    return _pool_nd(x, "avg", kernel_size, stride, padding, 2, data_format,
                    exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCDHW"):
    _refuse(ceil_mode)
    _refuse_divisor(divisor_override)
    return _pool_nd(x, "avg", kernel_size, stride, padding, 3, data_format,
                    exclusive)


def _refuse_divisor(divisor_override):
    if divisor_override is not None:
        raise NotImplementedError(
            "divisor_override: the reference accepts it and ignores it "
            "(ROADMAP Queue 3, faults of the reference); the port refuses "
            "it rather than compute either function")


def _adaptive_avg(x, output_size, n, data_format):
    channel_last = data_format in CHANNEL_LAST
    out_sz = _tuplize(output_size, n)
    spatial_axes = (range(1, n + 1) if channel_last else range(2, n + 2))
    out = x
    for ax, osz in zip(spatial_axes, out_sz):
        isz = out.shape[ax]
        if osz == 1:
            out = out.mean(ax, keepdim=True)
        elif isz % osz == 0:
            shape = out.shape[:ax] + (osz, isz // osz) + out.shape[ax + 1:]
            out = out.reshape(shape).mean(ax + 1)
        else:
            starts = (np.arange(osz) * isz) // osz
            ends = ((np.arange(osz) + 1) * isz + osz - 1) // osz
            out = torch.cat([out.narrow(ax, int(s), int(e - s))
                             .mean(ax, keepdim=True)
                             for s, e in zip(starts, ends)], ax)
    return out


def adaptive_avg_pool1d(x, output_size, data_format="NCL"):
    return _adaptive_avg(x, output_size, 1, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_avg(x, output_size, 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_avg(x, output_size, 3, data_format)
