"""Pooling of the PyTorch port: ``max_pool1d/2d/3d``, ``avg_pool1d/2d/3d``,
``adaptive_avg_pool1d/2d/3d``, ``adaptive_max_pool1d/2d/3d`` and
``max_unpool1d/2d/3d``.

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

``return_mask=True`` makes a max pool return (out, mask) as the
reference's (``pooling.py:63``, ``:112-134``): per window, the int32 flat
index into the input's spatial map (row-major) of the window's first
largest element, found over the input padded with the dtype's lowest
value and every real element raised to at least half of it, so a pad
never wins, even in a window of -inf. Each function goes through the op
dispatch (``ops.dispatch``) under its reference name.

Refused: ``ceil_mode=True`` and the adaptive max pools' ``return_mask=True``
(the reference accepts each and ignores it: ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.dispatch import apply_op
from .conv import CHANNEL_LAST, _tuplize, pad_spatial, same_pads


def _refuse(ceil_mode):
    if ceil_mode:
        raise NotImplementedError(
            "ceil_mode=True: the reference accepts it and computes the "
            "floor-mode output (ROADMAP Queue 3, faults of the reference); "
            "the port refuses it rather than compute either function")


def _pads(x, kernel_size, stride, padding, n):
    """(kernel, strides, (low, high) pads, "SAME" / "VALID" / None) of a
    channel-first ``x``."""
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
    return ks, st, pads, mode


def _pool_nd(x, kind, kernel_size, stride, padding, n, data_format,
             exclusive=True):
    channel_last = data_format in CHANNEL_LAST
    if channel_last:
        x = torch.movedim(x, -1, 1)
    ks, st, pads, mode = _pads(x, kernel_size, stride, padding, n)
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


def _max_pool_indices(x, ks, st, pads):
    """The reference's mask of a channel-first ``x``: per window, the
    int32 flat index into x's spatial map of its first largest element."""
    n = len(ks)
    info = (torch.finfo if x.is_floating_point() else torch.iinfo)(x.dtype)
    low = info.min
    xv = torch.clamp_min(x, low / 2 if x.is_floating_point() else low + 1)
    win = pad_spatial(xv, pads, value=low)
    for d in range(n):
        win = win.unfold(2 + d, ks[d], st[d])
    out_spatial = win.shape[2:2 + n]
    rem = win.reshape(*win.shape[:2 + n], -1).argmax(-1)
    offs = [None] * n
    for d in range(n - 1, -1, -1):
        offs[d] = rem % ks[d]
        rem = rem // ks[d]
    spatial = x.shape[2:]
    lin = None
    for d in range(n):
        shape = [1] * (2 + n)
        shape[2 + d] = out_spatial[d]
        start = (torch.arange(out_spatial[d], device=x.device) * st[d]
                 - pads[d][0]).reshape(shape)
        coord = torch.clamp(start + offs[d], 0, spatial[d] - 1)
        lin = coord if lin is None else lin * spatial[d] + coord
    return lin.to(torch.int32)


def _max_pool(x, kernel_size, stride, padding, n, data_format, return_mask):
    out = _pool_nd(x, "max", kernel_size, stride, padding, n, data_format)
    if not return_mask:
        return out
    channel_last = data_format in CHANNEL_LAST
    v = torch.movedim(x, -1, 1) if channel_last else x
    ks, st, pads, _ = _pads(v, kernel_size, stride, padding, n)
    idx = _max_pool_indices(v, ks, st, pads)
    return out, torch.movedim(idx, 1, -1) if channel_last else idx


def _max_op(name, x, kernel_size, stride, padding, n, data_format,
            ceil_mode, return_mask):
    _refuse(ceil_mode)
    return apply_op(name, _max_pool, x, kernel_size=kernel_size,
                    stride=stride, padding=padding, n=n,
                    data_format=data_format, return_mask=return_mask)


def _avg_op(name, x, kernel_size, stride, padding, n, data_format,
            exclusive, ceil_mode):
    _refuse(ceil_mode)
    return apply_op(name, _pool_nd, x, kind="avg", kernel_size=kernel_size,
                    stride=stride, padding=padding, n=n,
                    data_format=data_format, exclusive=exclusive)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCL"):
    return _max_op("max_pool1d", x, kernel_size, stride, padding, 1,
                data_format, ceil_mode, return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    return _max_op("max_pool2d", x, kernel_size, stride, padding, 2,
                data_format, ceil_mode, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    return _max_op("max_pool3d", x, kernel_size, stride, padding, 3,
                data_format, ceil_mode, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _avg_op("avg_pool1d", x, kernel_size, stride, padding, 1,
                data_format, exclusive, ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCHW"):
    _refuse_divisor(divisor_override)
    return _avg_op("avg_pool2d", x, kernel_size, stride, padding, 2,
                data_format, exclusive, ceil_mode)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCDHW"):
    _refuse_divisor(divisor_override)
    return _avg_op("avg_pool3d", x, kernel_size, stride, padding, 3,
                data_format, exclusive, ceil_mode)


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
    return apply_op("adaptive_avg_pool1d", _adaptive_avg, x,
                    output_size=output_size, n=1, data_format=data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return apply_op("adaptive_avg_pool2d", _adaptive_avg, x,
                    output_size=output_size, n=2, data_format=data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return apply_op("adaptive_avg_pool3d", _adaptive_avg, x,
                    output_size=output_size, n=3, data_format=data_format)


def _adaptive_max(x, output_size, n, data_format):
    channel_last = data_format in CHANNEL_LAST
    out_sz = _tuplize(output_size, n)
    spatial_axes = (range(1, n + 1) if channel_last else range(2, n + 2))
    out = x
    for ax, osz in zip(spatial_axes, out_sz):
        isz = out.shape[ax]
        if osz == 1:
            out = out.amax(ax, keepdim=True)
        elif isz % osz == 0:
            shape = out.shape[:ax] + (osz, isz // osz) + out.shape[ax + 1:]
            out = out.reshape(shape).amax(ax + 1)
        else:
            starts = (np.arange(osz) * isz) // osz
            ends = ((np.arange(osz) + 1) * isz + osz - 1) // osz
            out = torch.cat([out.narrow(ax, int(s), int(e - s))
                             .amax(ax, keepdim=True)
                             for s, e in zip(starts, ends)], ax)
    return out


def _adaptive_max_op(name, x, output_size, n, return_mask, data_format):
    if return_mask:
        raise NotImplementedError(
            "return_mask=True: the reference's adaptive max pools accept it "
            "and return no mask (ROADMAP Queue 3, faults of the "
            "reference); the port refuses it")
    return apply_op(name, _adaptive_max, x, output_size=output_size, n=n,
                    data_format=data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, data_format="NCL"):
    """The largest element of each of the reference's bins (those of
    ``adaptive_avg_pool1d``), axis by axis."""
    return _adaptive_max_op("adaptive_max_pool1d", x, output_size, 1,
                            return_mask, data_format)


def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW"):
    return _adaptive_max_op("adaptive_max_pool2d", x, output_size, 2,
                            return_mask, data_format)


def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW"):
    return _adaptive_max_op("adaptive_max_pool3d", x, output_size, 3,
                            return_mask, data_format)


def _max_unpool(x, indices, kernel_size, stride, padding, output_size, n,
                data_format):
    """Each pooled value written at its flat index into the output's
    spatial map (``paddle_tpu/nn/functional/pooling.py:153-186``): the
    output is (in - 1) * stride - 2 * padding + kernel per axis unless
    ``output_size`` (its last n entries) says otherwise; zeros elsewhere;
    an index outside the output is dropped."""
    channel_last = data_format in CHANNEL_LAST
    v = torch.movedim(x, -1, 1) if channel_last else x
    idx = torch.movedim(indices, -1, 1) if channel_last else indices
    ks = _tuplize(kernel_size, n)
    st = _tuplize(stride if stride is not None else kernel_size, n)
    p = _tuplize(padding, n)
    if output_size is None:
        out_spatial = tuple((v.shape[2 + i] - 1) * st[i] - 2 * p[i] + ks[i]
                            for i in range(n))
    else:
        out_spatial = tuple(int(s) for s in output_size[-n:])
    N, C, L = v.shape[0], v.shape[1], int(np.prod(out_spatial))
    # an index past the output lands in a spare slot, dropped after: the
    # reference's scatter drops it
    flat = idx.reshape(N, C, -1).long()
    flat = torch.where((flat >= 0) & (flat < L), flat, L)
    out = torch.zeros((N, C, L + 1), dtype=v.dtype, device=v.device)
    out = out.scatter(2, flat, v.reshape(N, C, -1))[:, :, :L]
    out = out.reshape((N, C) + out_spatial)
    return torch.movedim(out, 1, -1) if channel_last else out


def _unpool_op(name, x, indices, kernel_size, stride, padding, data_format,
               output_size, n):
    return apply_op(name, _max_unpool, x, indices, kernel_size=kernel_size,
                    stride=stride, padding=padding, output_size=output_size,
                    n=n, data_format=data_format)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    """The inverse of ``max_pool1d(return_mask=True)``: ``indices`` are
    its mask."""
    return _unpool_op("max_unpool1d", x, indices, kernel_size, stride,
                      padding, data_format, output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool_op("max_unpool2d", x, indices, kernel_size, stride,
                      padding, data_format, output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool_op("max_unpool3d", x, indices, kernel_size, stride,
                      padding, data_format, output_size, 3)
