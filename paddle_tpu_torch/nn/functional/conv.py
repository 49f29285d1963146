"""``conv1d``, ``conv2d`` and ``conv3d`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/conv.py:17-99`` (``_norm_padding``,
``_conv_nd``, ``conv1d/2d/3d``), which lowers to
``lax.conv_general_dilated``; here the convolution is
``torch.nn.functional.conv{n}d`` (cuDNN on the card). No TPU kernel lies
under it. The weight is (out, in / groups, *kernel), as in the reference.
Padding takes every form the reference's ``_norm_padding`` takes: an int,
n ints (symmetric), 2n ints (low, high per axis), n + 2 pairs (the
reference keeps the last n, whatever the layout; at n = 2 it reads four
pairs as 2n ints and raises, where the port takes them: ROADMAP Queue 3),
and ``"SAME"`` /
``"VALID"``, whose pads are computed as ``lax`` computes them (the low side
takes half the total, rounded down). Pads that torch's convolution cannot
take (asymmetric ones) are applied with ``F.pad`` first. Channel-last
layouts (``NLC``, ``NHWC``, ``NDHWC``) are moved to channel-first around
the convolution. The bias is added after the convolution, as in the
reference. Transposed convolutions are not ported yet (ROADMAP Queue 1
item 16). Each goes through the op dispatch (``ops.dispatch``) as
``conv1d`` / ``conv2d`` / ``conv3d``.
"""
from __future__ import annotations

import numbers

import torch
import torch.nn.functional as F

from ...ops.dispatch import apply_op

CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")


def _tuplize(v, n):
    if isinstance(v, numbers.Integral):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _norm_padding(padding, n):
    """The reference's forms -> ``"SAME"`` / ``"VALID"`` or n (low, high)
    pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, numbers.Integral):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, numbers.Integral)
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, numbers.Integral)
                                     for p in padding):
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if len(padding) == n + 2:
        return [tuple(int(x) for x in p) for p in padding[2:]]
    raise ValueError(f"bad padding {padding}")


def same_pads(sizes, window, strides, dilations=None):
    """``lax.padtype_to_pads(..., "SAME")``: per axis, the output is
    ceil(in / stride) and the total pad max((out - 1) * stride + (k - 1) *
    dilation + 1 - in, 0), of which the low side takes total // 2."""
    dilations = dilations or (1,) * len(sizes)
    pads = []
    for size, k, s, d in zip(sizes, window, strides, dilations):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_spatial(x, pads, value=0.0):
    """Pad the trailing len(pads) axes of a channel-first ``x`` by (low,
    high) pairs."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format):
    channel_last = data_format in CHANNEL_LAST
    if channel_last:
        x = torch.movedim(x, -1, 1)
    strides, dils = _tuplize(stride, n), _tuplize(dilation, n)
    pads = _norm_padding(padding, n)
    if pads == "SAME":
        pads = same_pads(x.shape[2:], weight.shape[2:], strides, dils)
    elif pads == "VALID":
        pads = [(0, 0)] * n
    elif not isinstance(pads, list):
        raise ValueError(f"bad padding {padding}")
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x, sym = pad_spatial(x, pads), [0] * n
    conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    out = conv(x, weight, None, strides, sym, dils, int(groups))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return torch.movedim(out, 1, -1) if channel_last else out


def _conv(name, x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    return apply_op(name, _conv_nd, x, weight, bias, stride=stride,
                    padding=padding, dilation=dilation, groups=groups, n=n,
                    data_format=data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    fmt = "NLC" if data_format == "NLC" else "NCL"
    return _conv("conv1d", x, weight, bias, stride, padding, dilation,
                 groups, 1, fmt)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv("conv2d", x, weight, bias, stride, padding, dilation,
                 groups, 2, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv("conv3d", x, weight, bias, stride, padding, dilation,
                 groups, 3, data_format)
