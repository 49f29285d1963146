"""``batch_norm``, ``layer_norm``, ``instance_norm``, ``group_norm``,
``normalize`` and ``local_response_norm`` of the PyTorch port.

``batch_norm`` is the counterpart of ``paddle_tpu/nn/functional/norm.py
:18-90``, the reference's formula operation for operation: batch
statistics in float32 with the biased variance; the running statistics
blended in place as ``momentum * running + (1 - momentum) * batch`` and
cast back to the buffer's dtype (Paddle's ``momentum`` weighs the old
statistic, where torch's weighs the new one, and torch blends the
unbiased variance: so no library batch norm is called); the
normalisation in float32, cast back to x's dtype. Under a process group
of several ranks (the one ``_sync_batch_norm`` sets for a block of code:
``nn.SyncBatchNorm``'s, or a train step's "data" group) the training
statistics are the global batch's, by the same two-pass formula: the f32
sums and counts all-reduced for the mean, then the sums of squared
deviations from it for the biased variance
(``distributed.collective.all_reduce_with_grad``: the statistics stay
differentiable, their gradients summed over the ranks).
Every rank blends the same global statistics, so the running ones stay
equal over the group.

``layer_norm`` is the counterpart of ``paddle_tpu/nn/functional/norm.py
:93-119``: the
reference's own formula, in x's dtype, over the trailing
``normalized_shape`` axes: ``(x - mu) * reciprocal(sqrt(var + eps))``,
then the weight and the bias. It does not call the fused LayerNorm
kernel (``ops.layer_norm.fused_layer_norm``): the reference does not, and
the two round differently in bfloat16 (the kernel normalises in f32).

``instance_norm``, ``group_norm``, ``normalize`` and
``local_response_norm`` are the reference's formulas in x's dtype
(``paddle_tpu/nn/functional/norm.py:122-219``): biased variances,
``(x - mu) * reciprocal(sqrt(var + eps))``. ``instance_norm`` reads
neither running statistics nor ``use_input_stats`` nor ``momentum``, as
in the reference: it always normalises with the instance's own.

Each goes through the op dispatch (``ops.dispatch``) as the reference's
do: ``layer_norm``, and in training the batch statistics ``bn_mean`` and
``bn_var``, then ``batch_norm`` over (x, mean, var, weight, bias).
"""
from __future__ import annotations

import contextlib
import math

import torch

from ...ops.dispatch import apply_op

# the group a batch norm in training takes its statistics over
# (``_sync_batch_norm``)
_SYNC = {"group": None}


@contextlib.contextmanager
def _sync_batch_norm(group):
    """Within the block, every batch norm in training takes its statistics
    over ``group``'s ranks (None: each rank's batch): the statistics of a
    batch split over the group's ranks."""
    prev = _SYNC["group"]
    _SYNC["group"] = group
    try:
        yield
    finally:
        _SYNC["group"] = prev


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Normalise over every axis but the channel axis (1 for ``NC*``
    layouts, the last otherwise). In training (unless
    ``use_global_stats``) with the batch's statistics, blending them into
    ``running_mean`` / ``running_var`` in place when those are given;
    otherwise with the running statistics; the training statistics are
    over the ranks of ``_sync_batch_norm``'s group when one is set."""
    nd = x.dim()
    channel_axis = 1 if data_format.startswith("NC") else nd - 1
    axes = tuple(i for i in range(nd) if i != channel_axis)
    shape = [1] * nd
    shape[channel_axis] = x.shape[channel_axis]
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    group = _SYNC["group"]
    if training and not use_stats and group is not None \
            and group.nranks > 1:
        mean, var = _global_stats(x, axes, shape, group)
    elif training and not use_stats:
        mean = apply_op("bn_mean", _bn_mean, x, axes=axes)
        var = apply_op("bn_var", _bn_var, x, axes=axes)
    if training and not use_stats:
        if running_mean is not None and not getattr(mean, "_symbolic",
                                                    False):
            # a static program's statistics are symbolic: the running
            # ones stay frozen in it (paddle_tpu/nn/functional/norm.py
            # :46-49)
            with torch.no_grad():
                running_mean.copy_((momentum * running_mean
                                    + (1 - momentum) * mean)
                                   .to(running_mean.dtype))
                running_var.copy_((momentum * running_var
                                   + (1 - momentum) * var)
                                  .to(running_var.dtype))
    else:
        mean, var = running_mean, running_var
    return apply_op("batch_norm", _batch_norm, x, mean, var, weight, bias,
                    shape=shape, epsilon=epsilon)


def _bn_mean(x, axes):
    return x.to(torch.float32).mean(axes)


def _bn_var(x, axes):
    xf = x.to(torch.float32)
    return torch.square(xf - xf.mean(axes, keepdim=True)).mean(axes)


def _global_stats(x, axes, shape, group):
    """The f32 mean and biased variance over the batches of ``group``'s
    ranks (each rank's count may differ): ``_bn_mean`` and ``_bn_var`` of
    the global batch, in two passes."""
    from ...distributed.collective import all_reduce_with_grad
    xf = x.to(torch.float32)
    count = xf.new_full((1,), xf.numel() // math.prod(shape))
    sums = all_reduce_with_grad(torch.cat([xf.sum(axes), count]), group)
    n = sums[-1]
    mean = sums[:-1] / n
    dev = torch.square(xf - mean.reshape(shape)).sum(axes)
    return mean, all_reduce_with_grad(dev, group) / n


def _batch_norm(x, mean, var, weight, bias, shape, epsilon):
    inv = torch.reciprocal(torch.sqrt(var.to(torch.float32).reshape(shape)
                                      + epsilon))
    out = (x.to(torch.float32) - mean.to(torch.float32).reshape(shape)) * inv
    if weight is not None:
        out = out * weight.to(torch.float32).reshape(shape)
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(shape)
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return apply_op("layer_norm", _layer_norm, x, weight, bias,
                    n=len(normalized_shape), epsilon=epsilon)


def _layer_norm(x, weight, bias, n, epsilon):
    axes = tuple(range(x.dim() - n, x.dim()))
    mu = x.mean(axes, keepdim=True)
    var = torch.square(x - mu).mean(axes, keepdim=True)
    out = (x - mu) * torch.reciprocal(torch.sqrt(var + epsilon))
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def _instance_norm(x, weight, bias, eps, channel_first):
    nd = x.dim()
    axes = tuple(range(2, nd)) if channel_first else tuple(range(1, nd - 1))
    shape = [1] * nd
    shape[1 if channel_first else nd - 1] = x.shape[1 if channel_first
                                                    else nd - 1]
    mu = x.mean(axes, keepdim=True)
    var = x.var(axes, keepdim=True, correction=0)
    out = (x - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return _affine(out, weight, bias, shape)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """Normalise each (sample, channel) over its spatial axes."""
    return apply_op("instance_norm", _instance_norm, x, weight, bias,
                    eps=eps, channel_first=data_format.startswith("NC"))


def _group_norm(x, weight, bias, num_groups, epsilon, channel_first):
    xm = x if channel_first else torch.movedim(x, -1, 1)
    N, C = xm.shape[0], xm.shape[1]
    g = xm.reshape((N, num_groups, C // num_groups) + tuple(xm.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mu = g.mean(axes, keepdim=True)
    var = g.var(axes, keepdim=True, correction=0)
    g = (g - mu) * torch.reciprocal(torch.sqrt(var + epsilon))
    out = _affine(g.reshape(xm.shape), weight, bias,
                  (1, C) + (1,) * (xm.dim() - 2))
    return out if channel_first else torch.movedim(out, 1, -1)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW"):
    """Normalise each sample's channels in ``num_groups`` groups, each
    over its channels and spatial axes together."""
    return apply_op("group_norm", _group_norm, x, weight, bias,
                    num_groups=num_groups, epsilon=epsilon,
                    channel_first=data_format.startswith("NC"))


def _normalize(x, p, axis, epsilon):
    norm = torch.sum(torch.abs(x) ** p, axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """x / max(||x||_p along ``axis``, epsilon)."""
    return apply_op("normalize", _normalize, x, p=p, axis=axis,
                    epsilon=epsilon)


def _local_response_norm(x, size, alpha, beta, k, data_format):
    ax = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = torch.square(x)
    C, half = x.shape[ax], size // 2
    pads = [0, 0] * x.dim()
    # F.pad's pairs run from the last axis backwards
    pads[2 * (x.dim() - 1 - ax)] = half
    pads[2 * (x.dim() - 1 - ax) + 1] = size - half - 1
    padded = torch.nn.functional.pad(sq, pads)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + padded.narrow(ax, i, C)
    return x / torch.pow(k + alpha * acc, beta)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """x / (k + alpha * (the sum of squares over ``size`` neighbouring
    channels)) ** beta; the sum is not divided by ``size``, as in the
    reference."""
    return apply_op("local_response_norm", _local_response_norm, x,
                    size=size, alpha=alpha, beta=beta, k=k,
                    data_format=data_format)
