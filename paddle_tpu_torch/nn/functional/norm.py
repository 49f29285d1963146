"""``batch_norm`` and ``layer_norm`` of the PyTorch port.

``batch_norm`` is the counterpart of ``paddle_tpu/nn/functional/norm.py
:18-90``, the reference's formula operation for operation: batch
statistics in float32 with the biased variance; the running statistics
blended in place as ``momentum * running + (1 - momentum) * batch`` and
cast back to the buffer's dtype (Paddle's ``momentum`` weighs the old
statistic, where torch's weighs the new one, and torch blends the
unbiased variance: so no library batch norm is called); the
normalisation in float32, cast back to x's dtype.

``layer_norm`` is the counterpart of ``paddle_tpu/nn/functional/norm.py
:93-119``: the
reference's own formula, in x's dtype, over the trailing
``normalized_shape`` axes: ``(x - mu) * reciprocal(sqrt(var + eps))``,
then the weight and the bias. It does not call the fused LayerNorm
kernel (``ops.layer_norm.fused_layer_norm``): the reference does not, and
the two round differently in bfloat16 (the kernel normalises in f32).
"""
from __future__ import annotations

import torch


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Normalise over every axis but the channel axis (1 for ``NC*``
    layouts, the last otherwise). In training (unless
    ``use_global_stats``) with the batch's statistics, blending them into
    ``running_mean`` / ``running_var`` in place when those are given;
    otherwise with the running statistics."""
    nd = x.dim()
    channel_axis = 1 if data_format.startswith("NC") else nd - 1
    axes = tuple(i for i in range(nd) if i != channel_axis)
    shape = [1] * nd
    shape[channel_axis] = x.shape[channel_axis]
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    xf = x.to(torch.float32)
    if training and not use_stats:
        mean = xf.mean(axes)
        centred = xf - mean.reshape(shape)
        var = torch.square(centred).mean(axes)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.copy_((momentum * running_mean
                                    + (1 - momentum) * mean)
                                   .to(running_mean.dtype))
                running_var.copy_((momentum * running_var
                                   + (1 - momentum) * var)
                                  .to(running_var.dtype))
    else:
        var = running_var
        centred = xf - running_mean.to(torch.float32).reshape(shape)
    inv = torch.reciprocal(torch.sqrt(var.to(torch.float32).reshape(shape)
                                      + epsilon))
    out = centred * inv
    if weight is not None:
        out = out * weight.to(torch.float32).reshape(shape)
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(shape)
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    mu = x.mean(axes, keepdim=True)
    var = torch.square(x - mu).mean(axes, keepdim=True)
    out = (x - mu) * torch.reciprocal(torch.sqrt(var + epsilon))
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
