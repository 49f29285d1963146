"""``layer_norm`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/norm.py:93-119``: the
reference's own formula, in x's dtype, over the trailing
``normalized_shape`` axes: ``(x - mu) * reciprocal(sqrt(var + eps))``,
then the weight and the bias. It does not call the fused LayerNorm
kernel (``ops.layer_norm.fused_layer_norm``): the reference does not, and
the two round differently in bfloat16 (the kernel normalises in f32).
"""
from __future__ import annotations

import torch


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
