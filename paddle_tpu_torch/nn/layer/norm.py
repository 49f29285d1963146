"""``LayerNorm`` and ``RMSNorm`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/norm.py`` (``LayerNorm``, ``:10-35``;
``RMSNorm``, ``:38-64``): each keeps the reference's own formula, not the
fused kernels of ``ops.layer_norm`` (the reference's layers do not call
them either). Weights start at ones and biases at zeros, in f32 on
``device`` (``cuda`` unless ``"cpu"`` is asked for).
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.place import resolve_device
from .. import functional as F


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        dev = resolve_device(device)
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=dev))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=dev))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(nn.Module):
    """x * reciprocal(sqrt(mean(x^2) + eps)) in f32, rounded to x's dtype,
    then times the weight (the reference rounds before the weight
    multiply; the fused kernel after it)."""

    def __init__(self, normalized_shape, epsilon=1e-6, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        dev = resolve_device(device)
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=dev))

    def forward(self, x):
        xf = x.to(torch.float32)
        var = torch.square(xf).mean(-1, keepdim=True)
        out = xf * torch.reciprocal(torch.sqrt(var + self.epsilon))
        return out.to(x.dtype) * self.weight
