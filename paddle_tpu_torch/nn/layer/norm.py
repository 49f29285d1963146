"""``LayerNorm``, ``RMSNorm`` and the batch norms of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/norm.py`` (``LayerNorm``, ``:10-35``;
``RMSNorm``, ``:38-64``; ``BatchNorm``, ``BatchNorm1D/2D/3D``, ``:67-126``):
each keeps the reference's own formula, not the fused kernels of
``ops.layer_norm`` (the reference's layers do not call them either).
Weights start at ones and biases at zeros, in f32 on ``device`` (``cuda``
unless ``"cpu"`` is asked for). A batch norm keeps its running statistics
in the buffers ``_mean`` (zeros) and ``_variance`` (ones), f32, as the
reference names them, with no ``num_batches_tracked``; it normalises with
the batch's statistics in training mode and blends them into the buffers
(``F.batch_norm``). ``weight_attr`` / ``bias_attr`` take None or False
(no weight, no bias); other ``ParamAttr``s are not ported.
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


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, *,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None):
        super().__init__()
        for name, attr in (("weight_attr", weight_attr),
                           ("bias_attr", bias_attr)):
            if attr not in (None, False):
                raise NotImplementedError(
                    f"{name}={attr!r}: ParamAttr is not ported yet "
                    "(ROADMAP Queue 1 item 12); pass None or False")
        dev = resolve_device(device)
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, device=dev))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, device=dev))
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, *,
                 data_format="NCL", **kw):
        super().__init__(num_features, momentum, epsilon,
                         data_format=data_format, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, *,
                 data_format="NCDHW", **kw):
        super().__init__(num_features, momentum, epsilon,
                         data_format=data_format, **kw)
