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
(``F.batch_norm``). Parameters are made by ``create_parameter`` with the
reference's ``weight_attr`` / ``bias_attr`` in the reference's positions
(a ``ParamAttr``, or False for none); ``device`` is keyword-only and
``name`` unused.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.place import resolve_device
from ...ops.dispatch import apply_op
from .. import functional as F
from .. import initializer as init
from .layers import create_parameter

_ONE = init.Constant(1.0)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else create_parameter(
            self.normalized_shape, weight_attr, default_initializer=_ONE,
            device=device)
        self.bias = None if bias_attr is False else create_parameter(
            self.normalized_shape, bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(nn.Module):
    """x * reciprocal(sqrt(mean(x^2) + eps)) in f32, rounded to x's dtype,
    then times the weight (the reference rounds before the weight
    multiply; the fused kernel after it)."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = create_parameter(self.normalized_shape, weight_attr,
                                       default_initializer=_ONE,
                                       device=device)

    def forward(self, x):
        return apply_op("rms_norm", _rms_norm, x, self.weight,
                        epsilon=self.epsilon)


def _rms_norm(x, weight, epsilon):
    xf = x.to(torch.float32)
    var = torch.square(xf).mean(-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + epsilon))
    return out.to(x.dtype) * weight


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else create_parameter(
            (num_features,), weight_attr, default_initializer=_ONE,
            device=dev)
        self.bias = None if bias_attr is False else create_parameter(
            (num_features,), bias_attr, is_bias=True, device=dev)
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
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)
