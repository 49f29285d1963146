"""The normalisation layers of the PyTorch port.

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
``name`` unused. ``SyncBatchNorm`` (``:128-150``) is a batch norm over a
process group: its training statistics are the global batch's
(``F.batch_norm`` under ``_sync_batch_norm``); outside a group of
several ranks it is ``BatchNorm``, as the reference's.

``InstanceNorm1D/2D/3D``, ``GroupNorm``, ``LocalResponseNorm`` and
``SpectralNorm`` follow ``paddle_tpu/nn/layer/norm.py:154-260``: an
instance norm's ``weight_attr=False`` drops its bias too, and its
``momentum`` is never read; ``SpectralNorm`` divides the weight it is
called on by sigma from ``power_iters`` power iterations that start, at
every call, from its ``weight_u`` / ``weight_v`` buffers (N(0, 1) from
``generator``), which it never updates, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.place import resolve_device
from ...ops.dispatch import apply_op
from .. import functional as F
from .. import initializer as init
from .layers import Layer, create_parameter

_ONE = init.Constant(1.0)


class LayerNorm(Layer):
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


class RMSNorm(Layer):
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


class _BatchNormBase(Layer):
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


class SyncBatchNorm(_BatchNormBase):
    """A batch norm whose training statistics are the global batch's over
    the default group of every rank (``paddle.nn.SyncBatchNorm``), or
    over the group a train step has set for its batch norms (a mesh's
    "data"). Each rank normalises its own batch with the global mean
    and biased variance, blends them into its running statistics (equal
    on every rank) and takes gradients through them. Outside a group of
    several ranks (no process group, or a world of one) it is
    ``BatchNorm``, as the reference's
    (``paddle_tpu/nn/layer/norm.py:128-150``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)

    def forward(self, x):
        from ...distributed import collective
        from ..functional.norm import _SYNC, _sync_batch_norm
        group = _SYNC["group"]
        if group is None and collective.is_initialized():
            group = collective._default_group()
        with _sync_batch_norm(group):
            return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it (itself included) replaced
        by a ``SyncBatchNorm`` holding copies of its weight, bias and
        running statistics, in their dtypes, and its mode; a
        ``SyncBatchNorm`` is kept."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer.data_format,
                      use_global_stats=layer.use_global_stats,
                      device=layer._mean.device)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    old = getattr(layer, name)
                    if old is not None:
                        setattr(new, name, torch.nn.Parameter(
                            old.detach().clone(),
                            requires_grad=old.requires_grad))
                for name in ("_mean", "_variance"):
                    new.register_buffer(name,
                                        getattr(layer, name).detach().clone())
            return new.train(layer.training)
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None):
        super().__init__()
        self.epsilon, self.data_format = epsilon, data_format
        self.weight = self.bias = None
        if weight_attr is not False:
            self.weight = create_parameter((num_features,), weight_attr,
                                           default_initializer=_ONE,
                                           device=device)
            self.bias = create_parameter((num_features,), bias_attr,
                                         is_bias=True, device=device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon,
                               data_format=self.data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else create_parameter(
            (num_channels,), weight_attr, default_initializer=_ONE,
            device=device)
        self.bias = None if bias_attr is False else create_parameter(
            (num_channels,), bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


def _spectral_norm(w, u, v, dim, iters, eps):
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(iters):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return w / (u @ wm @ v)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        normal = init.Normal(0.0, 1.0)
        kw = {"device": device, "generator": generator}
        self.register_buffer("weight_u", normal((h,), **kw))
        self.register_buffer("weight_v", normal((w,), **kw))

    def forward(self, weight):
        return apply_op("spectral_norm", _spectral_norm, weight,
                        u=self.weight_u, v=self.weight_v, dim=self.dim,
                        iters=self.power_iters, eps=self.eps)
