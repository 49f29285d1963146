"""``Linear``, ``Embedding``, ``Dropout`` and ``Flatten`` of the PyTorch
port.

Counterpart of ``paddle_tpu/nn/layer/common.py`` (``Linear``, ``:23-43``;
``Embedding``, ``:46-69``; ``Dropout``, ``:72``; ``Flatten``, ``:118``).
Parameters are made by ``create_parameter`` with the reference's
``weight_attr`` / ``bias_attr`` (``ParamAttr``s, or ``bias_attr=False``
for no bias) in the reference's positions, in f32 on ``device`` (``cuda``
unless ``"cpu"`` is asked for) from ``generator`` (the default generator
when None); ``device`` and ``generator`` are keyword-only. ``Linear``
keeps its weight (in, out), XavierNormal by default (N(0, 2 / (in +
out))), its bias zero. ``Embedding`` keeps its weight (num, dim), N(0, 1)
when no ``weight_attr`` is given and, as in the reference, XavierNormal
when one without an initializer is; its ``padding_idx`` row is zeroed,
and it looks rows up through ``F.embedding`` (``sparse=True``: a sparse
gradient). ``name`` is accepted and unused. Cast a module with
``.to(dtype)``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.manipulation import flatten
from .. import functional as F
from .. import initializer as init
from .layers import create_parameter


class Linear(nn.Module):
    """y = x @ weight (+ bias); weight (in_features, out_features)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.in_features, self.out_features = in_features, out_features
        self.weight = create_parameter((in_features, out_features),
                                       weight_attr, **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """Rows of ``weight`` (num_embeddings, embedding_dim) at integer
    ids."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = (num_embeddings,
                                                   embedding_dim)
        self.padding_idx, self.sparse = padding_idx, sparse
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=init.Normal(0.0, 1.0)
            if weight_attr is None else None, device=device,
            generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx, self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """``F.dropout`` with the layer's ``p``, ``axis`` and ``mode``, in
    training mode when the module is."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", *,
                 generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(nn.Module):
    """``ops.flatten`` of the axes ``start_axis`` .. ``stop_axis``."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)
