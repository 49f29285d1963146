"""``Linear``, ``Embedding``, ``Dropout`` and ``Flatten`` of the PyTorch
port.

Counterpart of ``paddle_tpu/nn/layer/common.py`` (``Linear``, ``:23-43``;
``Embedding``, ``:46-69``; ``Dropout``, ``:72``; ``Flatten``, ``:118``).
``Linear`` keeps its weight (in, out), drawn XavierNormal (N(0, 2 / (in
+ out))) and its bias zero, as the reference's
``create_parameter`` defaults (``nn/layer/layers.py:123-139``), in f32 on
``device`` (``cuda`` unless ``"cpu"`` is asked for) from ``generator``
(the default generator when None); cast a module with ``.to(dtype)``.
``weight_attr`` / ``name`` are not ported; ``bias_attr=False`` drops the
bias, as in the reference. ``Embedding`` keeps its weight (num, dim)
drawn N(0, 1) in f32 from ``generator``, its ``padding_idx`` row zeroed,
and looks rows up through ``F.embedding``; ``sparse=True`` is refused
there.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.generator import torch_generator
from ...core.place import resolve_device
from ...ops.manipulation import flatten
from .. import functional as F


class Linear(nn.Module):
    """y = x @ weight (+ bias); weight (in_features, out_features)."""

    def __init__(self, in_features, out_features, *, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        std = math.sqrt(2.0 / (in_features + out_features))
        weight = torch.empty((in_features, out_features), device=dev)
        weight.normal_(0.0, std, generator=torch_generator(generator, dev))
        self.weight = nn.Parameter(weight)
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features, device=dev))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """Rows of ``weight`` (num_embeddings, embedding_dim) at integer
    ids."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_embeddings, self.embedding_dim = (num_embeddings,
                                                   embedding_dim)
        self.padding_idx, self.sparse = padding_idx, sparse
        weight = torch.empty((num_embeddings, embedding_dim), device=dev)
        weight.normal_(0.0, 1.0, generator=torch_generator(generator, dev))
        if padding_idx is not None:
            weight[padding_idx] = 0.0
        self.weight = nn.Parameter(weight)

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
