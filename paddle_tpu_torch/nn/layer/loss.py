"""Loss layers of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/loss.py``: the 15 layers, each
calling its function of ``nn.functional.loss`` with the arguments it was
made with. ``HSigmoidLoss`` holds its tree's inner nodes, weight
(num_classes - 1 (num_classes when ``is_custom``), feature_size) uniform
within ±sqrt(6 / (feature_size + nodes)) and bias zero, in f32 on
``device`` (``cuda`` unless ``"cpu"`` is asked for) from ``generator``;
as in the reference it reads neither ``weight_attr`` nor ``is_sparse``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.generator import torch_generator
from ...core.place import resolve_device
from .. import functional as F
from .layers import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.kw = dict(ignore_index=ignore_index, reduction=reduction,
                       soft_label=soft_label, axis=axis,
                       use_softmax=use_softmax,
                       label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight, **self.kw)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class HuberLoss(Layer):
    def __init__(self, delta=1.0, reduction="mean", name=None):
        super().__init__()
        self.delta = delta
        self.reduction = reduction

    def forward(self, input, label):
        return F.huber_loss(input, label, self.delta, self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.kw = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                       reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self.kw)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HingeEmbeddingLoss(Layer):
    """~ paddle.nn.HingeEmbeddingLoss."""

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over a class tree."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.is_custom = is_custom
        n_nodes = max(1, num_classes if is_custom else num_classes - 1)
        limit = math.sqrt(6.0 / (feature_size + n_nodes))
        w = torch.empty((n_nodes, feature_size), device=dev)
        self.weight = nn.Parameter(w.uniform_(
            -limit, limit, generator=torch_generator(generator, dev)))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(n_nodes, device=dev))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)
