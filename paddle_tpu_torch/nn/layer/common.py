"""The common layers of the PyTorch port.

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

The rest (``paddle_tpu/nn/layer/common.py:15-295``) call their
``nn.functional`` function with the arguments they were made with;
``Bilinear`` keeps a (out, in1, in2) XavierNormal weight and a zero bias;
the dropout layers draw from ``generator`` (the default generator when
None) in training mode.
"""
from __future__ import annotations

import torch

from ...ops.dispatch import apply_op
from ...ops.manipulation import flatten
from .. import functional as F
from .. import initializer as init
from .layers import Layer, create_parameter


class Linear(Layer):
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


class Embedding(Layer):
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


class Dropout(Layer):
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


class Flatten(Layer):
    """``ops.flatten`` of the axes ``start_axis`` .. ``stop_axis``."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format, self.generator = p, data_format, generator

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format, self.generator = p, data_format, generator

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training,
                               generator=self.generator)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class Bilinear(Layer):
    """x1 W x2 (+ bias) with W (out, in1, in2)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), weight_attr, **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), bias_attr, is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = (downscale_factor,
                                                   data_format)

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class _PadNd(Layer):
    def __init__(self, padding, mode, value=0.0, data_format="NCHW"):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    """``F.pad`` with zeros (the reference's: its pairs run over the
    spatial axes first to last, unlike ``F.zeropad2d``'s [left, right,
    top, bottom])."""

    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


def _pairwise_distance(x, y, p, epsilon, keepdim):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


class PairwiseDistance(Layer):
    """The p-norm of x - y + epsilon along the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return apply_op("pairwise_distance", _pairwise_distance, x, y,
                        p=self.p, epsilon=self.epsilon, keepdim=self.keepdim)


class Softmax2D(Layer):
    """Softmax over the channel axis of (N, C, H, W) or (C, H, W)."""

    def forward(self, x):
        return F.softmax(x, axis=-3)
