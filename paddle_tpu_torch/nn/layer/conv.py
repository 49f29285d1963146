"""``Conv1D``, ``Conv2D`` and ``Conv3D`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/conv.py:17-92`` (``_ConvNd``,
``Conv1D/2D/3D``). The weight is (out, in / groups, *kernel), drawn in f32
on ``device`` (``cuda`` unless ``"cpu"`` is asked for) from ``generator``
(the default generator when None) by the reference's initialisers:
``KaimingUniform`` (uniform within ±sqrt(2) * sqrt(3 / fan_in),
``nn/initializer:118-128``) for the weight and uniform within ±1 /
sqrt(fan_in) for the bias, fan_in = in / groups * prod(kernel), unless
``weight_attr`` / ``bias_attr`` (``ParamAttr``s, in the reference's
positions) say otherwise; ``bias_attr=False`` leaves no bias. ``padding_mode`` other than ``"zeros"`` is
refused: the reference accepts it and pads with zeros all the same
(ROADMAP Queue 3). Transposed convolutions are not ported yet (ROADMAP
Queue 1 item 16).
"""
from __future__ import annotations

import math


from .. import functional as F
from .. import initializer as init
from ..functional.conv import _tuplize
from .layers import Layer, create_parameter


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, device, generator):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: the reference accepts it "
                "and pads with zeros all the same (ROADMAP Queue 3, faults "
                "of the reference); the port refuses it rather than compute "
                "either function")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _tuplize(kernel_size, n)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        kw = {"device": device, "generator": generator}
        fan_in = (in_channels // groups) * math.prod(self.kernel_size)
        self.weight = create_parameter(
            (out_channels, in_channels // groups) + self.kernel_size,
            weight_attr, default_initializer=init.KaimingUniform(
                fan_in=fan_in), **kw)
        if bias_attr is False:
            self.bias = None
        else:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = create_parameter(
                (out_channels,), bias_attr, is_bias=True,
                default_initializer=init.Uniform(-bound, bound), **kw)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device,
                         generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device,
                         generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device,
                         generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)
