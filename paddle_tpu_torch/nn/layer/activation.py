"""Activation layers of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/activation.py:10-95``: each layer
but ``PReLU`` calls its ``nn.functional`` activation with the arguments
it was made with, the leading ones by position in the reference's order
(``_ARG_NAMES``) and the rest by keyword (``name`` is dropped).
``PReLU`` holds a ``weight`` of ``num_parameters`` slopes, ``init_value``
each, applied per channel (axis 1 for an "NC..." ``data_format``, the
last axis otherwise) or, with one slope, to every element.
"""
from __future__ import annotations

import torch

from ...ops.dispatch import apply_op
from .. import functional as F
from .. import initializer as init
from .layers import Layer, create_parameter

_ARG_NAMES = {
    "leaky_relu": ["negative_slope"],
    "elu": ["alpha"],
    "celu": ["alpha"],
    "gelu": ["approximate"],
    "hardtanh": ["min", "max"],
    "hardshrink": ["threshold"],
    "softshrink": ["threshold"],
    "thresholded_relu": ["threshold"],
    "softmax": ["axis"],
    "log_softmax": ["axis"],
    "maxout": ["groups", "axis"],
    "glu": ["axis"],
}


def _simple(cls_name, fn_name):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kw = dict(zip(_ARG_NAMES.get(fn_name, []), args))
            self._kw.update((k, v) for k, v in kwargs.items()
                            if k != "name")

        def forward(self, x):
            return getattr(F, fn_name)(x, **self._kw)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    _Act.__name__ = _Act.__qualname__ = cls_name
    _Act.__doc__ = f"``F.{fn_name}`` as a layer."
    return _Act


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
ELU = _simple("ELU", "elu")
CELU = _simple("CELU", "celu")
SELU = _simple("SELU", "selu")
GELU = _simple("GELU", "gelu")
Sigmoid = _simple("Sigmoid", "sigmoid")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
Hardtanh = _simple("Hardtanh", "hardtanh")
Hardshrink = _simple("Hardshrink", "hardshrink")
Softshrink = _simple("Softshrink", "softshrink")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Softplus = _simple("Softplus", "softplus")
Softsign = _simple("Softsign", "softsign")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Softmax = _simple("Softmax", "softmax")
LogSoftmax = _simple("LogSoftmax", "log_softmax")
Maxout = _simple("Maxout", "maxout")
GLU = _simple("GLU", "glu")
Tanh = _simple("Tanh", "tanh")


def _prelu(x, w, channel_first):
    if w.shape[0] == 1:
        w = w.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if channel_first else x.dim() - 1] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


class PReLU(Layer):
    """max(0, x) + weight * min(0, x), one learned slope per channel."""

    def __init__(self, num_parameters=1, init_value=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None):
        super().__init__()
        self.weight = create_parameter(
            (num_parameters,), weight_attr,
            default_initializer=init.Constant(init_value), device=device)
        self.data_format = data_format

    def forward(self, x):
        return apply_op("prelu", _prelu, x, self.weight,
                        channel_first=self.data_format.startswith("NC"))
