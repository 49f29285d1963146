"""Pooling layers of the PyTorch port: ``MaxPool1D/2D/3D``,
``AvgPool1D/2D/3D``, ``AdaptiveAvgPool1D/2D/3D``,
``AdaptiveMaxPool1D/2D/3D`` and ``MaxUnPool1D/2D/3D``.

Counterpart of ``paddle_tpu/nn/layer/pooling.py``: each layer calls its
function of ``nn.functional.pooling`` with the arguments it was made
with. The reference's layers accept ``return_mask``, ``ceil_mode`` and
``divisor_override`` and drop them (``MaxPool2D`` never passes
``return_mask`` on, ``_pool_nd`` ignores ``ceil_mode``); the port refuses
each when it would change the result (ROADMAP Queue 3, faults of the
reference).
"""
from __future__ import annotations


from .. import functional as F
from ..functional.pooling import _refuse, _refuse_divisor
from .layers import Layer


class _Pool(Layer):
    def __init__(self, fn, **kw):
        super().__init__()
        if kw.pop("return_mask", False):
            raise NotImplementedError(
                "return_mask=True: the reference's pooling layers accept it "
                "and return no mask (ROADMAP Queue 3, faults of the "
                "reference); the port refuses it")
        _refuse(kw.get("ceil_mode", False))
        _refuse_divisor(kw.pop("divisor_override", None))
        self._fn = fn
        self._kw = kw

    def forward(self, x):
        return self._fn(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False):
        super().__init__(F.max_pool1d, kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW"):
        super().__init__(F.max_pool2d, kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW"):
        super().__init__(F.max_pool3d, kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False):
        super().__init__(F.avg_pool1d, kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive,
                         ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW"):
        super().__init__(F.avg_pool2d, kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive,
                         ceil_mode=ceil_mode,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW"):
        super().__init__(F.avg_pool3d, kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive,
                         ceil_mode=ceil_mode,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AdaptiveAvgPool1D(_Pool):
    def __init__(self, output_size):
        super().__init__(F.adaptive_avg_pool1d, output_size=output_size)


class AdaptiveAvgPool2D(_Pool):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__(F.adaptive_avg_pool2d, output_size=output_size,
                         data_format=data_format)


class AdaptiveAvgPool3D(_Pool):
    def __init__(self, output_size, data_format="NCDHW"):
        super().__init__(F.adaptive_avg_pool3d, output_size=output_size,
                         data_format=data_format)


class AdaptiveMaxPool1D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size=output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool2D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size=output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool3D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size=output_size,
                         return_mask=return_mask)


class _MaxUnPool(Layer):
    def __init__(self, fn, kernel_size, stride, padding, data_format,
                 output_size):
        super().__init__()
        self._fn = fn
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return self._fn(x, indices, *self._args)


class MaxUnPool1D(_MaxUnPool):
    """``F.max_unpool1d`` of a pooled x and its mask."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(F.max_unpool1d, kernel_size, stride, padding,
                         data_format, output_size)


class MaxUnPool2D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(F.max_unpool2d, kernel_size, stride, padding,
                         data_format, output_size)


class MaxUnPool3D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(F.max_unpool3d, kernel_size, stride, padding,
                         data_format, output_size)
