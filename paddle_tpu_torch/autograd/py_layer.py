"""``PyLayer``: user-defined autograd functions of the PyTorch port.

Counterpart of ``paddle_tpu/autograd/py_layer.py``, over
``torch.autograd.Function``. A subclass defines static ``forward(ctx,
*args, **kwargs)`` and ``backward(ctx, *grads)`` and is called through
``apply``, never instantiated (RuntimeError, as the reference). The
forward runs without recording a graph; ``backward`` gets one gradient per
output and returns one per tensor argument of the forward (None for one
it does not differentiate, which reads as zeros), the Paddle contract.
``ctx.save_for_backward(*tensors)`` keeps tensors for the backward;
``ctx.saved_tensor`` gives them, as the reference's property, and so does
``ctx.saved_tensor()``, Paddle's method form; ``ctx.saved_tensors()``
too.
"""
from __future__ import annotations

import torch


class _Saved(tuple):
    """The saved tensors: a tuple that calling returns as it is."""

    def __call__(self):
        return self


class PyLayerContext:
    def __init__(self):
        self._saved = _Saved()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = _Saved(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Bridge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        ctx.layer, ctx.pctx = layer, PyLayerContext()
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        return layer.forward(ctx.pctx, *args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        got = ctx.layer.backward(ctx.pctx, *grads)
        if not isinstance(got, (tuple, list)):
            got = (got,)
        got = list(got)
        out = []
        for is_t in ctx.is_tensor:
            out.append(got.pop(0) if is_t and got else None)
        return (None, None, *out)


class PyLayerMeta(type):
    def __call__(cls, *args, **kwargs):
        raise RuntimeError(
            f"use {cls.__name__}.apply(...) — PyLayer is not instantiated")


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _Bridge.apply(cls, kwargs, *args)


class LegacyPyLayer(PyLayer):
    pass
