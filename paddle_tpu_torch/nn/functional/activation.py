"""Activations of ``nn.functional`` in the PyTorch port: the reference's
27 (``paddle_tpu/nn/functional/__init__.py:5-11``), which are the ops of
the op namespace (``ops.activation``, generated from the spec table, and
``ops.math.tanh``), and the in-place ``relu_``, ``elu_``, ``tanh_`` and
``softmax_`` (``:55-66``).

The reference's in-place form computes the activation and overwrites the
input's value (``x._value = out._value``), recording nothing: a later
gradient through ``x`` skips the activation, and ``x`` stays a leaf that
may require grad. torch refuses an in-place op on such a leaf, so the
port copies the reference's behaviour instead: the result is written
into ``x`` under ``torch.no_grad`` and ``x`` is returned (README, the
reference's traps).
"""
from __future__ import annotations

import torch

from ...ops.activation import (celu, elu, gelu, glu,  # noqa: F401
                               gumbel_softmax, hardshrink, hardsigmoid,
                               hardswish, hardtanh, leaky_relu, log_sigmoid,
                               log_softmax, maxout, mish, prelu, relu, relu6,
                               selu, sigmoid, silu, softmax, softplus,
                               softshrink, softsign, swish, tanhshrink,
                               thresholded_relu)
from ...ops.math import tanh  # noqa: F401


def _make_inplace_act(fn):
    def wrapper(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        with torch.no_grad():
            x.copy_(out)
        return x
    wrapper.__name__ = wrapper.__qualname__ = fn.__name__ + "_"
    wrapper.__doc__ = (f"``{fn.__name__}`` written into x, recording no "
                       f"gradient (the reference's in-place form).")
    return wrapper


relu_ = _make_inplace_act(relu)
elu_ = _make_inplace_act(elu)
tanh_ = _make_inplace_act(tanh)
softmax_ = _make_inplace_act(softmax)
