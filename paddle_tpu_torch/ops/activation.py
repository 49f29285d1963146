"""Activation ops of the PyTorch port.

Counterpart of ``paddle_tpu/ops/activation.py``: the elementwise
activations are generated from the spec table (``codegen.SPECS``, group
``activation``); ``gumbel_softmax``, ``maxout`` and ``glu`` are written
here. ``swish`` is ``silu``. ``gumbel_softmax`` adds Gumbel noise only
when given a ``torch.Generator`` as ``key`` (the reference's ``key``, a
JAX key, defaults to None: no noise), and ``hard=True`` gives the one-hot
of the argmax with the soft gradient (straight-through).
"""
from __future__ import annotations

import torch

from ._util import op
from .codegen import generate as _generate

_GENERATED_ACTIVATIONS = _generate(globals(), groups={"activation"})

swish = silu  # noqa: F821 - generated above


@op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, key=None):
    g = 0.0
    if key is not None:
        u = torch.rand(x.shape, generator=key, device=x.device,
                       dtype=x.dtype)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        idx = torch.argmax(y, axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


@op("maxout")
def maxout(x, groups, axis=1):
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), axis + 1)


@op("glu")
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, axis)
    return a * torch.sigmoid(b)


__all__ = _GENERATED_ACTIVATIONS + ["swish", "gumbel_softmax", "maxout",
                                    "glu"]
