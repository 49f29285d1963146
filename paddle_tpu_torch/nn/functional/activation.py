"""Activations of the PyTorch port: ``gelu``, ``relu`` and ``tanh``.

Counterpart of the reference's ``gelu``, ``relu`` and ``tanh`` lowerings
(``paddle_tpu/ops/specs.yaml:173, :142``, ``ops/activation.py``):
``jax.nn.gelu(x, approximate)``, the exact erf form unless
``approximate=True`` (then the tanh form), ``jax.nn.relu`` and
``jnp.tanh``. Each is the op of the reference's codegen name
(``gelu``, ``relu``, ``tanh``) in the op dispatch (``ops.dispatch``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.dispatch import def_op


@def_op("gelu")
def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


@def_op("relu")
def relu(x):
    return torch.relu(x)


@def_op("tanh")
def tanh(x):
    return torch.tanh(x)
