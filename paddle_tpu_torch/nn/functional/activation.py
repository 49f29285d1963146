"""Activations of the PyTorch port: ``gelu``, ``relu`` and ``tanh``.

Counterpart of the reference's ``gelu``, ``relu`` and ``tanh`` lowerings
(``paddle_tpu/ops/specs.yaml:173, :142``, ``ops/activation.py``):
``jax.nn.gelu(x, approximate)``, the exact erf form unless
``approximate=True`` (then the tanh form), ``jax.nn.relu`` and
``jnp.tanh``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)
