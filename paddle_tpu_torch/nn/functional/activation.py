"""Activations of the PyTorch port: ``gelu`` and ``relu``.

Counterpart of the reference's ``gelu`` and ``relu`` lowerings
(``paddle_tpu/ops/specs.yaml:173``, ``ops/activation.py``):
``jax.nn.gelu(x, approximate)``, the exact erf form unless
``approximate=True`` (then the tanh form), and ``jax.nn.relu``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)
