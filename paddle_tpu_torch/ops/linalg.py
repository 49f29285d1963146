"""``matmul`` of the PyTorch port.

Counterpart of ``paddle_tpu/ops/linalg.py:24`` (``jnp.matmul``). Where
the two operands' dtypes differ, both are cast to their promoted type
first, as ``jnp.matmul`` does (a bfloat16 operand times a float32 one is
a float32 product); ``torch.matmul`` would refuse them. It is the op
``matmul`` of the op dispatch (``ops.dispatch``).
"""
from __future__ import annotations

import torch

from .dispatch import apply_op


def matmul(x, y, transpose_x=False, transpose_y=False):
    """x @ y (x's or y's last two axes swapped first with
    ``transpose_x`` / ``transpose_y``)."""
    return apply_op("matmul", _matmul, x, y, transpose_x=transpose_x,
                    transpose_y=transpose_y)


def _matmul(x, y, transpose_x, transpose_y):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return torch.matmul(x, y)
