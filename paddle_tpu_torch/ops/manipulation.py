"""``flatten`` of the PyTorch port.

Counterpart of ``paddle_tpu/ops/manipulation.py:29``: merge the axes
``start_axis`` .. ``stop_axis`` (negative ones count from the end) into
one; a 0-d tensor becomes shape (1,).
"""
from __future__ import annotations

import math


def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    start, stop = start_axis % nd, stop_axis % nd
    shape = tuple(x.shape)
    return x.reshape(shape[:start] + (math.prod(shape[start:stop + 1]),)
                     + shape[stop + 1:])
