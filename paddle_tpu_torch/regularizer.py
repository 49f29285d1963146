"""``L1Decay`` and ``L2Decay`` of the PyTorch port.

Counterpart of ``paddle_tpu/regularizer.py``: a decay term over one
parameter, ``coeff * sum(|p|)`` and ``0.5 * coeff * sum(p * p)``. As in
the reference, no optimizer reads one: ``ParamAttr(regularizer=...)`` is
stored and never used, and a regularizer given as an optimizer's
``weight_decay`` has no product with a tensor, so the step raises
TypeError (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self.mode = "l1"

    def __call__(self, param):
        return self.coeff * torch.sum(torch.abs(param))


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self.mode = "l2"

    def __call__(self, param):
        return 0.5 * self.coeff * torch.sum(param * param)
