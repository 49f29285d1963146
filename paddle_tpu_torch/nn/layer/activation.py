"""``ReLU`` of the PyTorch port (counterpart of the reference's ``ReLU``
layer, ``paddle_tpu/nn/layer/activation.py:44``): ``F.relu``."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)
