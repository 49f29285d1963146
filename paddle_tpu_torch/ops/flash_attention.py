"""Flash-attention constants and the shape gate of the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py:57-71``
(``NEG_INF``, ``LOG2E``, ``LN2``, ``flash_eligible``). The port keeps its
own copies: it imports nothing of the JAX package. The multi-head flash
kernels of that module (ROADMAP Queue 2 rows 2-5) are not ported yet; the
grouped-query kernels are, in ``flash_attention_gqa.py``.

The reference also gates flash attention on ``FLAGS_use_flash_attention``.
The port has no such switch: at an eligible shape the card always runs
the flash kernels, never plain attention.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def flash_eligible(seq_len: int, head_dim: int, dtype) -> bool:
    """The one shape/dtype gate for the flash entry points: sequences that
    are a multiple of 128 and at least 256 long, head_dim 64/128/256,
    float32 or bfloat16."""
    return (seq_len >= 256 and seq_len % 128 == 0
            and head_dim in (64, 128, 256)
            and dtype in (torch.float32, torch.bfloat16))
