"""The AdamW update and optimizer state of the port's train-step factory.

Counterpart of ``paddle_tpu/models/nlp/train_utils.py:53-84``
(``adamw_update``, ``make_adamw_state``) on one device. The ZeRO moment
sharding (``zero_like_sharded``) and host-memory moments
(``with_memory_kind``) belong to the distributed queue (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch


def adamw_update(p, g, m, v, t, lr, beta1, beta2, eps, weight_decay,
                 accum_dtype=torch.float32):
    """One decoupled-weight-decay Adam step on a single tensor; moments in
    ``accum_dtype``, ``t`` the step as an f32 tensor, the param returned
    in its own dtype. The reference's formula, operation for operation.
    Returns new tensors (the caller updates in place)."""
    g = g.to(accum_dtype)
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * torch.square(g)
    mhat = m2 / (1 - beta1 ** t)
    vhat = v2 / (1 - beta2 ** t)
    delta = mhat / (torch.sqrt(vhat) + eps) \
        + weight_decay * p.to(accum_dtype)
    return (p.to(accum_dtype) - lr * delta).to(p.dtype), m2, v2


def make_adamw_state(params: Dict[str, torch.Tensor],
                     accum_dtype=torch.float32):
    """{"step": int32 scalar, "m": {k: zeros}, "v": {k: zeros}}, each
    moment in ``accum_dtype`` on its parameter's device."""
    dev = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: torch.zeros(v.shape, dtype=accum_dtype, device=v.device)
              for k, v in params.items()},
        "v": {k: torch.zeros(v.shape, dtype=accum_dtype, device=v.device)
              for k, v in params.items()},
    }
