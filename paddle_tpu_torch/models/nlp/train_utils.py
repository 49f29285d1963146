"""The AdamW update and optimizer state of the port's train-step
factories.

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


@torch.no_grad()
def apply_adamw(params: Dict[str, torch.Tensor], grads: list, opt_state,
                lr, beta1, beta2, eps, weight_decay,
                accum_dtype=torch.float32):
    """One AdamW step of the train-step factories, IN PLACE: advance
    ``opt_state["step"]``, then ``adamw_update`` each tensor of
    ``params`` and its moments. ``grads`` is a list in ``params``' order;
    each entry is set to None once used, which frees it, and a None entry
    (a parameter the loss does not reach) leaves its tensor alone."""
    opt_state["step"] += 1
    t = opt_state["step"].to(torch.float32)
    for i, k in enumerate(params):
        if grads[i] is None:
            continue
        m, v = opt_state["m"][k], opt_state["v"][k]
        new_p, m2, v2 = adamw_update(params[k], grads[i], m, v, t, lr, beta1,
                                     beta2, eps, weight_decay, accum_dtype)
        grads[i] = None
        params[k].copy_(new_p)
        m.copy_(m2)
        v.copy_(v2)


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
