"""``scaled_dot_product_attention`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/attention.py:19-79``. Inputs
are (batch, seq, heads, head_dim), the reference's layout. Whether the
flash kernels run is decided up front by the reference's own gate
(``:46-48``): no mask, Sq >= 256, Sq and Sk multiples of 128, head_dim in
(64, 128, 256); like the reference's, it reads no dtype. An eligible
call runs the port's multi-head ``flash_attention`` (the CUDA kernels on
the card, which take every head_dim the gate admits, and float32,
bfloat16 and float16); any other call takes the reference's plain
softmax path, with the f32 softmax cast back to q's dtype (``:61-78``).
The reference's ``use_pallas`` switch is not ported: as with the flash
gate of the Llama path, an eligible shape always takes the kernels.
"""
from __future__ import annotations

import math

import torch

from ...ops.flash_attention import flash_attention


def _flash_gate(q, k, mask):
    return (mask is None and q.shape[1] >= 256 and q.shape[1] % 128 == 0
            and k.shape[1] % 128 == 0 and q.shape[-1] in (64, 128, 256))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """query (B, Sq, H, D), key/value (B, Sk, H, D) -> (B, Sq, H, D).

    ``attn_mask``: bool (True = attend) or additive, broadcast against
    (B, H, Sq, Sk). ``dropout_p`` and ``training`` are accepted and
    ignored, exactly as in the reference, whose computation never reads
    them: attention probabilities are not dropped."""
    if _flash_gate(query, key, attn_mask):
        out = flash_attention(query.transpose(1, 2), key.transpose(1, 2),
                              value.transpose(1, 2), causal=is_causal)
        return out.transpose(1, 2)
    scale = 1.0 / math.sqrt(query.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    scores = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    lowest = torch.finfo(scores.dtype).min
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=scores.device).tril(sk - sq)
        scores = scores.masked_fill(~causal, lowest)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, lowest)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(query.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)
