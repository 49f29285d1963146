"""``scaled_dot_product_attention``, ``sparse_attention`` and
``block_sparse_attention`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/attention.py:19-79``. Inputs
are (batch, seq, heads, head_dim), the reference's layout. Whether the
flash kernels run is decided up front by the reference's own gate
(``:46-48``): no mask, Sq >= 256, Sq and Sk multiples of 128, head_dim in
(64, 128, 256); like the reference's, it reads no dtype. An eligible
call runs the port's multi-head ``flash_attention`` (the CUDA kernels on
the card, which take every head_dim the gate admits, and float32,
bfloat16 and float16); any other call takes the reference's plain
softmax path, with the f32 softmax cast back to q's dtype (``:61-78``);
its products promote mixed dtypes as ``jnp.einsum`` does (a bfloat16 q
against a float32 cache gives float32 scores and output).
The reference's ``use_pallas`` switch is not ported: as with the flash
gate of the Llama path, an eligible shape always takes the kernels.

``sparse_attention`` (``:82-115``) is the reference's plain formula, no
kernel on either side: (B, H, L, D) inputs, the CSR pattern expanded to a
mask, scores and softmax in q's dtype. As in the reference,
``key_padding_mask`` and ``attn_mask`` are accepted and not read (ROADMAP
Queue 3). ``block_sparse_attention`` (``:118-140``) runs the port's
``ops.splash_attention`` (the splash kernels on the card, their plain
versions on the CPU) over a numpy block mask. All three go through the
op dispatch (``ops.dispatch``) under the reference's op names.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.dispatch import apply_op
from ...ops.flash_attention import flash_attention
from ...ops.linalg import matmul
from ...ops.splash_attention import splash_attention


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
    return apply_op("scaled_dot_product_attention", _sdpa, query, key,
                    value, attn_mask, is_causal=is_causal)


def _sdpa(query, key, value, attn_mask, is_causal):
    if _flash_gate(query, key, attn_mask):
        out = flash_attention(query.transpose(1, 2), key.transpose(1, 2),
                              value.transpose(1, 2), causal=is_causal)
        return out.transpose(1, 2)
    scale = 1.0 / math.sqrt(query.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    scores = matmul(qt, kt, transpose_y=True) * scale
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
    return matmul(probs, vt).transpose(1, 2)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """query/key/value (B, H, L, D); per (batch, head) a CSR pattern:
    ``sparse_csr_offset`` (.., L + 1) row starts and
    ``sparse_csr_columns`` (.., nnz) key columns, broadcast over B and H.
    Softmax over each row's listed keys; a row with none gives zeros."""
    return apply_op("sparse_attention", _sparse_attention, query, key,
                    value, sparse_csr_offset, sparse_csr_columns)


def _sparse_attention(q, k, v, off, cols):
    B, H, L, D = q.shape
    nnz = cols.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(D))
    off = off.expand(B, H, off.shape[-1]).contiguous()
    cols = cols.expand(B, H, nnz).long()
    pos = torch.arange(nnz, device=q.device).expand(B, H, nnz).contiguous()
    # the row of each nonzero: the last offset at or before its position
    rows = torch.searchsorted(off, pos, right=True) - 1
    # an entry past the pattern's last row lands in a spare slot, dropped
    flat = torch.where((rows >= 0) & (rows < L), rows * L + cols, L * L)
    mask = torch.zeros((B, H, L * L + 1), dtype=torch.bool, device=q.device)
    mask.scatter_(-1, flat, True)
    mask = mask[..., :L * L].reshape(B, H, L, L)
    scores = scores.masked_fill(~mask, torch.finfo(q.dtype).min)
    probs = torch.softmax(scores, -1).masked_fill(~mask, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def block_sparse_attention(query, key, value, block_mask, is_causal=False,
                           block_q=None, block_k=None):
    """query/key/value (B, S, H, D); ``block_mask`` a numpy bool array
    tiling (Sq, Sk) by (block_q, block_k) (default: the sequences over
    its shape). Attention over the live blocks only, dead blocks skipped:
    ``ops.splash_attention``."""
    bm = np.asarray(block_mask, bool)
    return apply_op("block_sparse_attention", _block_sparse, query, key,
                    value, block_mask=bm, is_causal=is_causal,
                    block_q=block_q, block_k=block_k)


def _block_sparse(q, k, v, block_mask, is_causal, block_q, block_k):
    out = splash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), block_mask, is_causal, None,
                           block_q, block_k)
    return out.transpose(1, 2)
