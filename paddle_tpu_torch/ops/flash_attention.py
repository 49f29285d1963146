"""Multi-head flash attention, its constants and the shape gate of the
PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: the
constants and the gate (``NEG_INF``, ``LOG2E``, ``LN2``,
``flash_eligible``, ``:57-71``) and ``flash_attention`` (``:661``), whose
TPU kernels are the K/V-resident ``_fwd_kernel`` (``:218``),
``_bwd_dq_kernel`` (``:262``) and ``_bwd_dkv_kernel`` (``:297``) and their
K/V-streamed variants (``:353``, ``:400``, ``:440``). The port keeps its
own copies: it imports nothing of the JAX package.

Both variants compute one function, and it is the grouped kernels' at one
query head per kv head: the same q2 = round(q * scale * log2 e) in the
forward and dq, k2 = round(k * scale * log2 e) in dk/dv, top-left causal
(query position >= key position, both from 0, also when Sq != Sk), lse
in natural log (compare ``flash_attention.py:218-337`` with
``flash_attention_gqa.py:131-260``). So ``flash_attention`` is
``grouped_flash_attention``'s autograd Function at G = 1, over
``mha_fwd`` / ``mha_bwd``: CUDA tensors launch the kernels of
``kernels/flash_attention_gqa.cu``, CPU tensors take ``_gqa_fwd_plain`` /
``_gqa_bwd_plain`` at Hkv = H. Its launches are counted apart from the
grouped path's: ``flash_attention.launches_fwd``, ``.launches_dq`` and
``.launches_dkv``.

Not ported, on purpose: ``_resolve_blocks``, ``_resident_fits``,
``_stream_fits``, ``MEASURED_BLOCK_ORDER``, the ``block_q`` / ``block_k``
/ ``bwd_block_*`` / ``stream`` arguments and ``CAUSAL_STREAM_VIA_SPLASH``
(``:95-205``, ``:648-698``). They tune the TPU kernels to its 16 MiB of
scoped VMEM; the CUDA kernels have one tiling and take every length the
gate admits.

The reference also gates flash attention on ``FLAGS_use_flash_attention``.
The port has no such switch: at an eligible shape the card always runs
the flash kernels, never plain attention.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# imported after the constants, which that module takes from this one
from . import flash_attention_gqa as _gqa  # noqa: E402


def flash_eligible(seq_len: int, head_dim: int, dtype) -> bool:
    """The one shape/dtype gate for the flash entry points: sequences that
    are a multiple of 128 and at least 256 long, head_dim 64/128/256,
    float32 or bfloat16."""
    return (seq_len >= 256 and seq_len % 128 == 0
            and head_dim in (64, 128, 256)
            and dtype in (torch.float32, torch.bfloat16))


def mha_fwd(q, k, v, causal=False, sm_scale=None):
    """(out, lse): ``gqa_fwd`` at G = 1, its launches counted on
    ``flash_attention``."""
    return _gqa.gqa_fwd(q, k, v, causal, sm_scale, counts=flash_attention)


def mha_bwd(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """(dq, dk, dv): ``gqa_bwd`` at G = 1, its launches counted on
    ``flash_attention``."""
    return _gqa.gqa_bwd(q, k, v, do, lse, delta, causal, sm_scale,
                        counts=flash_attention)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """q (B, H, Sq, D), k/v (B, H, Sk, D) -> (B, H, Sq, D): softmax
    attention, top-left causal when ``causal``, differentiable in q, k and
    v. ``sm_scale`` defaults to 1/sqrt(D)."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention: expected q (B, H, Sq, D) and "
                         f"k/v (B, H, Sk, D) with one head count; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    _gqa._shapes(q, k, v)
    return _gqa._GroupedFlashAttention.apply(
        q, k, v, bool(causal), float(_gqa._scale_of(q, sm_scale)), mha_fwd,
        mha_bwd)


flash_attention.launches_fwd = 0
flash_attention.launches_dq = 0
flash_attention.launches_dkv = 0
_gqa._OWNERS["flash_attention"] = flash_attention
