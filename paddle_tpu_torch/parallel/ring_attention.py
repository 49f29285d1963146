"""Ring attention over a "sep" mesh axis (context parallelism) for the
PyTorch port.

Counterpart of ``paddle_tpu/parallel/ring_attention.py``. The reference
takes GLOBAL (B, H, S, D) arrays and shards the sequence inside a
``shard_map``; the port runs one process a rank, and each rank already
holds its chunk, as its tensor-parallel path already holds its heads
(``pallas_sharding.py``). So every function here takes the rank's LOCAL
chunks q (B, Hq, S/n, D) and k/v (B, Hkv, S/n, D), rank c of the axis
holding positions c·S/n .. (c+1)·S/n - 1, and returns the rank's chunk of
the output. K/V travel round the ring by ``collective.ring_shift`` (the
reference's ``ppermute``): under NCCL as device tensors, under gloo
through pinned host memory; the attention kernels run on the card either
way.

Two engines, as in the reference:

* the flash engine (``_RingFlash``, ``:70-203``), where
  ``flash_eligible(S/n, D, dtype)``: at ring step i the rank holds the K/V
  of chunk src = (c - i) mod n and runs the flash forward over it causally
  (src = c), in full (src < c) or not at all (src > c, causal: no launch);
  the partial (out, lse) merge in log space. The backward computes
  delta = rowsum(dO·O) once, calls the flash backward kernels with the
  MERGED lse and that delta at each step (the softmax gradient restricted
  to the chunk), and rotates dK/dV accumulators with their chunks, so that
  each ends at home. K/V stay at their true head count: the grouped
  kernels (``gqa_fwd`` / ``gqa_bwd``, launches on
  ``grouped_flash_attention``) take them where Hq > Hkv, the multi-head
  ones (``mha_fwd`` / ``mha_bwd``, on ``flash_attention``) at Hq = Hkv;
  the reference repeats them per chunk (``_expand``), which computes the
  same function;
* the dense engine: an exact f32 softmax over the chunk pairs, through a
  differentiable ``ring_shift`` (autograd), for ineligible shapes.

``ring_window_attention`` composes a sliding window with the ring: only
the ``ring_window_active_steps`` pair distances the band touches run. At
distance d the splash kernels (``splash_fwd`` / ``splash_bwd``) take the
query frame shifted by ``q_offset = d·S/n``, causal only at d = 0, and the
pair's block mask (``_pair_mask``) at ``WINDOW_MASK_BLOCK``; a wrapped
pair (c < d) contributes nothing and launches nothing. The reference's
``pick_splash_blocks`` tunes the TPU's VMEM and is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..distributed.collective import ring_shift

NEG_INF = -1e30
# block size of the banded and pair masks the Llama path gives the splash
# kernels: the mask is read per element inside the kernels' tiles, so it
# sets no work, and 128 divides every flash-eligible length
WINDOW_MASK_BLOCK = 128


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _merge(O, LSE, o, lse):
    """The reference's ``_merge`` (``:85-90``): two normalised partials
    combined in log space, in f32."""
    LSE_new = torch.logaddexp(LSE, lse)
    wO = torch.exp(LSE - LSE_new)[..., None]
    wo = torch.exp(lse - LSE_new)[..., None]
    return O * wO + o.to(torch.float32) * wo, LSE_new


def _flash_kernels(G):
    """(forward, backward) of the flash kernels for a kv group of G: the
    multi-head ones at G = 1, the grouped ones above."""
    from ..ops import flash_attention as fa
    from ..ops import flash_attention_gqa as gqa
    if G == 1:
        return fa.mha_fwd, fa.mha_bwd
    return gqa.gqa_fwd, gqa.gqa_bwd


class _RingFlash(torch.autograd.Function):
    """The flash engine's ring (``_ring_flash_local``): saves (q, k, v, O,
    LSE) with LSE merged over the whole ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        n, my = group.nranks, group.rank
        fwd, _ = _flash_kernels(q.shape[1] // k.shape[1])
        O = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        LSE = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                         device=q.device)
        kb, vb = k, v
        for i in range(n):
            src = (my - i) % n
            if not causal or src <= my:
                o, lse = fwd(q, kb, vb, causal and src == my, sm_scale)
                O, LSE = _merge(O, LSE, o, lse)
            if i + 1 < n:
                kb, vb = ring_shift([kb, vb], group)
        O = O.to(q.dtype)
        ctx.save_for_backward(q, k, v, O, LSE)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return O

    @staticmethod
    def backward(ctx, dO):
        q, k, v, O, LSE = ctx.saved_tensors
        group, causal, sm_scale = ctx.group, ctx.causal, ctx.sm_scale
        n, my = group.nranks, group.rank
        _, bwd = _flash_kernels(q.shape[1] // k.shape[1])
        dO = dO.contiguous()
        # depends on the global output only: once, not once a step (:151)
        delta = (dO.to(torch.float32) * O.to(torch.float32)).sum(-1)
        f32 = torch.float32
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dk = torch.zeros(k.shape, dtype=f32, device=k.device)
        dv = torch.zeros(v.shape, dtype=f32, device=v.device)
        kb, vb = k, v
        for i in range(n):
            src = (my - i) % n
            if not causal or src <= my:
                dql, dkb, dvb = bwd(q, kb, vb, dO, LSE, delta,
                                    causal and src == my, sm_scale)
                dq += dql.to(f32)
                dk += dkb.to(f32)
                dv += dvb.to(f32)
            if i + 1 < n:
                # the accumulators ride with their chunks (:168-200)
                kb, vb, dk, dv = ring_shift([kb, vb, dk, dv], group)
        # after step n-1 the accumulators hold chunk c+1's terms: home
        dk, dv = ring_shift([dk, dv], group, -(n - 1))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


class _Shift(torch.autograd.Function):
    """``ring_shift`` as an autograd function: the gradient goes back by
    the opposite shift."""

    @staticmethod
    def forward(ctx, group, offset, *tensors):
        ctx.group, ctx.offset = group, offset
        return tuple(ring_shift(list(tensors), group, offset))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ring_shift(list(grads), ctx.group,
                                               -ctx.offset))


def _shift(group, *tensors):
    return _Shift.apply(group, 1, *tensors)


def _block_attn(q32, k, v, mask):
    """The dense engine's partials (``_block_attn``, ``:44-67``): q32
    (B, Hq, Sq, D) pre-scaled f32; k/v (B, Hkv, Sk, D); mask (Sq, Sk)
    bool. Returns (max, exp sum, acc) in f32 with Hq heads."""
    B, Hq, Sq, D = q32.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q32.reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(-1), min=-1e29)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return (m.reshape(B, Hq, Sq), l.reshape(B, Hq, Sq),
            acc.reshape(B, Hq, Sq, D))


def _dense_ring(q, k, v, group, masks, sm_scale):
    """Online softmax over the ring steps of ``masks`` (one (Sq, Sk) bool
    per step; all False where the step contributes nothing, so that every
    rank's graph, and so its backward's shifts, are the same), K/V shifted
    by ``_shift`` between them: differentiable by autograd."""
    q32 = q.to(torch.float32) * sm_scale
    m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for i, mask in enumerate(masks):
        bm, bl, bacc = _block_attn(q32, kb, vb, mask)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        l = alpha * l + beta * bl
        acc = acc * alpha[..., None] + bacc * beta[..., None]
        m = m_new
        if i + 1 < len(masks):
            kb, vb = _shift(group, kb, vb)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, axis: str = "sep", causal: bool = True,
                   sm_scale=None, batch_axis=None, head_axis=None):
    """Attention of the rank's query chunk over the whole sequence, whose
    chunks lie on the ranks of ``mesh``'s ``axis`` (``:413-476``). q
    (B, Hq, S/n, D), k/v (B, Hkv, S/n, D) with Hq a multiple of Hkv: the
    rank's chunks; returns its chunk of the output, differentiable in q, k
    and v. ``batch_axis`` / ``head_axis`` are accepted for the reference's
    signature: a rank's batch rows and heads are its own already. Every
    rank of the axis must call it."""
    from ..ops.flash_attention import flash_eligible

    group = mesh.group(axis)
    n, my = max(group.nranks, 1), max(group.rank, 0)
    sm_scale = _scale(q, sm_scale)
    Sq, Sk = q.shape[2], k.shape[2]
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} not a multiple of kv "
                         f"heads {k.shape[1]}")
    if flash_eligible(Sq, q.shape[-1], q.dtype):
        return _RingFlash.apply(q, k, v, group, bool(causal),
                                float(sm_scale))
    tri = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
    full = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    masks = []
    for i in range(n):
        src = (my - i) % n
        if not causal:
            masks.append(full)
        else:
            masks.append(tri if src == my else full if src < my
                         else torch.zeros_like(full))
    return _dense_ring(q, k, v, group, masks, sm_scale)


def ring_window_active_steps(n: int, window: int, Sloc: int) -> int:
    """Ring steps that can carry a live (query, key) pair under a sliding
    window (``:206-219``): the pair at chunk distance d has least
    q_pos - k_pos = (d - 1)·Sloc + 1, live iff < window; later steps are
    wholly outside the band and skipped."""
    if window <= 1:
        # only the diagonal can be live: the nearest cross-position pair
        # has gap 1, dead for a window <= 1
        return 1
    d_max = max(0, (window - 2)) // Sloc + 1
    return min(n, d_max + 1)


def _pair_mask(d, Sloc, block, window):
    """The block mask of the chunk pair at distance d (``:237-247``): the
    band's blocks at d = 0; otherwise block (i, j) is live iff its least
    q_pos - k_pos, d·Sloc + i·block - (j + 1)·block + 1, lies inside the
    window."""
    from ..ops.splash_attention import banded_block_mask
    if d == 0:
        return banded_block_mask(Sloc, Sloc, block, block, window)
    nb = Sloc // block
    i = np.arange(nb)[:, None]
    j = np.arange(nb)[None, :]
    return d * Sloc + i * block - (j + 1) * block + 1 < window


def _window_pattern(q, k, d, window):
    from ..ops.splash_attention import _pattern
    Sloc, b = q.shape[2], WINDOW_MASK_BLOCK
    return _pattern(q, k, _pair_mask(d, Sloc, b, window), d == 0, b, b,
                    window, d * Sloc)


class _RingWindowSplash(torch.autograd.Function):
    """The splash engine's window ring (``_ring_window_splash_local``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, window, sm_scale):
        from ..ops.splash_attention import splash_fwd
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        n, my = group.nranks, group.rank
        n_act = ring_window_active_steps(n, window, q.shape[2])
        O = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        LSE = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                         device=q.device)
        kb, vb = k, v
        for d in range(n_act):
            if my >= d:                 # a wrapped pair is acausal
                o, lse = splash_fwd(q, kb, vb,
                                    _window_pattern(q, kb, d, window),
                                    sm_scale)
                O, LSE = _merge(O, LSE, o, lse)
            if d + 1 < n_act:
                kb, vb = ring_shift([kb, vb], group)
        O = O.to(q.dtype)
        ctx.save_for_backward(q, k, v, O, LSE)
        ctx.group, ctx.window, ctx.sm_scale = group, window, sm_scale
        return O

    @staticmethod
    def backward(ctx, dO):
        from ..ops.splash_attention import splash_bwd
        q, k, v, O, LSE = ctx.saved_tensors
        group, window, sm_scale = ctx.group, ctx.window, ctx.sm_scale
        n, my = group.nranks, group.rank
        n_act = ring_window_active_steps(n, window, q.shape[2])
        dO = dO.contiguous()
        delta = (dO.to(torch.float32) * O.to(torch.float32)).sum(-1)
        f32 = torch.float32
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dk = torch.zeros(k.shape, dtype=f32, device=k.device)
        dv = torch.zeros(v.shape, dtype=f32, device=v.device)
        kb, vb = k, v
        for d in range(n_act):
            if my >= d:
                dql, dkb, dvb = splash_bwd(q, kb, vb, dO, LSE, delta,
                                           _window_pattern(q, kb, d, window),
                                           sm_scale)
                dq += dql.to(f32)
                dk += dkb.to(f32)
                dv += dvb.to(f32)
            if d + 1 < n_act:
                kb, vb, dk, dv = ring_shift([kb, vb, dk, dv], group)
        # the accumulators hold chunk c - (n_act - 1)'s terms: one shift
        # home (:328-331), none when only the diagonal ran
        dk, dv = ring_shift([dk, dv], group, -(n_act - 1))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_window_attention(q, k, v, mesh, window: int, axis: str = "sep",
                          sm_scale=None, batch_axis=None, head_axis=None):
    """Causal sliding-window attention (q_pos - k_pos < window) of the
    rank's query chunk, the sequence's chunks on ``mesh``'s ``axis``
    (``:381-410``): only the chunk pairs the band touches run. q
    (B, Hq, S/n, D), k/v (B, Hkv, S/n, D): the rank's chunks; returns its
    chunk of the output, differentiable in q, k and v. The splash engine
    where ``flash_eligible(S/n, D, dtype)`` (S/n a multiple of
    ``WINDOW_MASK_BLOCK``), else the dense one (``_dense_window_ring``,
    ``:339-378``)."""
    from ..ops.flash_attention import flash_eligible

    group = mesh.group(axis)
    n, my = max(group.nranks, 1), max(group.rank, 0)
    sm_scale = _scale(q, sm_scale)
    Sloc = q.shape[2]
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} not a multiple of kv "
                         f"heads {k.shape[1]}")
    if Sloc % WINDOW_MASK_BLOCK == 0 and flash_eligible(Sloc, q.shape[-1],
                                                        q.dtype):
        return _RingWindowSplash.apply(q, k, v, group, int(window),
                                       float(sm_scale))
    n_act = ring_window_active_steps(n, window, Sloc)
    qp = torch.arange(Sloc, device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    masks = []
    for d in range(n_act):
        gap = d * Sloc + qp - kp
        # a wrapped pair (c < d) contributes nothing
        masks.append((gap < window) & (gap >= 0) & (my >= d))
    return _dense_ring(q, k, v, group, masks, sm_scale)
