"""Chunked-vocabulary causal-LM cross entropy for the PyTorch port: the
loss of a tied head without its (B*S, V) logits.

Counterpart of ``paddle_tpu/ops/chunked_ce.py`` (``chunked_causal_lm_loss``
:43, ``_fwd_impl`` :57, ``_bwd_vjp`` :101). The head projection and the
CE fuse: the forward walks vocabulary chunks of ``w`` with an online max
and sum, picks each row's label logit from the chunk that holds it, and
saves only the rows' lse; the backward recomputes each chunk's softmax
from that lse and accumulates ``dx`` and ``dw``. At Llama-3's V = 128256
and 8192 tokens the f32 logits would take 4.2 GB; here one (N, chunk)
f32 chunk lives at a time.

Chunk logits are f32 products of the inputs (the reference's
``preferred_element_type=jnp.float32``): on the card a 16-bit product
writes f32 straight from cuBLAS (``torch.mm(..., out_dtype=)``), on the
CPU the inputs are widened first (exact for bf16 and f16). The last chunk
pads ``w`` with zero rows and masks its out-of-vocabulary columns with
``NEG``, as the reference does. No TPU kernel lies in this module: the
reference computes these products outside any Pallas call too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def _num_chunks(V, chunk):
    # ceil: a partial last chunk is padded with zero rows of w and its
    # out-of-vocabulary columns masked with NEG
    return -(-V // chunk)


def _mm_f32(a, b):
    """a @ b with f32 products summed in f32, the result in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def _chunk(w, ci, chunk):
    """Rows [ci*chunk, (ci+1)*chunk) of w, padded with zero rows past V
    (the reference's ``_padded``, built for the last chunk alone)."""
    wc = w[ci * chunk:(ci + 1) * chunk]
    if wc.shape[0] < chunk:
        wc = F.pad(wc, (0, 0, 0, chunk - wc.shape[0]))
    return wc


def _chunk_logits(x2, w, ci, chunk):
    """(N, chunk) f32 logits of chunk ``ci``, NEG past the vocabulary."""
    V = w.shape[0]
    wc = _chunk(w, ci, chunk)
    lg = _mm_f32(x2, wc.T)
    if (ci + 1) * chunk > V:
        col = ci * chunk + torch.arange(chunk, device=x2.device)
        lg = torch.where(col[None, :] < V, lg, NEG)
    return wc, lg


def _label_offsets(lbl, ci, chunk):
    """Each row's label offset in chunk ``ci``, clipped, and whether the
    label lies in it."""
    off = lbl - ci * chunk
    return off.clamp(0, chunk - 1), (off >= 0) & (off < chunk)


class _ChunkedCausalLMLoss(torch.autograd.Function):
    """Saves (x2, w, labels, lse), as the reference's custom_vjp does."""

    @staticmethod
    def forward(ctx, x, w, labels, chunk):
        B, S, H = x.shape
        V, N = w.shape[0], B * S
        x2 = x.reshape(N, H)
        lbl = labels.reshape(N).long()
        m = torch.full((N,), NEG, dtype=torch.float32, device=x.device)
        l = torch.zeros((N,), dtype=torch.float32, device=x.device)
        lab = torch.full((N,), NEG, dtype=torch.float32, device=x.device)
        for ci in range(_num_chunks(V, chunk)):
            _, lg = _chunk_logits(x2, w, ci, chunk)
            m_new = torch.maximum(m, lg.amax(1))
            l = l * torch.exp(m - m_new) \
                + torch.exp(lg - m_new[:, None]).sum(1)
            m = m_new
            off, in_c = _label_offsets(lbl, ci, chunk)
            picked = lg.gather(1, off[:, None])[:, 0]
            lab = torch.where(in_c, picked, lab)
        lse = m + torch.log(l)
        ctx.save_for_backward(x2, w, lbl, lse)
        ctx.chunk, ctx.x_shape = chunk, x.shape
        return (lse - lab).mean()

    @staticmethod
    def backward(ctx, g):
        x2, w, lbl, lse = ctx.saved_tensors
        chunk = ctx.chunk
        (N, H), V = x2.shape, w.shape[0]
        scale = g.to(torch.float32) / N      # d(mean) / d(row)
        dx = torch.zeros((N, H), dtype=torch.float32, device=x2.device)
        dw = torch.empty_like(w)
        for ci in range(_num_chunks(V, chunk)):
            wc, lg = _chunk_logits(x2, w, ci, chunk)
            p = torch.exp(lg - lse[:, None])     # this chunk's softmax
            off, in_c = _label_offsets(lbl, ci, chunk)
            # p - onehot(label), in place and without a host sync: each
            # row adds -1 to its label's column if the label lies in this
            # chunk, else -0 (which leaves p as it is)
            p.scatter_add_(1, off[:, None], -in_c.to(p.dtype)[:, None])
            d_lg = (p * scale).to(x2.dtype)
            del p, lg
            dx += _mm_f32(d_lg, wc)
            lo = ci * chunk
            dw[lo:lo + chunk] = _mm_f32(d_lg.T, x2)[:min(chunk, V - lo)] \
                .to(w.dtype)
        return dx.reshape(ctx.x_shape).to(x2.dtype), dw, None, None


def chunked_causal_lm_loss(x, w, labels, chunk_size=16384):
    """Mean CE of softmax(x @ w.T) against labels, without the full
    logits.

    x: (B, S, H) activations; w: (V, H) head weights (the tied-embedding
    layout); labels: (B, S) integers, position-aligned (callers shift).
    Returns the scalar mean loss in f32, differentiable in x and w."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2] \
            or tuple(labels.shape) != tuple(x.shape[:2]):
        raise ValueError(f"expected x (B, S, H), w (V, H) and labels (B, "
                         f"S); got {tuple(x.shape)}, {tuple(w.shape)} and "
                         f"{tuple(labels.shape)}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1 (got {chunk_size})")
    return _ChunkedCausalLMLoss.apply(x, w, labels, int(chunk_size))
