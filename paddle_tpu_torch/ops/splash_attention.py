"""Block-sparse ("splash") attention for the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas/splash_attention.py``. Its TPU
kernels (``_fwd_kernel`` :165 / ``_fwd_kernel_stream`` :253,
``_bwd_dq_kernel`` :215 / ``_bwd_dq_kernel_stream`` :313,
``_bwd_dkv_kernel`` :357) become ``kernels/splash_attention.cu``, CUDA
kernels written for Hopper and bound with ``ctypes``. ``splash_attention``
(and its alias ``grouped_splash_attention``, as in the reference,
``:647-667``) is a ``torch.autograd.Function``; its forward calls
``splash_fwd`` and its backward ``splash_bwd``, and each of those:

* launches the kernels for CUDA tensors, or raises;
* runs the plain PyTorch version (``_splash_fwd_plain``,
  ``_splash_bwd_plain``) for CPU tensors. Nothing else selects it.

The function: attention over q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D),
Hq = G * Hkv (multi-head is G = 1), in which query position i and key j
are a live pair iff ``block_mask[i // block_q, j // block_k]`` and, with
``causal``, ``i + q_offset >= j`` and, with ``window``,
``i + q_offset - j < window``. The roundings are the grouped flash
kernels' (q2 in the forward and dq, k2 in dk/dv, probabilities and ds to
the operand dtype). A row with no live key gives out 0 and lse NEG_INF,
and its probabilities are exactly 0 in the backward too
(``splash_attention.py:191-212``, ``:239-241``). ``delta`` is computed in
f32 outside the kernels (``:544-546``).

The kernels walk tables built on the host from the pattern for their own
tiles, once per pattern and tiling, and kept on the card
(``_device_tables``): for the forward and dq, the key tiles of each query
tile that hold a live pair; for dk/dv, the query tiles of each key tile's
column. The mask is read per element inside a tile, so any block size
that tiles the sequences works, smaller or larger than the kernels' tiles.

Not ported, on purpose: ``fits_score_budget``, ``pick_splash_blocks``,
``SCORE_ELEMS``, ``MAX_ROWS``, ``_FORCE_STREAM`` and the resident fit.
They budget the TPU's scoped VMEM; the CUDA kernels have one tiling. The
kernels take head_dim 64, 128 and 256, float32, bfloat16 and float16, and
any group G, as the grouped flash kernels do (a tile holds
``_group_tile(G, rows)`` heads).

Launch counts: ``splash_attention.launches_fwd``, ``.launches_dq`` and
``.launches_dkv``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from .flash_attention import LN2, LOG2E, NEG_INF
from .flash_attention_gqa import (_DKV_ROWS, _DTYPE_CODE, _TILES,
                                  _bwd_operands, _device_kind, _f32,
                                  _group_tile, _operands, _round, _scale_of,
                                  _shapes)
from .kernels import _build

_KERNEL = "splash_attention"
_NO_WINDOW = 2 ** 31 - 1


def banded_block_mask(Sq, Sk, block_q, block_k, window,
                      causal=True) -> np.ndarray:
    """Block mask for sliding-window attention (``splash_attention.py:122``):
    block (i, j) is live iff some (q_pos, k_pos) pair in it satisfies the
    causal triangle and q_pos - k_pos < window (token-exact masking
    happens in the kernel)."""
    i = np.arange(Sq // block_q)[:, None]
    j = np.arange(Sk // block_k)[None, :]
    live = np.ones((Sq // block_q, Sk // block_k), bool)
    if causal:
        live &= j * block_k <= (i + 1) * block_q - 1
    if window is not None:
        # the block's least q_pos - k_pos is q_lo - k_hi
        live &= i * block_q - ((j + 1) * block_k - 1) < window
    return live


def _pattern_tables(block_mask: np.ndarray):
    """Dense (nq, nk) bool -> (kv_idx (nq, max_kv), kv_cnt (nq,)) int32:
    the live kv blocks of each q block, in order, padded with the last
    (``splash_attention.py:103``)."""
    bm = np.asarray(block_mask, bool)
    kv_cnt = bm.sum(1).astype(np.int32)
    width = max(1, int(kv_cnt.max()))
    order = np.argsort(~bm, axis=1, kind="stable")[:, :width]
    last = order[np.arange(len(bm)), np.maximum(kv_cnt - 1, 0)]
    pad = np.arange(width)[None, :] >= kv_cnt[:, None]
    kv_idx = np.where(pad, last[:, None], order).astype(np.int32)
    kv_idx[kv_cnt == 0] = 0
    return kv_idx, kv_cnt


@dataclasses.dataclass(frozen=True)
class _Pattern:
    """The static pattern of a call: block mask (packed, hashable), its
    block sizes and the elementwise terms."""
    bits: bytes
    n_blocks: tuple
    block_q: int
    block_k: int
    causal: bool
    window: int | None
    q_offset: int

    @property
    def mask(self) -> np.ndarray:
        n = self.n_blocks[0] * self.n_blocks[1]
        flat = np.unpackbits(np.frombuffer(self.bits, np.uint8), count=n)
        return flat.astype(bool).reshape(self.n_blocks)


def _pattern(q, k, block_mask, causal, block_q, block_k, window, q_offset):
    bm = np.asarray(block_mask, bool)
    if bm.ndim != 2:
        raise ValueError(f"splash_attention: block_mask must be 2-D, got "
                         f"shape {bm.shape}")
    nq, nk = bm.shape
    Sq, Sk = q.shape[2], k.shape[2]
    bq = block_q or (Sq // nq if nq else 0)
    bk = block_k or (Sk // nk if nk else 0)
    if not bq or not bk or Sq != nq * bq or Sk != nk * bk:
        raise ValueError(
            f"splash_attention: block_mask {nq}x{nk} with blocks "
            f"({bq},{bk}) does not tile seqs ({Sq},{Sk})")
    if window is not None and window < 1:
        raise ValueError(f"splash_attention: window must be >= 1 or None, "
                         f"got {window}")
    return _Pattern(np.packbits(bm).tobytes(), (nq, nk), int(bq), int(bk),
                    bool(causal), None if window is None else int(window),
                    int(q_offset))


def _live_pairs(pat: _Pattern, Sq, Sk, device):
    """(Sq, Sk) bool: the live (query position, key) pairs."""
    i = torch.arange(Sq, device=device)
    j = torch.arange(Sk, device=device)
    bm = torch.from_numpy(pat.mask).to(device)
    live = bm[i // pat.block_q][:, j // pat.block_k]
    d = (i[:, None] + pat.q_offset) - j[None, :]
    if pat.causal:
        live &= d >= 0
    if pat.window is not None:
        live &= d < pat.window
    return live


def _splash_fwd_plain(q, k, v, pat: _Pattern, sm_scale=None):
    """The plain PyTorch version of the forward kernel: exact softmax in
    f32 over the live pairs, with the kernels' roundings (q2 and the
    probabilities to q's dtype); a row with no live key gives out 0 and
    lse NEG_INF. One (batch, kv head) at a time, so a long sequence needs
    one (G, Sq, Sk) score tensor at once. Returns (out like q, lse
    (B, Hq, Sq) f32, natural log)."""
    B, Hq, Hkv, G, Sq, Sk, D = _shapes(q, k, v)
    scale = _scale_of(q, sm_scale)
    live = _live_pairs(pat, Sq, Sk, q.device)
    c = _f32(scale * LOG2E).to(q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * G, (h + 1) * G)
            q2 = _round(q[b, heads].to(torch.float32) * c, q.dtype)
            s = torch.einsum("gqd,kd->gqk", q2, k[b, h].to(torch.float32))
            s.masked_fill_(~live, NEG_INF)
            m = s.amax(-1, keepdim=True)
            p = s.sub_(m).exp2_().masked_fill_(~live, 0.0)
            l = p.sum(-1)
            l_safe = torch.where(l == 0, torch.ones_like(l), l)
            acc = torch.einsum("gqk,kd->gqd", _round(p, v.dtype),
                               v[b, h].to(torch.float32))
            out[b, heads] = (acc / l_safe[..., None]).to(q.dtype)
            lse[b, heads] = torch.where(
                l > 0, LN2 * m[..., 0] + torch.log(l_safe),
                torch.full_like(l, NEG_INF))
    return out, lse


def _splash_bwd_plain(q, k, v, do, lse, delta, pat: _Pattern,
                      sm_scale=None):
    """The plain PyTorch version of the dq and dk/dv kernels: dq takes its
    scores from q2 = round(q * scale * log2 e), dk/dv from
    k2 = round(k * scale * log2 e); p is exactly 0 on a masked pair, also
    where lse is NEG_INF; ds and p are rounded to the operand dtype before
    their products. One (batch, kv head) at a time. Returns (dq like q,
    dk like k, dv like v)."""
    B, Hq, Hkv, G, Sq, Sk, D = _shapes(q, k, v)
    scale = _scale_of(q, sm_scale)
    live = _live_pairs(pat, Sq, Sk, q.device)
    c = _f32(scale * LOG2E).to(q.device)
    f32 = torch.float32
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * G, (h + 1) * G)
            qf, dof = q[b, heads].to(f32), do[b, heads].to(f32)
            kf, vf = k[b, h].to(f32), v[b, h].to(f32)
            lse2 = lse[b, heads].to(f32)[..., None] * _f32(LOG2E).to(q.device)
            dl = delta[b, heads].to(f32)[..., None]
            dp = torch.einsum("gqd,kd->gqk", dof, vf).sub_(dl)

            def probs(s):
                return s.sub_(lse2).exp2_().masked_fill_(~live, 0.0)

            # dq: scores from q2
            p = probs(torch.einsum("gqd,kd->gqk", _round(qf * c, q.dtype),
                                   kf))
            ds = p.mul_(dp).mul_(scale)
            dq[b, heads] = torch.einsum("gqk,kd->gqd", _round(ds, k.dtype),
                                        kf).to(q.dtype)
            del p, ds
            # dk, dv: scores from k2
            p = probs(torch.einsum("gqd,kd->gqk", qf,
                                   _round(kf * c, k.dtype)))
            dv[b, h] = torch.einsum("gqk,gqd->kd", _round(p, do.dtype),
                                    dof).to(v.dtype)
            ds = p.mul_(dp).mul_(scale)
            dk[b, h] = torch.einsum("gqk,gqd->kd", _round(ds, q.dtype),
                                    qf).to(k.dtype)
    return dq, dk, dv


def _tile_tables(pat: _Pattern, Sq, Sk, tile_q, tile_k):
    """(live, full), each (Sq // tile_q, Sk // tile_k) bool: whether a
    kernel tile of tile_q query positions and tile_k keys holds a live pair,
    and whether all of its pairs are live. Worked out on cells of gcd size,
    each inside one mask block, where the live pairs are those whose
    q_pos + q_offset - k_pos lies in an interval."""
    uq, uk = math.gcd(pat.block_q, tile_q), math.gcd(pat.block_k, tile_k)
    q0 = np.arange(Sq // uq, dtype=np.int64) * uq
    k0 = np.arange(Sk // uk, dtype=np.int64) * uk
    blk = pat.mask[q0 // pat.block_q][:, k0 // pat.block_k]
    d_lo = (q0 + pat.q_offset)[:, None] - (k0 + uk - 1)[None, :]
    d_hi = d_lo + (uq - 1) + (uk - 1)
    lo = 0 if pat.causal else -(1 << 62)
    hi = pat.window - 1 if pat.window is not None else 1 << 62
    some = blk & (np.maximum(d_lo, lo) <= np.minimum(d_hi, hi))
    every = blk & (d_lo >= lo) & (d_hi <= hi)
    shape = (Sq // tile_q, tile_q // uq, Sk // tile_k, tile_k // uk)
    return (some.reshape(shape).any(axis=(1, 3)),
            every.reshape(shape).all(axis=(1, 3)))


def _walk(live, full):
    """The reference's pattern tables of ``live`` (per row, its live
    columns in order) with each entry as 2 * column + partial. Returns
    (entries (n, width), counts (n,)) int32."""
    cols, counts = _pattern_tables(live)
    partial = ~np.take_along_axis(full, cols, axis=1)
    return (2 * cols + partial).astype(np.int32), counts


@functools.lru_cache(maxsize=64)
def _device_tables(pat: _Pattern, Sq, Sk, G, dtype, device):
    """The kernels' walks for ``pat`` on ``device``, built on the host once
    per pattern, lengths, group, dtype and device, then kept: (rows, row
    counts) per query tile of the forward/dq tiling, (columns, column
    counts) per key tile of the dk/dv tiling, and the uint8 block mask."""
    rows_per_tile, keys = _TILES[dtype]
    dkv_rows = _DKV_ROWS[dtype]
    rows = _walk(*_tile_tables(pat, Sq, Sk,
                               rows_per_tile // _group_tile(G, rows_per_tile),
                               keys))
    live, full = _tile_tables(pat, Sq, Sk,
                              dkv_rows // _group_tile(G, dkv_rows), keys)
    cols = _walk(live.T, full.T)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (on(rows[0]), on(rows[1]), on(cols[0]), on(cols[1]),
            on(pat.mask.astype(np.uint8)))


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the walk (tiles, counts, stride, mask, n_mask_k, bq, bk), the shape (B,
# Hkv, G, Sq, Sk, D) and the elementwise terms (causal, window, q_offset)
_WALK = [_PTR, _PTR, _I32, _PTR] + [_I32] * 3 + [_I32] * 6 + [_I32] * 3
_SIGNATURES = {
    "splash_fwd_launch": [_PTR] * 5 + _WALK + [_F32, _I32],
    "splash_bwd_dq_launch": [_PTR] * 7 + _WALK + [_F32, _F32, _I32],
    "splash_bwd_dkv_launch": [_PTR] * 8 + _WALK + [_F32, _F32, _I32],
}


def _walk_args(pat, tiles, counts, mask, shape):
    return (tiles.data_ptr(), counts.data_ptr(), tiles.shape[1],
            mask.data_ptr(), pat.n_blocks[1], pat.block_q, pat.block_k,
            *shape, int(pat.causal),
            min(pat.window or _NO_WINDOW, _NO_WINDOW), pat.q_offset)


def _launch(fn_name, dev, *args):
    _build.launch(_build.load(_KERNEL, _SIGNATURES), fn_name, dev, *args)


def _launch_fwd(q, k, v, pat, sm_scale):
    shape, (q, k, v) = _operands("splash attention kernel", [q, k, v],
                                 q, k, v)
    B, Hkv, G, Sq, Sk, D = shape
    rows, row_n, _, _, mask = _device_tables(pat, Sq, Sk, G, q.dtype,
                                             q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hkv * G, Sq), dtype=torch.float32, device=q.device)
    _launch("splash_fwd_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *_walk_args(pat, rows, row_n, mask, shape),
            float(sm_scale * LOG2E), _DTYPE_CODE[q.dtype])
    splash_attention.launches_fwd += 1
    return out, lse


def _launch_dq(q, k, v, do, lse, delta, pat, sm_scale):
    shape, (q, k, v, do, lse, delta) = _bwd_operands(
        q, k, v, do, lse, delta, "splash attention backward kernel")
    _, _, G, Sq, Sk, _ = shape
    rows, row_n, _, _, mask = _device_tables(pat, Sq, Sk, G, q.dtype,
                                             q.device)
    dq = torch.empty_like(q)
    _launch("splash_bwd_dq_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *_walk_args(pat, rows, row_n, mask, shape),
            float(sm_scale * LOG2E), float(sm_scale), _DTYPE_CODE[q.dtype])
    splash_attention.launches_dq += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, pat, sm_scale):
    shape, (q, k, v, do, lse, delta) = _bwd_operands(
        q, k, v, do, lse, delta, "splash attention backward kernel")
    _, _, G, Sq, Sk, _ = shape
    _, _, cols, col_n, mask = _device_tables(pat, Sq, Sk, G, q.dtype,
                                             q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("splash_bwd_dkv_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *_walk_args(pat, cols, col_n, mask, shape),
            float(sm_scale * LOG2E), float(sm_scale), _DTYPE_CODE[q.dtype])
    splash_attention.launches_dkv += 1
    return dk, dv


def splash_fwd(q, k, v, pat: _Pattern, sm_scale=None):
    """(out, lse) of the forward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    sm_scale = _scale_of(q, sm_scale)
    if _device_kind(q, "splash attention") == "cpu":
        return _splash_fwd_plain(q, k, v, pat, sm_scale)
    return _launch_fwd(q, k, v, pat, sm_scale)


def splash_bwd(q, k, v, do, lse, delta, pat: _Pattern, sm_scale=None):
    """(dq, dk, dv) from the forward's residuals and ``delta`` =
    rowsum(do * out) in f32: the dq kernel then the dk/dv kernel for CUDA
    tensors, the plain version for CPU tensors."""
    sm_scale = _scale_of(q, sm_scale)
    if _device_kind(q, "splash attention") == "cpu":
        return _splash_bwd_plain(q, k, v, do, lse, delta, pat, sm_scale)
    dq = _launch_dq(q, k, v, do, lse, delta, pat, sm_scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, pat, sm_scale)
    return dq, dk, dv


class _SplashAttention(torch.autograd.Function):
    """Saves (q, k, v, out, lse), as the reference's custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, pat, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = splash_fwd(q, k, v, pat, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.pat, ctx.sm_scale = pat, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.to(torch.float32) * out.to(torch.float32)).sum(-1)
        dq, dk, dv = splash_bwd(q, k, v, do, lse, delta, ctx.pat,
                                ctx.sm_scale)
        return dq, dk, dv, None, None


def splash_attention(q, k, v, block_mask, causal=False, sm_scale=None,
                     block_q=None, block_k=None, window=None, q_offset=0):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D) with Hq a multiple of Hkv
    (multi-head is Hq == Hkv) -> (B, Hq, Sq, D). ``block_mask`` is a
    (Sq // block_q, Sk // block_k) bool numpy array (the block sizes
    default to the sequences over the mask's shape). Equal to dense
    attention over the live pairs (module docstring), differentiable in q,
    k and v; dead blocks are skipped, not computed."""
    _shapes(q, k, v)
    pat = _pattern(q, k, block_mask, causal, block_q, block_k, window,
                   q_offset)
    return _SplashAttention.apply(q, k, v, pat,
                                  float(_scale_of(q, sm_scale)))


splash_attention.launches_fwd = 0
splash_attention.launches_dq = 0
splash_attention.launches_dkv = 0

# the grouped entry point is the same function, as in the reference
grouped_splash_attention = splash_attention
