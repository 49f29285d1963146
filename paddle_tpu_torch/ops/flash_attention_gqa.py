"""Grouped-query (GQA/MQA) flash attention for the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention_gqa.py``. Its three
TPU kernels (``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``)
become ``kernels/flash_attention_gqa.cu`` (the kernels of
``kernels/flash_tiles.cuh`` over the causal walk), CUDA kernels written
for Hopper and bound with ``ctypes``; at G = 1 they are also the
multi-head kernels of ``flash_attention.py``. ``grouped_flash_attention``
is a ``torch.autograd.Function``; its forward calls ``gqa_fwd`` and its
backward ``gqa_bwd``, and each of those:

* launches the kernels for CUDA tensors, or raises;
* runs the plain PyTorch version (``_gqa_fwd_plain``, ``_gqa_bwd_plain``)
  for CPU tensors, so the CPU tests exercise the same Function and the
  same backward wiring the card does. Nothing else selects it.

Layouts are the reference's: q (B, Hq, S, D), k/v (B, Hkv, S, D) with
Hq = G * Hkv and head order h = kv_head * G + g (``repeat_interleave``).
Scores live in the exp2 domain (the scale folds ``log2(e)`` into q, which
is rounded to q's dtype first, as the reference does); lse is stored in
natural log. ``delta = rowsum(do * out)`` is computed in f32 outside the
kernels, as the reference does (``flash_attention_gqa.py:390``).

Not ported, on purpose: ``_gqa_resolve_blocks``, ``_gqa_fits``,
``ResidentOverflowError`` and the splash delegation. They come from the
TPU's 16 MiB of scoped VMEM; the CUDA kernel takes every sequence length
the gate admits. The kernels take head_dim 64, 128 and 256, float32,
bfloat16 and float16, and any kv group G: where G divides the query tile
(64 rows in bfloat16 and float16, 32 in float32) a tile holds all G heads
of a kv head, else one head's positions (``_group_tile``).

Launch counts: ``grouped_flash_attention.launches_fwd``, ``.launches_dq``
and ``.launches_dkv``; a launch for ``flash_attention`` counts there
instead (the ``counts`` argument).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import LN2, LOG2E, NEG_INF
from .kernels import _build

_KERNEL = "flash_attention_gqa"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# (query rows, keys) per tile of the forward and dq kernels; the rows are
# _group_tile(G, rows) heads x positions. The dk/dv kernels walk query
# tiles of _DKV_ROWS rows. Both are kernels/flash_tiles.cuh's constants
# (kRows, kKeys, kDkvRows for the 16-bit types; BM, BK for float32).
_TILES = {torch.float32: (32, 32), torch.bfloat16: (64, 64),
          torch.float16: (64, 64)}
_DKV_ROWS = {torch.float32: 32, torch.bfloat16: 64, torch.float16: 64}
_HEAD_DIMS = (64, 128, 256)


def _group_tile(G, rows):
    """The query heads a tile of ``rows`` rows holds: all G of a kv head
    where G divides the rows, else one (``group_tile`` of the header)."""
    return G if rows % G == 0 else 1


def _shapes(q, k, v):
    """(B, Hq, Hkv, G, Sq, Sk, D), or ValueError on inconsistent shapes."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Hq, S, D) and k/v (B, Hkv, S, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head_dim")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    return B, Hq, Hkv, Hq // Hkv, Sq, Sk, D


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _causal_mask(Sq, Sk, device):
    """True where key position <= query position (both from 0)."""
    return (torch.arange(Sk, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None])


def _round(x, dtype):
    """x rounded to ``dtype`` and back to f32 (a no-op for float32)."""
    return x.to(dtype).to(torch.float32)


def _gqa_fwd_plain(q, k, v, causal=False, sm_scale=None):
    """The plain PyTorch version of the forward kernel: exact softmax in
    f32 over the grouped scores, the same roundings (q2 and the
    probabilities to q's dtype). Returns (out like q, lse (B, Hq, Sq) f32,
    natural log)."""
    B, Hq, Hkv, G, Sq, Sk, D = _shapes(q, k, v)
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    q2 = _round(q.to(torch.float32) * _f32(scale * LOG2E).to(q.device),
                q.dtype).reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q2, k.to(torch.float32))
    if causal:
        s.masked_fill_(~_causal_mask(Sq, Sk, q.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = s.sub_(m).exp2_()
    l = p.sum(-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", _round(p, v.dtype),
                       v.to(torch.float32))
    out = (acc / l_safe[..., None]).to(q.dtype).reshape(B, Hq, Sq, D)
    lse = (LN2 * m[..., 0] + torch.log(l_safe)).reshape(B, Hq, Sq)
    return out, lse


def _gqa_bwd_plain(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """The plain PyTorch version of the two backward kernels. dq takes its
    scores from q2 = round(q * scale * log2 e), dk/dv from
    k2 = round(k * scale * log2 e), as the reference's dq and dkv kernels
    do; ds and p are rounded to the operand dtype before their products.
    Returns (dq like q, dk like k, dv like v)."""
    B, Hq, Hkv, G, Sq, Sk, D = _shapes(q, k, v)
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    c = _f32(scale * LOG2E).to(q.device)
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Hkv, G, Sq, D)
    dof = do.to(f32).reshape(B, Hkv, G, Sq, D)
    kf, vf = k.to(f32), v.to(f32)
    lse2 = (lse.to(f32) * _f32(LOG2E).to(q.device)).reshape(B, Hkv, G, Sq, 1)
    dl = delta.to(f32).reshape(B, Hkv, G, Sq, 1)
    live = _causal_mask(Sq, Sk, q.device) if causal else None
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)

    def probs(s):
        if live is not None:
            s.masked_fill_(~live, NEG_INF)
        return s.sub_(lse2).exp2_()

    # dq: scores from q2
    p = probs(torch.einsum("bhgqd,bhkd->bhgqk", _round(qf * c, q.dtype), kf))
    ds = p.mul_(dp - dl).mul_(scale)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", _round(ds, k.dtype), kf)
    del p, ds
    # dk, dv: scores from k2
    p = probs(torch.einsum("bhgqd,bhkd->bhgqk", qf, _round(kf * c, k.dtype)))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", _round(p, do.dtype), dof)
    ds = p.mul_(dp - dl).mul_(scale)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", _round(ds, q.dtype), qf)
    return (dq.to(q.dtype).reshape(B, Hq, Sq, D), dk.to(k.dtype),
            dv.to(v.dtype))


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gqa_fwd_launch": [_PTR] * 5 + [_I32] * 7 + [_F32, _I32],
    "gqa_bwd_dq_launch": [_PTR] * 7 + [_I32] * 7 + [_F32, _F32, _I32],
    "gqa_bwd_dkv_launch": [_PTR] * 8 + [_I32] * 7 + [_F32, _F32, _I32],
}


def _operands(what, tensors, q, k, v, do=None):
    """Check what the kernels take; return the shape tuple and
    ``tensors`` made contiguous and 16-byte aligned."""
    B, Hq, Hkv, G, Sq, Sk, D = _shapes(q, k, v)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {q.dtype} (use float32, bfloat16 "
                        "or float16)")
    if any(t.dtype != q.dtype for t in (k, v, do) if t is not None):
        raise TypeError(f"{what}: q, k, v (and do) must share one dtype")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} (the kernels take 64, 128 "
                         "or 256)")
    rows, keys = _TILES[q.dtype]
    positions = rows // _group_tile(G, rows)
    if Sq % positions or Sk % keys:
        raise ValueError(f"{what}: sequence lengths ({Sq}, {Sk}) must be "
                         f"multiples of ({positions}, {keys})")
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: every operand must lie on {dev}")
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return (B, Hkv, G, Sq, Sk, D), out


def _launch(fn_name, dev, *args):
    _build.launch(_build.load(_KERNEL, _SIGNATURES), fn_name, dev, *args)


def _launch_fwd(q, k, v, causal, sm_scale, counts=None):
    shape, (q, k, v) = _operands("grouped flash attention kernel",
                                 [q, k, v], q, k, v)
    B, Hkv, G, Sq, Sk, D = shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hkv * G, Sq), dtype=torch.float32, device=q.device)
    _launch("gqa_fwd_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), *shape,
            int(causal), float(sm_scale * LOG2E), _DTYPE_CODE[q.dtype])
    (counts or grouped_flash_attention).launches_fwd += 1
    return out, lse


def _bwd_operands(q, k, v, do, lse, delta,
                  what="grouped flash attention backward kernel"):
    shape, ops = _operands(what, [q, k, v, do, lse.to(torch.float32),
                                  delta.to(torch.float32)], q, k, v, do)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    B, Hkv, G, Sq, _, _ = shape
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, Hkv * G, Sq):
            raise ValueError(f"{name} {tuple(t.shape)} must be "
                             f"{(B, Hkv * G, Sq)}")
    return shape, ops


def _launch_dq(q, k, v, do, lse, delta, causal, sm_scale, counts=None):
    shape, (q, k, v, do, lse, delta) = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("gqa_bwd_dq_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *shape, int(causal), float(sm_scale * LOG2E),
            float(sm_scale), _DTYPE_CODE[q.dtype])
    (counts or grouped_flash_attention).launches_dq += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale, counts=None):
    shape, (q, k, v, do, lse, delta) = _bwd_operands(q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("gqa_bwd_dkv_launch", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *shape, int(causal),
            float(sm_scale * LOG2E), float(sm_scale), _DTYPE_CODE[q.dtype])
    (counts or grouped_flash_attention).launches_dkv += 1
    return dk, dv


def _scale_of(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _device_kind(t, what="grouped flash attention"):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


# the entry points that own forward launch counts, by the name the op
# takes (flash_attention.py adds its own)
_OWNERS: dict = {}


@torch.library.custom_op("paddle_tpu_torch::gqa_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, sm_scale: float,
            counts: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator, ``paddle_tpu_torch::gqa_fwd``, so that
    a captured program (``jit``, ``torch.export``) keeps it as one node and
    runs the kernel when it runs. Its CPU implementation is the plain
    version; its CUDA implementation (below) the kernel's launch, which
    counts the launch on the entry point named ``counts``. Neither runs
    while a program is captured: the fake implementation gives the
    shapes."""
    return _gqa_fwd_plain(q, k, v, causal, sm_scale)


@_fwd_op.register_kernel("cuda")
def _fwd_op_cuda(q, k, v, causal, sm_scale, counts):
    return _launch_fwd(q, k, v, causal, sm_scale, _OWNERS[counts])


@_fwd_op.register_fake
def _fwd_op_fake(q, k, v, causal, sm_scale, counts):
    B, Hq, _, _, Sq, _, _ = _shapes(q, k, v)
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, Hq, Sq), dtype=torch.float32))


def gqa_fwd(q, k, v, causal=False, sm_scale=None, counts=None):
    """(out, lse) of the forward through the ``gqa_fwd`` operator: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. A
    launch is counted on ``counts`` (the entry point that owns it;
    ``grouped_flash_attention`` by default)."""
    sm_scale = _scale_of(q, sm_scale)
    _device_kind(q)
    owner = (counts or grouped_flash_attention).__name__
    return _fwd_op(q, k, v, bool(causal), float(sm_scale), owner)


def gqa_bwd(q, k, v, do, lse, delta, causal=False, sm_scale=None,
            counts=None):
    """(dq, dk, dv) from the forward's residuals and ``delta`` =
    rowsum(do * out) in f32: the dq kernel then the dkv kernel for CUDA
    tensors, the plain version for CPU tensors; launches counted as in
    ``gqa_fwd``."""
    sm_scale = _scale_of(q, sm_scale)
    if _device_kind(q) == "cpu":
        return _gqa_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, sm_scale, counts)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale, counts)
    return dq, dk, dv


class _GroupedFlashAttention(torch.autograd.Function):
    """Saves (q, k, v, out, lse), as the reference's custom_vjp does.
    ``fwd`` and ``bwd`` are the entry point's own forward and backward
    (``gqa_fwd`` / ``gqa_bwd`` here, their G = 1 form for
    ``flash_attention``), so each counts its own launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, fwd, bwd):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.bwd = causal, sm_scale, bwd
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.to(torch.float32) * out.to(torch.float32)).sum(-1)
        dq, dk, dv = ctx.bwd(q, k, v, do, lse, delta, ctx.causal,
                             ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def grouped_flash_attention(q, k, v, causal=False, sm_scale=None):
    """q (B, Hq, S, D); k/v (B, Hkv, S, D) with Hq = G * Hkv -> (B, Hq, S,
    D). Equal to attention over ``k/v.repeat_interleave(G, dim=1)`` without
    the repeat, differentiable in q, k and v. ``sm_scale`` defaults to
    1/sqrt(D)."""
    _shapes(q, k, v)
    return _GroupedFlashAttention.apply(q, k, v, bool(causal),
                                        float(_scale_of(q, sm_scale)),
                                        gqa_fwd, gqa_bwd)


grouped_flash_attention.launches_fwd = 0
grouped_flash_attention.launches_dq = 0
grouped_flash_attention.launches_dkv = 0
_OWNERS["grouped_flash_attention"] = grouped_flash_attention
