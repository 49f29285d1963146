"""Int8 weights for the decode path: the per-output-channel codec and
the int8 x int8 -> int32 product.

Counterpart of ``quantize_stacked_jnp`` and ``int8_matmul`` in
``paddle_tpu/quantization/int8.py``, with the same order of operations
(f32 absmax, round half to even, clip to +-127, the int32 product
rescaled by ``sx * scale`` in f32, then cast to the activations' dtype),
so the int32 sums are exact and the results are the reference's bits.
The product is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card),
which on CUDA takes more than 16 rows and inner and outer sizes that are
multiples of 8: the quantized operands are padded with zero rows and
columns up to those sizes (zeros add nothing to an int32 sum) and the
result is sliced back.
"""
from __future__ import annotations

import torch

QMAX = 127


def quantize_stacked(w):
    """(..., in, out) weights, possibly layer-stacked: per-output-channel
    scales over the 'in' axis. Returns (q int8, scale f32 with the 'in'
    axis reduced away)."""
    wf = torch.as_tensor(w).to(torch.float32)
    scale = torch.clamp_min(wf.abs().amax(-2), 1e-8) / QMAX
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm(a, b):
    """Exact int32 product of int8 matrices a (M, K) and b (K, N)."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(32, _ceil(M, 8)), _ceil(K, 8), _ceil(N, 8)
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a, b)[:M, :N]


def int8_matmul(x, wq, scale, act_scale=None):
    """x (..., in) @ wq (in, out) int8. The activation scale is
    calibrated (``act_scale``) or the dynamic per-tensor absmax; the
    product accumulates in int32 and is rescaled to x's dtype."""
    xf = x.to(torch.float32)
    if act_scale is None:
        sx = torch.clamp_min(xf.abs().amax(), 1e-8) / QMAX
    else:
        sx = torch.as_tensor(act_scale, dtype=torch.float32,
                             device=x.device)
    xq = torch.clamp(torch.round(xf / sx), -QMAX, QMAX).to(torch.int8)
    lead = x.shape[:-1]
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), wq)
    acc = acc.reshape(*lead, wq.shape[-1])
    return (acc.to(torch.float32) * (sx * scale)).to(x.dtype)
