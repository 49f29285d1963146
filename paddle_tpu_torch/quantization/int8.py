"""Int8 weights and execution: the per-output-channel codec, the
int8 x int8 -> int32 product, and the ``Int8Linear`` deploy layer.

Counterpart of ``paddle_tpu/quantization/int8.py``
(``quantize_weight_per_channel``, ``quantize_stacked_jnp``,
``int8_matmul``, ``Int8Linear``, ``convert_to_int8``), with the same
order of operations (f32 absmax, round half to even, clip to +-127, the
int32 product rescaled by ``sx * scale`` in f32, then cast to the
activations' dtype), so the int32 sums are exact and the results are the
reference's bits. The reference computes the product with
``lax.dot_general`` outside any Pallas kernel (``:46-60``); here it is
``torch._int_mm`` (cuBLASLt's int8 GEMM on the card), which on CUDA takes
more than 16 rows and inner and outer sizes that are multiples of 8: the
quantized operands are padded with zero rows and columns up to those
sizes (zeros add nothing to an int32 sum) and the result is sliced back
(``_int_mm_padded``). A symbolic row count (a program exported with a
dynamic batch) is padded by a count the capture can prove nonnegative.

``convert_to_int8`` swaps ``nn.Linear`` sublayers; the reference also
converts its model-parallel Linears, whose int8 form the port does not
have yet (ROADMAP Queue 1 item 15): a sublayer of theirs is refused by
name.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layer.layers import Layer

QMAX = 127
# the model-parallel Linears, which the reference's convert_to_int8
# quantizes and the port's does not yet
_MP_LINEARS = ("ColumnParallelLinear", "RowParallelLinear")


def quantize_weight_per_channel(w, axis: int = 1):
    """int8 per-output-channel symmetric quantization (numpy).

    Returns (q_int8, scales) with scales shaped to broadcast along
    ``axis`` (the output-feature axis; 1 for (in, out) Linear weights).
    ~ fake_channel_wise_quantize_dequantize_abs_max.
    """
    w = np.asarray(w, np.float32)
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.maximum(np.abs(w).max(axis=red, keepdims=True), 1e-8)
    q = np.clip(np.round(w / amax * QMAX), -QMAX, QMAX).astype(np.int8)
    return q, (amax / QMAX).astype(np.float32)


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
    return _int_mm_padded(a, b)


def _int_mm_padded(a, b):
    """``torch._int_mm`` on a and b zero-padded to the sizes the card's
    takes: more than 16 rows, inner and outer sizes multiples of 8. A
    symbolic row count M gets (-M) % 8 + 32 rows, a padding the capture
    can prove nonnegative (with max(32, ceil8(M)) rows it cannot prove
    M <= the padded count, and the export fails)."""
    M, K = a.shape
    N = b.shape[1]
    Kp, Np = _ceil(K, 8), _ceil(N, 8)
    if isinstance(M, torch.SymInt):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, (-M) % 8 + 32))
    else:
        Mp = max(32, _ceil(M, 8))
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


class Int8Linear(Layer):
    """Linear with frozen int8 weights + int8 activations.

    The activation scale comes from calibration (static, preferred) or
    from the runtime abs-max when none was recorded (dynamic
    quantization)."""

    def __init__(self, linear, act_scale: float | None = None):
        super().__init__()
        w = linear.weight.detach()
        q, w_scale = quantize_weight_per_channel(
            w.to(torch.float32).cpu().numpy(), axis=1)
        self.register_buffer("weight_q", torch.from_numpy(q).to(w.device))
        self.register_buffer("weight_scale",
                             torch.from_numpy(w_scale).to(w.device))
        self.bias = linear.bias
        self.act_scale = act_scale
        self.in_features = linear.in_features
        self.out_features = linear.out_features

    def forward(self, x):
        # f32 in -> the product returns f32; the bias adds in f32 before
        # the cast to the caller's dtype
        out = int8_matmul(x.to(torch.float32), self.weight_q,
                          self.weight_scale[0], self.act_scale)
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype)


def convert_to_int8(model, act_scales: dict | None = None,
                    prefix: str = ""):
    """Swap ``nn.Linear`` sublayers for ``Int8Linear`` (~
    QuantizationFreezePass), in place; returns ``model``.

    ``act_scales`` maps sublayer path -> calibrated activation scale;
    layers without an entry fall back to dynamic activation
    quantization."""
    from ..nn import Linear
    act_scales = act_scales or {}
    for name, sub in list(model._modules.items()):
        if sub is None:
            continue
        path = f"{prefix}.{name}" if prefix else name
        if type(sub).__name__ in _MP_LINEARS:
            raise NotImplementedError(
                f"convert_to_int8: {path} is a {type(sub).__name__}; int8 "
                "of the model-parallel Linears is not ported yet (ROADMAP "
                "Queue 1 item 15)")
        if isinstance(sub, Linear):
            model._modules[name] = Int8Linear(
                sub, act_scale=act_scales.get(path))
        else:
            convert_to_int8(sub, act_scales, path)
    return model
