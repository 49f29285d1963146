"""Fused LayerNorm and RMSNorm for the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas/layer_norm.py``:
``fused_layer_norm`` (``:53``) and ``fused_rms_norm`` (``:75``), whose TPU
kernels ``_ln_kernel`` (``:27``) and ``_rms_kernel`` (``:37``) become
``kernels/layer_norm.cu``, CUDA kernels written for Hopper and bound with
``ctypes`` (the same source holds the dropout-add-LayerNorm kernel of
``dropout_ln.py``). Each function:

* launches the kernel for CUDA tensors, or raises;
* runs the plain PyTorch version (``_ln_plain``, ``_rms_plain``) for CPU
  tensors. Nothing else selects it.

Both take x (..., H) and weights (H,); statistics are f32 whatever x's
dtype, the weight (and bias) are taken to f32 and multiplied before the
one cast back to x's dtype. Forward only, as in the reference, where
differentiating the kernels fails: asking for a gradient raises.

These are entry points of their own. No layer calls them: ``nn.LayerNorm``
and ``nn.RMSNorm`` keep the reference's own formulas
(``nn/functional/norm.py``, ``nn/layer/norm.py``), which round elsewhere
in bfloat16.

Not ported, on purpose: ``_rows_block`` and ``BLOCK_ROWS``, the TPU's
VMEM tiling; the kernels take every row count and every H.

Launch counts: ``fused_layer_norm.launches`` and
``fused_rms_norm.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .kernels import _build

_KERNEL = "layer_norm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "layer_norm_launch": [_PTR] * 4 + [_I32, _I32, _F32, _I32, _I32],
    "rms_norm_launch": [_PTR] * 3 + [_I32, _I32, _F32, _I32, _I32],
    "dropout_add_ln_launch": [_PTR] * 6 + [_I32, _I32, _F32, _F32, _F32,
                                           _I32, _I32, _I32],
}


def _rows(x, weight, *more):
    """x as (R, H) and H, or ValueError when a weight is not (H,)."""
    if x.dim() < 1:
        raise ValueError("expected x (..., H); got a scalar")
    H = x.shape[-1]
    for t in (weight, *more):
        if tuple(t.shape) != (H,):
            raise ValueError(f"weight and bias must be ({H},); got "
                             f"{tuple(t.shape)}")
    return x.reshape(-1, H), H


def _refuse_grad(what, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no gradient (forward only, as the "
                           "reference's kernel)")


def _ln_plain(x, weight, bias, eps=1e-5):
    """The plain PyTorch version of the LayerNorm kernel."""
    x2, _ = _rows(x, weight, bias)
    xf = x2.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype).reshape(x.shape)


def _rms_plain(x, weight, eps=1e-6):
    """The plain PyTorch version of the RMSNorm kernel."""
    x2, _ = _rows(x, weight)
    xf = x2.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    y = y * weight.to(torch.float32)
    return y.to(x.dtype).reshape(x.shape)


def _checked(what, x2, weight, *more):
    """Check what the kernels take: x2 (R, H) and the weight (and bias)
    in float32 or bfloat16, the weights of one dtype, every operand on
    x2's device. Returns (the operands made contiguous, the weight's dtype
    code); raises on what the kernels do not take."""
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: x dtype {x2.dtype} (use float32 or "
                        "bfloat16)")
    if weight.dtype not in _DTYPE_CODE or any(t.dtype != weight.dtype
                                              for t in more):
        raise TypeError(f"{what}: weight and bias must share one dtype, "
                        f"float32 or bfloat16; got {weight.dtype}"
                        + "".join(f", {t.dtype}" for t in more))
    if max(x2.shape) >= 2 ** 31:
        raise ValueError(f"{what}: (rows, H) = {tuple(x2.shape)} too large")
    if any(t.device != x2.device for t in (weight, *more)):
        raise ValueError(f"{what}: every operand must lie on {x2.device}")
    return ([t.contiguous() for t in (x2, weight, *more)],
            _DTYPE_CODE[weight.dtype])


def launch(fn_name, dev, *args):
    """Call an entry point of ``kernels/layer_norm.cu`` on ``dev``'s
    current stream; raises on a CUDA error."""
    _build.launch(_build.load(_KERNEL, _SIGNATURES), fn_name, dev, *args)


def _device_kind(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def fused_layer_norm(x, weight, bias, eps=1e-5):
    """x (..., H), weight/bias (H,) -> LayerNorm of each row in x's
    dtype: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    what = "fused_layer_norm"
    _refuse_grad(what, x, weight, bias)
    if _device_kind(x, what) == "cpu":
        return _ln_plain(x, weight, bias, eps)
    x2, H = _rows(x, weight, bias)
    (x2, w, b), wcode = _checked(what, x2, weight, bias)
    out = torch.empty_like(x2)
    if x2.shape[0]:
        launch("layer_norm_launch", x.device, x2.data_ptr(), w.data_ptr(),
               b.data_ptr(), out.data_ptr(), x2.shape[0], H, float(eps),
               _DTYPE_CODE[x.dtype], wcode)
        fused_layer_norm.launches += 1
    return out.reshape(x.shape)


def fused_rms_norm(x, weight, eps=1e-6):
    """x (..., H), weight (H,) -> RMSNorm of each row in x's dtype: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    what = "fused_rms_norm"
    _refuse_grad(what, x, weight)
    if _device_kind(x, what) == "cpu":
        return _rms_plain(x, weight, eps)
    x2, H = _rows(x, weight)
    (x2, w), wcode = _checked(what, x2, weight)
    out = torch.empty_like(x2)
    if x2.shape[0]:
        launch("rms_norm_launch", x.device, x2.data_ptr(), w.data_ptr(),
               out.data_ptr(), x2.shape[0], H, float(eps),
               _DTYPE_CODE[x.dtype], wcode)
        fused_rms_norm.launches += 1
    return out.reshape(x.shape)


fused_layer_norm.launches = 0
fused_rms_norm.launches = 0
