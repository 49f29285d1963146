"""Fused dropout + residual-add + LayerNorm for the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas/dropout_ln.py``: the transformer's
post-LN epilogue ``ln(residual + dropout(x))`` in one pass. Its TPU
kernel ``_kernel`` (``:28``, launched by ``_pallas_forward``, ``:118``)
becomes ``dropout_add_ln_launch`` of ``kernels/layer_norm.cu``, a CUDA
kernel written for Hopper and bound with ``ctypes``; the reference's
dense fallback for a ragged N (``:121-130``) computes the same function,
and the CUDA kernel takes every N, so the card has no such branch.

``fused_dropout_add_layer_norm`` is a ``torch.autograd.Function`` in
place of the reference's ``custom_vjp`` ``_core`` (``:45-89``). Its
forward (``dropout_add_ln_fwd``):

* launches the kernel for CUDA tensors, or raises;
* runs ``_forward_plain`` for CPU tensors. Nothing else selects it.

Its backward is ``_core_bwd`` (``:61-86``) in plain PyTorch, operation for
operation, on either device: the reference has no backward kernel.

Dropout randomness comes in as uint32 bits (N, H), as in the reference:
keep an element when f32(bits) / 2^32 >= p, the bits read as unsigned and
rounded to nearest; a kept element is scaled as ``x * keep / (1 - p)``
in the forward and as ``x * (keep / (1 - p))`` in the backward, the two
roundings the reference has. The bits may be given as a uint32 tensor or
as an int32 one holding the same bits (it is reinterpreted, never
converted). Without bits, a training call with p > 0 draws them from a
``torch.Generator`` on the tensor's device (``core.generator``); an eval
call, or p = 0, reads none.

Launch count: ``fused_dropout_add_layer_norm.launches``.
"""
from __future__ import annotations

import torch

from ..core.generator import torch_generator
from .layer_norm import _DTYPE_CODE, _checked, _device_kind, launch

_TWO_POW_32 = 4294967296.0


def _as_bits(bits, shape):
    """``bits`` as an int32 tensor of ``shape`` holding the same 32 bits
    (a uint32 tensor is viewed, not converted)."""
    if bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    if bits.dtype != torch.int32:
        raise TypeError(f"dropout bits must be uint32 (or int32 holding "
                        f"the same bits); got {bits.dtype}")
    if bits.numel() != shape[0] * shape[1]:
        raise ValueError(f"dropout bits {tuple(bits.shape)} must have "
                         f"{shape[0]} x {shape[1]} elements")
    return bits.reshape(shape)


def _uniform(bits):
    """u = f32(bits read as unsigned) / 2^32, as the reference computes
    it: through int64, so bits from 2^31 up stay positive, then to f32
    with rounding to nearest (bits near 2^32 give u = 1.0)."""
    return (bits.to(torch.int64) & 0xFFFFFFFF).to(torch.float32) \
        / _TWO_POW_32


def _dropping(p, training):
    return training and p > 0.0


def _forward_plain(x2, r2, weight, bias, bits, p, eps, training):
    """The plain PyTorch version of the kernel, the reference's ``_kernel``
    as written: (N, H) in, (N, H) out in x's dtype."""
    xf = x2.to(torch.float32)
    if _dropping(p, training):
        keep = (_uniform(bits) >= p).to(torch.float32)
        # a device scalar, so the card divides as the reference does
        # (a Python scalar would become a multiply by its reciprocal)
        xf = xf * keep / torch.tensor(1.0 - p, dtype=torch.float32,
                                      device=xf.device)
    h = xf + r2.to(torch.float32)
    mu = h.mean(-1, keepdim=True)
    hc = h - mu
    var = (hc * hc).mean(-1, keepdim=True)
    y = hc * torch.rsqrt(var + eps)
    y = y * weight.to(torch.float32) + bias.to(torch.float32)
    return y.to(x2.dtype)


def _backward_plain(g, x2, r2, weight, bits, p, eps, training):
    """The reference's ``_core_bwd``: the closed-form LayerNorm gradient,
    recomputing h, mu and rsig from the saved inputs. Returns (dx, dres,
    dw, db) in the dtypes of x, residual and weight."""
    f32 = torch.float32
    gf = g.to(f32)
    xf = x2.to(f32)
    keep = None
    if _dropping(p, training):
        keep = (_uniform(bits) >= p).to(f32) / (1.0 - p)
        xf = xf * keep
    h = xf + r2.to(f32)
    mu = h.mean(-1, keepdim=True)
    hc = h - mu
    rsig = torch.rsqrt((hc * hc).mean(-1, keepdim=True) + eps)
    yhat = hc * rsig
    wg = gf * weight.to(f32)
    dh = (wg - wg.mean(-1, keepdim=True)
          - yhat * (wg * yhat).mean(-1, keepdim=True)) * rsig
    dw = (gf * yhat).sum(0).to(weight.dtype)
    db = gf.sum(0).to(weight.dtype)
    dres = dh.to(r2.dtype)
    dx = (dh * keep if keep is not None else dh).to(x2.dtype)
    return dx, dres, dw, db


def _launch_forward(x2, r2, weight, bias, bits, p, eps, training):
    what = "dropout-add-LayerNorm kernel"
    (x2, weight, bias), wcode = _checked(what, x2, weight, bias)
    if r2.dtype != x2.dtype:
        raise TypeError(f"{what}: residual dtype {r2.dtype} must be x's, "
                        f"{x2.dtype}")
    drop = _dropping(p, training)
    if any(t.device != x2.device for t in [r2] + ([bits] if drop else [])):
        raise ValueError(f"{what}: every operand must lie on {x2.device}")
    r2 = r2.contiguous()
    bits = bits.contiguous() if drop else None
    N, H = x2.shape
    out = torch.empty_like(x2)
    if N:
        launch("dropout_add_ln_launch", x2.device, x2.data_ptr(),
               r2.data_ptr(), bits.data_ptr() if drop else None,
               weight.data_ptr(), bias.data_ptr(), out.data_ptr(), N, H,
               float(p), float(1.0 - p), float(eps), int(drop),
               _DTYPE_CODE[x2.dtype], wcode)
        fused_dropout_add_layer_norm.launches += 1
    return out


def dropout_add_ln_fwd(x2, r2, weight, bias, bits, p, eps, training):
    """LN(r2 + dropout(x2)) over (N, H) operands: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``bits`` (int32, (N, H))
    is read only when training with p > 0."""
    if _device_kind(x2, "dropout-add-LayerNorm") == "cpu":
        return _forward_plain(x2, r2, weight, bias, bits, p, eps, training)
    return _launch_forward(x2, r2, weight, bias, bits, p, eps, training)


class _DropoutAddLayerNorm(torch.autograd.Function):
    """Saves (x, residual, weight, bits), as the reference's ``_core_fwd``
    does; no gradient for the bits."""

    @staticmethod
    def forward(ctx, x2, r2, weight, bias, bits, p, eps, training):
        out = dropout_add_ln_fwd(x2, r2, weight, bias, bits, p, eps,
                                 training)
        ctx.save_for_backward(x2, r2, weight, bits)
        ctx.p, ctx.eps, ctx.training = p, eps, training
        return out

    @staticmethod
    def backward(ctx, g):
        x2, r2, weight, bits = ctx.saved_tensors
        dx, dres, dw, db = _backward_plain(g, x2, r2, weight, bits, ctx.p,
                                           ctx.eps, ctx.training)
        return dx, dres, dw, db, None, None, None, None


def fused_dropout_add_layer_norm(x, residual, weight, bias, p=0.1,
                                 eps=1e-5, training=True, bits=None,
                                 generator=None):
    """x, residual (..., H); weight, bias (H,). Returns
    LayerNorm(residual + dropout(x)) in x's dtype, differentiable in x,
    residual, weight and bias.

    ``bits``: optional uint32 (or int32) tensor of x's size, the dropout
    randomness; when None and training with p > 0, drawn from
    ``generator`` (a ``torch.Generator``, or the port's ``Generator``; the
    default generator when None) on x's device."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1); got {p}")
    H = x.shape[-1]
    if residual.shape != x.shape or tuple(weight.shape) != (H,) \
            or tuple(bias.shape) != (H,):
        raise ValueError(f"expected x and residual of one shape (..., H) "
                         f"and weight, bias (H,); got {tuple(x.shape)}, "
                         f"{tuple(residual.shape)}, {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    x2 = x.reshape(-1, H)
    r2 = residual.reshape(-1, H)
    N = x2.shape[0]
    p, eps, training = float(p), float(eps), bool(training)
    if not _dropping(p, training):
        bits = None
    elif bits is None:
        bits = torch.empty((N, H), dtype=torch.int32, device=x.device) \
            .random_(-2 ** 31, 2 ** 31,
                     generator=torch_generator(generator, x.device))
    else:
        bits = _as_bits(bits, (N, H))
    out = _DropoutAddLayerNorm.apply(x2, r2, weight, bias, bits, p, eps,
                                     training)
    return out.reshape(x.shape)


fused_dropout_add_layer_norm.launches = 0
