"""Fused softmax cross-entropy for the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas/fused_ce.py``. Its two TPU kernels
(``_ce_fwd_kernel``, ``_ce_bwd_kernel``) become ``kernels/fused_ce.cu``,
CUDA kernels written for Hopper and bound with ``ctypes``.
``softmax_cross_entropy`` is a ``torch.autograd.Function``; its forward
calls ``ce_fwd`` and its backward ``ce_bwd``, and each of those:

* launches the kernel for CUDA tensors, or raises;
* runs the plain PyTorch version (``_ce_fwd_plain``, ``_ce_bwd_plain``)
  for CPU tensors. Nothing else selects it.

A label outside [0, V) reads a label logit of 0, so its loss is the row's
lse and its gradient is the softmax alone, as in the reference kernels.
There is no ignore index. The reference's ``_fusable`` gate is the TPU
lowering's lane rule; the CUDA kernels take any (N, V).

Launch counts: ``softmax_cross_entropy.launches_fwd`` and
``.launches_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from .kernels import _build

_KERNEL = "fused_ce"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(logits, labels):
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"expected logits (N, V) and labels (N,); got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")


def _ce_fwd_plain(logits, labels):
    """The plain PyTorch version of the forward kernel: per-row lse in f32
    and loss = lse - x[label] (0 for a label outside [0, V))."""
    _check(logits, labels)
    V = logits.shape[1]
    x = logits.to(torch.float32)
    m = x.amax(-1)
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(-1))
    lbl = labels.long()
    valid = (lbl >= 0) & (lbl < V)
    picked = x.gather(1, lbl.clamp(0, V - 1)[:, None])[:, 0]
    label_logit = torch.where(valid, picked, torch.zeros_like(picked))
    return lse - label_logit, lse


def _ce_bwd_plain(logits, labels, lse, g):
    """The plain PyTorch version of the backward kernel:
    dx = (exp(x - lse) - onehot(label)) * g, in logits' dtype."""
    _check(logits, labels)
    V = logits.shape[1]
    p = torch.exp(logits.to(torch.float32) - lse.to(torch.float32)[:, None])
    lbl = labels.long()
    rows = torch.nonzero((lbl >= 0) & (lbl < V))[:, 0]
    p[rows, lbl[rows]] -= 1.0
    return p.mul_(g.to(torch.float32)[:, None]).to(logits.dtype)


_SIGNATURES = {
    "fused_ce_fwd_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
    "fused_ce_bwd_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3,
}


def _operands(logits, labels, *rows):
    """Check what the kernels take; logits and the per-row f32 operands
    made contiguous, labels as int64."""
    _check(logits, labels)
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused CE kernel: logits dtype {logits.dtype} "
                        "(use float32 or bfloat16)")
    if labels.dtype not in (torch.int32, torch.int64, torch.uint8,
                            torch.int16, torch.int8):
        raise TypeError(f"fused CE kernel: labels dtype {labels.dtype} "
                        "(use an integer type)")
    N, V = logits.shape
    if N >= 2 ** 31 or V >= 2 ** 31:
        raise ValueError(f"fused CE kernel: (N, V) = {(N, V)} too large")
    dev = logits.device
    if any(t.device != dev for t in (labels, *rows)):
        raise ValueError(f"fused CE kernel: every operand must lie on {dev}")
    return (logits.contiguous(), labels.to(torch.int64).contiguous(),
            *[t.to(torch.float32).contiguous() for t in rows])


def _launch(fn_name, dev, *args):
    _build.launch(_build.load(_KERNEL, _SIGNATURES), fn_name, dev, *args)


def _launch_fwd(logits, labels):
    x, lbl = _operands(logits, labels)
    N, V = x.shape
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    _launch("fused_ce_fwd_launch", x.device, x.data_ptr(), lbl.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), N, V, _DTYPE_CODE[x.dtype])
    softmax_cross_entropy.launches_fwd += 1
    return loss, lse


def _launch_bwd(logits, labels, lse, g):
    x, lbl, lse, g = _operands(logits, labels, lse, g)
    N, V = x.shape
    if lse.shape != (N,) or g.shape != (N,):
        raise ValueError(f"lse {tuple(lse.shape)} and g {tuple(g.shape)} "
                         f"must be ({N},)")
    dx = torch.empty_like(x)
    _launch("fused_ce_bwd_launch", x.device, x.data_ptr(), lbl.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dx.data_ptr(), N, V,
            _DTYPE_CODE[x.dtype])
    softmax_cross_entropy.launches_bwd += 1
    return dx


def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused CE: unsupported device {t.device}")
    return t.device.type


def ce_fwd(logits, labels):
    """(loss, lse), each (N,) f32: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if _device_kind(logits) == "cpu":
        return _ce_fwd_plain(logits, labels)
    return _launch_fwd(logits, labels)


def ce_bwd(logits, labels, lse, g):
    """dx (N, V) in logits' dtype for the upstream gradient g (N,): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if _device_kind(logits) == "cpu":
        return _ce_bwd_plain(logits, labels, lse, g)
    return _launch_bwd(logits, labels, lse, g)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """Saves (logits, labels, lse), as the reference's custom_vjp does."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = ce_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return ce_bwd(logits, labels, lse, g), None


def softmax_cross_entropy(logits, labels):
    """Per-token CE loss: logits (N, V), labels (N,) int -> (N,) f32,
    differentiable in the logits."""
    _check(logits, labels)
    return _SoftmaxCrossEntropy.apply(logits, labels)


softmax_cross_entropy.launches_fwd = 0
softmax_cross_entropy.launches_bwd = 0


def causal_lm_loss(logits, labels):
    """Mean CE over (B, S, V) logits against (B, S) labels, through the
    fused kernels."""
    B, S, V = logits.shape
    return softmax_cross_entropy(logits.reshape(B * S, V),
                                 labels.reshape(B * S)).mean()
