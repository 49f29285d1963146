"""``cross_entropy`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/loss.py:24-67``, its hard-label
path: ``log_softmax`` over the last axis in the logits' dtype, the
label's log-probability picked (an ignored label picks class 0 and is
then zeroed), and ``reduction`` "mean" (over the labels not ignored, at
least 1), "sum" or "none". Labels may carry a trailing axis of 1, as in
the reference. Not ported yet, and refused: ``weight``, ``soft_label``,
``label_smoothing``, ``use_softmax=False`` and an ``axis`` other than
the last (ROADMAP Queue 1 item 12). It is the reference's plain formula,
not the fused CE kernel (``ops.fused_ce``): the reference's
``cross_entropy`` does not call its Pallas kernel either.
"""
from __future__ import annotations

import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """input (..., C) logits, label (...) or (..., 1) integer classes ->
    the loss, reduced by ``reduction``."""
    unported = {"weight": weight is not None, "soft_label": soft_label,
                "label_smoothing": label_smoothing > 0,
                "use_softmax=False": not use_softmax,
                f"axis={axis}": axis not in (-1, input.dim() - 1)}
    refused = [k for k, v in unported.items() if v]
    if refused:
        raise NotImplementedError(
            f"cross_entropy: {', '.join(refused)} not ported yet: ROADMAP "
            f"Queue 1 item 12")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none'; got "
                         f"{reduction!r}")
    logp = torch.log_softmax(input, dim=-1)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = torch.gather(logp, -1, safe[..., None]).squeeze(-1)
    nll = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return nll.sum() / valid.sum().to(nll.dtype).clamp_min(1.0)
    return nll.sum() if reduction == "sum" else nll
