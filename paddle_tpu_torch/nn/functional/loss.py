"""The losses of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/loss.py``: its 22 functions,
each the reference's formula operation for operation in plain torch (no
TPU kernel lies under any of them, and the reference's ``cross_entropy``
does not call its fused CE kernel either: ``ops.fused_ce`` is the Llama
path's), each through the op dispatch (``ops.dispatch``) under the
reference's op name. ``reduction`` is "mean", "sum" or "none" (the
reference returns the unreduced loss for any other word; the port's
``cross_entropy`` raises ValueError for one).

``cross_entropy``: ``log_softmax`` over ``axis`` in the logits' dtype
(``use_softmax=False``: the log of the input, floored at 1e-30), then hard
labels (an ignored label picks class 0 and is zeroed; a trailing axis of
1 is dropped; "mean" over the labels not ignored, at least 1, or with a
class ``weight`` over the picked weights) or ``soft_label``s, with
``label_smoothing``. ``ctc_loss`` is the alpha recursion of
``optax.ctc_loss``, which the reference calls (log-softmax of its input,
log-epsilon -1e5, the loss over each sequence's own lengths).
``hsigmoid_loss`` walks the default complete binary tree (class c's
path is the binary expansion of c + num_classes) or a custom
``path_table`` / ``path_code``.

Kept as the reference has them (ROADMAP Queue 3): ``nll_loss`` is
``cross_entropy(use_softmax=False)``, so it takes the log of its input
(probabilities, not log-probabilities); ``margin_cross_entropy``'s
``group`` and ``hsigmoid_loss``'s ``is_sparse`` are not read.
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply_op


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """input (..., C, ...) logits with classes on ``axis``; label the class
    ids (optionally with a trailing axis of 1) or, with ``soft_label``, a
    distribution of input's shape -> the loss, reduced by
    ``reduction``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none'; got "
                         f"{reduction!r}")
    return apply_op("cross_entropy", _cross_entropy, input, label, weight,
                    ignore_index=ignore_index, reduction=reduction,
                    soft_label=soft_label, axis=axis,
                    use_softmax=use_softmax, label_smoothing=label_smoothing)


def _cross_entropy(logits, lab, wv, ignore_index, reduction, soft_label,
                   axis, use_softmax, label_smoothing):
    axis = axis % logits.dim()
    logp = (torch.log_softmax(logits, axis) if use_softmax
            else torch.log(torch.clamp_min(logits, 1e-30)))
    n_classes = logits.shape[axis]
    if soft_label:
        soft = lab
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -torch.sum(soft * logp, axis)
        if wv is not None:
            loss = loss * torch.sum(soft * wv, axis)
        return _reduce(loss, reduction)
    lab_i = lab.long()
    if lab_i.dim() == logp.dim():
        lab_i = lab_i.squeeze(axis)
    valid = lab_i != ignore_index
    safe = torch.where(valid, lab_i, 0)
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        smooth_loss = -torch.mean(logp, axis)
        nll = -(1 - label_smoothing) * picked + label_smoothing * smooth_loss
    else:
        nll = -picked
    nll = torch.where(valid, nll, 0.0)
    if wv is not None:
        w = torch.where(valid, wv[safe], 0.0)
        nll = nll * w
        if reduction == "mean":
            return torch.sum(nll) / torch.clamp_min(torch.sum(w), 1e-12)
    if reduction == "mean":
        return torch.sum(nll) / torch.clamp_min(
            torch.sum(valid.to(nll.dtype)), 1.0)
    return _reduce(nll, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = apply_op("unsqueeze_loss", torch.unsqueeze, loss, axis)
    if return_softmax:
        return loss, apply_op("softmax", torch.softmax, logits, axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    return cross_entropy(input, label, weight=weight,
                         ignore_index=ignore_index, reduction=reduction,
                         use_softmax=False)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    def fn(p, y, w):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    return apply_op("binary_cross_entropy", fn, input, label, weight)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    def fn(z, y, w, pw):
        # numerically stable: max(z, 0) - z * y + log(1 + exp(-|z|))
        base = torch.clamp_min(z, 0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))
        if pw is not None:
            base = -(pw * y * -_softplus(-z) + (1 - y) * -_softplus(z))
        if w is not None:
            base = base * w
        return _reduce(base, reduction)
    return apply_op("bce_with_logits", fn, logit, label, weight, pos_weight)


def mse_loss(input, label, reduction="mean"):
    return apply_op("mse_loss",
                    lambda a, b: _reduce(torch.square(a - b), reduction),
                    input, label)


def l1_loss(input, label, reduction="mean"):
    return apply_op("l1_loss",
                    lambda a, b: _reduce(torch.abs(a - b), reduction),
                    input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    def fn(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(loss, reduction)
    return apply_op("smooth_l1_loss", fn, input, label)


def huber_loss(input, label, delta=1.0, reduction="mean"):
    def fn(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d <= delta, 0.5 * d * d,
                           delta * (d - 0.5 * delta))
        return _reduce(loss, reduction)
    return apply_op("huber_loss", fn, input, label)


def kl_div(input, label, reduction="mean"):
    def fn(logp, y):
        loss = y * (torch.log(torch.clamp_min(y, 1e-30)) - logp)
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)
    return apply_op("kl_div", fn, input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    def fn(a, b, y):
        return _reduce(torch.clamp_min(-y * (a - b) + margin, 0.0),
                       reduction)
    return apply_op("margin_ranking_loss", fn, input, other, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    def fn(x, y):
        loss = torch.where(y == 1, x, torch.clamp_min(margin - x, 0.0))
        return _reduce(loss, reduction)
    return apply_op("hinge_embedding_loss", fn, input, label)


def _norm(x, p=2):
    return torch.linalg.vector_norm(x, ord=p, dim=-1)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    def fn(a, b, y):
        cos = torch.sum(a * b, -1) / torch.clamp_min(_norm(a) * _norm(b),
                                                     1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
        return _reduce(loss, reduction)
    return apply_op("cosine_embedding_loss", fn, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def fn(a, pos, neg):
        dp = _norm(a - pos + epsilon, p)
        dn = _norm(a - neg + epsilon, p)
        if swap:
            dn = torch.minimum(dn, _norm(pos - neg + epsilon, p))
        return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)
    return apply_op("triplet_margin_loss", fn, input, positive, negative)


def log_loss(input, label, epsilon=1e-4):
    def fn(p, y):
        return -(y * torch.log(p + epsilon)
                 + (1 - y) * torch.log(1 - p + epsilon))
    return apply_op("log_loss", fn, input, label)


def square_error_cost(input, label):
    return apply_op("square_error_cost",
                    lambda a, b: torch.square(a - b), input, label)


_LOG_EPSILON = -1e5


def _ctc(logits, logit_pad, labels, label_pad, blank):
    """Per-sequence CTC loss: the alpha recursion of
    ``optax.ctc_loss`` over (B, T, C) logits and paddings (1.0 =
    padding)."""
    B, T, C = logits.shape
    N = labels.shape[1]
    eps = _LOG_EPSILON
    logprobs = torch.log_softmax(logits, -1)
    labellens = N - torch.sum(label_pad, 1).long()
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = TF.pad(repeat, (0, 1))
    logprobs_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)
    one_hot = TF.one_hot(labels.long(), C).to(logits.dtype)
    logprobs_emit = torch.einsum("btk,bnk->btn", logprobs,
                                 one_hot).transpose(0, 1)
    phi = torch.full((B, N + 1), eps, dtype=logits.dtype,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], -1)
    emit = torch.full((B, N), eps, dtype=logits.dtype, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], -1)

    pads = logit_pad.transpose(0, 1)
    for t in range(T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + eps * repeat)
        lp_emit, lp_phi = logprobs_emit[t], logprobs_phi[t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi,
                              emit + lp_phi + eps * (1.0 - repeat))
        pad = pads[t].reshape(B, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    sel = TF.one_hot(labellens, N + 1).to(logits.dtype)
    return -torch.einsum("bn,bn->b", last, sel)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """log_probs (T, B, C), labels (B, N) -> the loss over each sequence's
    first ``input_lengths`` steps and ``label_lengths`` labels."""
    def fn(lp, lab):
        logits = lp.transpose(0, 1)
        B, T, _ = logits.shape
        ilen = torch.as_tensor(input_lengths, device=lp.device)
        llen = torch.as_tensor(label_lengths, device=lp.device)
        logit_pad = (torch.arange(T, device=lp.device)[None, :]
                     >= ilen[:, None]).to(torch.float32)
        lab_pad = (torch.arange(lab.shape[1], device=lp.device)[None, :]
                   >= llen[:, None]).to(torch.float32)
        loss = _ctc(logits, logit_pad, lab, lab_pad, blank)
        if norm_by_times:
            loss = loss / torch.clamp_min(ilen.to(loss.dtype), 1.0)
        return _reduce(loss, reduction)
    return apply_op("ctc_loss", fn, log_probs, labels)


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2|X∩Y| / (|X| + |Y|) over each sample's map, the integer
    labels one-hot over the last (class) axis."""
    def fn(x, lab):
        lab = TF.one_hot(lab.squeeze(-1).long(), x.shape[-1]).to(x.dtype)
        dims = tuple(range(1, x.dim()))
        inter = 2.0 * torch.sum(x * lab, dims)
        union = torch.sum(x, dims) + torch.sum(lab, dims)
        return torch.mean(1.0 - (inter + epsilon) / (union + epsilon))
    return apply_op("dice_loss", fn, input, label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """The improved N-pair metric loss."""
    def fn(a, p, lab):
        lab = lab.to(a.dtype).reshape(-1, 1)
        same = (lab == lab.T).to(a.dtype)
        target = same / torch.sum(same, 1, keepdim=True)
        logits = a @ p.T
        ce = torch.mean(torch.sum(-target * torch.log_softmax(logits, 1),
                                  1))
        reg = l2_reg * (torch.mean(torch.sum(a * a, 1))
                        + torch.mean(torch.sum(p * p, 1))) * 0.25
        return ce + reg
    return apply_op("npair_loss", fn, anchor, positive, labels)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    """RetinaNet's focal loss."""
    def fn(x, y, norm):
        y = y.to(x.dtype)
        p = torch.sigmoid(x)
        ce = torch.clamp_min(x, 0) - x * y \
            + torch.log1p(torch.exp(-torch.abs(x)))
        p_t = p * y + (1 - p) * (1 - y)
        loss = ce * ((1 - p_t) ** gamma)
        if alpha >= 0:
            loss = loss * (alpha * y + (1 - alpha) * (1 - y))
        if norm is not None:
            loss = loss / norm
        return _reduce(loss, reduction)
    return apply_op("sigmoid_focal_loss", fn, logit, label, normalizer)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid over a class tree whose inner nodes are the
    rows of ``weight`` -> (B, 1)."""
    def fn(x, lab, w, b):
        depth = max(1, int(np.ceil(np.log2(max(2, num_classes)))))
        lab = lab.reshape(-1).long()
        if path_table is not None:
            pt = torch.as_tensor(path_table, device=x.device).long()
            pc = torch.as_tensor(path_code, device=x.device)
            nodes = pt[lab]
            codes = pc[lab].to(x.dtype)
            valid = (nodes >= 0).to(x.dtype)
            nodes = torch.clamp_min(nodes, 0)
        else:
            h = lab + num_classes
            levels, codes_l = [], []
            for _ in range(depth):
                codes_l.append((h % 2).to(x.dtype))
                h = h // 2
                levels.append(h)
            nodes = torch.stack(levels[::-1], 1) - 1
            codes = torch.stack(codes_l[::-1], 1)
            valid = ((nodes >= 0) & (nodes < w.shape[0])).to(x.dtype)
            nodes = torch.clamp(nodes, 0, w.shape[0] - 1)
        logits = torch.einsum("bdf,bf->bd", w[nodes], x)
        if b is not None:
            logits = logits + b.reshape(-1)[nodes]
        # code 1: the right branch; loss = softplus(-sign * logit)
        z = (1.0 - 2.0 * codes) * logits
        loss = torch.clamp_min(-z, 0) + torch.log1p(torch.exp(-torch.abs(z)))
        return torch.sum(loss * valid, 1, keepdim=True)
    return apply_op("hsigmoid_loss", fn, input, label, weight, bias)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: the target logit (a cosine) becomes
    cos(margin1 * theta + margin2) - margin3, all scaled by ``scale``."""
    def fn(x, lab):
        lab = lab.reshape(-1).long()
        theta = torch.arccos(torch.clamp(x, -1.0, 1.0))
        tgt = torch.cos(margin1 * theta + margin2) - margin3
        onehot = TF.one_hot(lab, x.shape[-1]).to(x.dtype)
        adj = torch.where(onehot > 0, tgt, x) * scale
        loss = -torch.sum(onehot * torch.log_softmax(adj, -1), -1,
                          keepdim=True)
        loss_r = _reduce(loss, reduction)
        if return_softmax:
            return loss_r, torch.softmax(adj, -1)
        return loss_r
    return apply_op("margin_cross_entropy", fn, logits, label)
