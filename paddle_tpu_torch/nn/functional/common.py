"""``linear``, ``embedding``, ``dropout`` and ``gather_tree`` of the
PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/common.py`` (``linear``,
``:17``; ``embedding``, ``:30``; ``dropout``, ``:54``). The weight of
``linear`` is stored (in, out), as in the reference and the port's Llama,
and applied as ``x @ w``; a plain product is left to ``torch.matmul``, as
the reference leaves it to XLA, through ``ops.linalg.matmul``, which
promotes mixed dtypes as ``jnp.matmul`` does. ``embedding`` is the
reference's formula: take the rows, then multiply the output by ``ids !=
padding_idx`` (so a padding row that is not zero still reads as zero, and
gets no gradient); with ``sparse=True`` the weight's gradient is a
sparse COO tensor holding the looked-up rows (torch's sparse embedding
gradient, the reference's ``SelectedRows``), without the padding ids'
rows, as the reference drops them (``_internal_sparse_embed.py:38-48``),
and the lookup is not a dispatched op, as there. ``dropout`` takes the
reference's arguments in the reference's order (``p``, ``axis``,
``training``, ``mode``) and draws its mask from a ``torch.Generator`` on
x's device (``core.generator``), given by keyword. Each goes through
the op dispatch (``ops.dispatch``) under the reference's op name.
"""
from __future__ import annotations

import torch

from ...core.generator import torch_generator
from ...ops.dispatch import apply_op
from ...ops.linalg import matmul


def _linear(x, weight, bias):
    out = matmul(x, weight)
    return out + bias if bias is not None else out


def linear(x, weight, bias=None):
    """x (..., in) @ weight (in, out) (+ bias (out,))."""
    return apply_op("linear", _linear, x, weight, bias)


def _embedding(x, weight, padding_idx, sparse=False):
    pad = padding_idx if sparse and padding_idx is not None and \
        0 <= padding_idx < weight.shape[0] else None
    out = torch.nn.functional.embedding(x, weight, padding_idx=pad,
                                        sparse=sparse)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` (num, dim) at the integer ids ``x`` -> (*x.shape,
    dim); rows at ``padding_idx`` are zeroed in the output."""
    if sparse:
        return _embedding(x, weight, padding_idx, sparse=True)
    return apply_op("embedding", _embedding, x, weight,
                    padding_idx=padding_idx)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            *, generator=None):
    """Zero elements with probability ``p``. ``axis`` (an int or a list of
    ints): one keep decision per index of those axes, shared over the
    others (the mask has the shape of x with every other axis 1); None:
    one per element. ``mode="upscale_in_train"`` scales the kept elements
    by 1 / (1 - p) in training and is the identity otherwise;
    ``"downscale_in_infer"`` keeps them unscaled in training and returns
    x * (1 - p) otherwise. p = 0 returns x. ``generator``: a
    ``torch.Generator`` or the port's ``Generator`` (the default
    generator when None)."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1]; got {p}")
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError("mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer'; got {mode!r}")
    if p == 0.0:
        return x
    if not training:
        return x if mode == "upscale_in_train" else (x * (1.0 - p)).to(
            x.dtype)
    return apply_op("dropout", _dropout, x, p=p, axis=axis, mode=mode,
                    generator=generator)


def _dropout(x, p, axis, mode, generator):
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    g = torch_generator(generator, x.device)
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept,
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).to(x.dtype)


def _gather_tree(ids, parents):
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        outs[t] = torch.gather(ids[t], 1, beams)
        beams = torch.gather(parents[t], 1, beams).long()
    return torch.stack(outs)


def gather_tree(ids, parents):
    """Whole beam-search sequences from per-step ids and parents, both
    (max_time, batch, beam): from the last step back, each slot follows
    its parent pointer (``paddle_tpu/nn/functional/common.py:363``). The
    op ``gather_tree``; no gradient."""
    return apply_op("gather_tree", _gather_tree, ids, parents, nondiff=True)
