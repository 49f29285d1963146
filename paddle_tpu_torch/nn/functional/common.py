"""``linear``, ``embedding`` and ``dropout`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/common.py`` (``linear``,
``:17``; ``embedding``, ``:30``; ``dropout``, ``:54``). The weight of ``linear`` is stored
(in, out), as in the reference and the port's Llama, and applied as
``x @ w``; a plain product is left to ``torch.matmul``, as the reference
leaves it to XLA. ``embedding`` is the reference's formula: take the
rows, then multiply the output by ``ids != padding_idx`` (so a padding
row that is not zero still reads as zero, and gets no gradient);
``sparse=True`` is refused. ``dropout`` draws its mask from a ``torch.Generator``
on x's device (``core.generator``). Only the reference's default mode,
``upscale_in_train``, is ported, without ``axis``.
"""
from __future__ import annotations

import torch

from ...core.generator import torch_generator


def linear(x, weight, bias=None):
    """x (..., in) @ weight (in, out) (+ bias (out,))."""
    out = torch.matmul(x, weight)
    return out + bias if bias is not None else out


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` (num, dim) at the integer ids ``x`` -> (*x.shape,
    dim); rows at ``padding_idx`` are zeroed in the output."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True) (the SelectedRows gradient) is not "
            "ported yet: ROADMAP Queue 1 item 12")
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


def dropout(x, p=0.5, training=True, generator=None):
    """Zero each element with probability ``p`` and scale the rest by
    1 / (1 - p) (``upscale_in_train``); the identity when not training or
    at p = 0. ``generator``: a ``torch.Generator`` or the port's
    ``Generator`` (the default generator when None)."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1]; got {p}")
    if not training or p == 0.0:
        return x
    g = torch_generator(generator, x.device)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).to(x.dtype)
