"""``linear``, ``embedding`` and ``dropout`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/functional/common.py`` (``linear``,
``:17``; ``embedding``, ``:30``; ``dropout``, ``:54``). The weight of ``linear`` is stored
(in, out), as in the reference and the port's Llama, and applied as
``x @ w``; a plain product is left to ``torch.matmul``, as the reference
leaves it to XLA. ``embedding`` is the reference's formula: take the
rows, then multiply the output by ``ids != padding_idx`` (so a padding
row that is not zero still reads as zero, and gets no gradient);
``sparse=True`` is refused. ``dropout`` takes the reference's arguments
in the reference's order (``p``, ``axis``, ``training``, ``mode``) and
draws its mask from a ``torch.Generator`` on x's device
(``core.generator``), given by keyword.
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
