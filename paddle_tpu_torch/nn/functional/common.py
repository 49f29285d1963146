"""The common functions of ``nn.functional`` in the PyTorch port.

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

The rest (``paddle_tpu/nn/functional/common.py:75-360``) keep the
reference's formulas, its traps included (README, the reference's
traps):

* ``interpolate`` computes ``jax.image.resize``'s function, which is not
  ``torch.nn.functional.interpolate``'s: "nearest" takes input index
  floor((i + 0.5) * in / out) (half-pixel centres); "linear" /
  "bilinear" / "trilinear" and "area" are the triangle kernel and
  "bicubic" Keys' cubic (a = -0.5), each sampled at half-pixel centres,
  widened by in / out when shrinking (antialiased), its weights
  normalised to sum 1 and zero for a sample outside the input;
  ``align_mode`` is never read; ``align_corners=True`` (any mode but
  "nearest") is the linear gather at corner-aligned coordinates, for
  "bicubic" too;
* ``pad`` pairs its list with the spatial axes first to last (the op
  ``pad`` of ``ops.manipulation``);
* ``pixel_unshuffle`` and ``channel_shuffle`` read channel-first input
  whatever ``data_format`` says;
* ``one_hot`` gives a zero row for an id outside [0, num_classes);
* ``class_center_sample`` draws its negative classes from the default
  generator (torch's draws, not JAX's).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.dtype import convert_dtype, x32
from ...core.generator import torch_generator
from ...ops.dispatch import apply_op
from ...ops.linalg import matmul
from ...ops.manipulation import pad as _pad_op


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


def dropout2d(x, p=0.5, training=True, data_format="NCHW", *,
              generator=None):
    """``dropout`` of whole channels: one decision per (sample,
    channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", *,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_dropout(x, p, generator):
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    g = torch_generator(generator, x.device)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    a = 1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                                device=x.device))
            + b).to(x.dtype)


def alpha_dropout(x, p=0.5, training=True, *, generator=None):
    """SELU's dropout: a dropped element becomes -alpha * scale, then all
    are scaled and shifted to keep the mean and variance."""
    if not training or p == 0.0:
        return x
    return apply_op("alpha_dropout", _alpha_dropout, x, p=p,
                    generator=generator)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """The op ``pad`` (``ops.manipulation.pad``)."""
    return _pad_op(x, pad=pad, mode=mode, value=value,
                   data_format=data_format)


def _sizes_out(x, size, scale_factor, channel_last):
    n_spatial = x.dim() - 2
    in_spatial = list(x.shape[1:-1]) if channel_last else list(x.shape[2:])
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        return in_spatial, [int(s) for s in size]
    if isinstance(scale_factor, (int, float)):
        scale_factor = [scale_factor] * n_spatial
    return in_spatial, [int(np.floor(s * f))
                        for s, f in zip(in_spatial, scale_factor)]


def _triangle(d):
    return torch.clamp_min(1 - torch.abs(d), 0)


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(d), out)


def _resize_weights(m, n, kernel, device):
    """(m, n) float32 weights taking m input samples to n output samples:
    ``jax.image.resize``'s ``compute_weight_mat`` with antialias."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    d = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = kernel(d)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), w / torch.where(total != 0, total, 1.0),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _interpolate(x, out_spatial, mode, align_corners, channel_last):
    n = len(out_spatial)
    axes = list(range(1, 1 + n)) if channel_last else list(range(2, 2 + n))
    out = x
    if mode == "nearest":
        for ax, osz in zip(axes, out_spatial):
            isz = out.shape[ax]
            if isz == osz:
                continue
            idx = torch.floor((torch.arange(osz, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * isz / osz).long()
            out = out.index_select(ax, idx)
        return out
    if not align_corners:
        kernel = _keys_cubic if mode == "bicubic" else _triangle
        if not out.is_floating_point():
            out = out.to(torch.float32)
        for ax, osz in zip(axes, out_spatial):
            isz = out.shape[ax]
            if isz == osz:
                continue
            w = _resize_weights(isz, osz, kernel, x.device).to(out.dtype)
            out = torch.movedim(torch.tensordot(out, w, dims=([ax], [0])),
                                -1, ax)
        return out.to(x.dtype)
    for ax, osz in zip(axes, out_spatial):
        isz = out.shape[ax]
        if osz == 1 or isz == 1:
            idx = torch.zeros(osz, dtype=torch.float32, device=x.device)
        else:
            idx = torch.linspace(0.0, isz - 1.0, osz, dtype=torch.float32,
                                 device=x.device)
        lo = torch.floor(idx).long()
        hi = torch.clamp_max(lo + 1, isz - 1)
        shape = [1] * out.dim()
        shape[ax] = osz
        w = (idx - lo).to(out.dtype).reshape(shape)
        out = (out.index_select(ax, lo) * (1 - w)
               + out.index_select(ax, hi) * w)
    return out.to(x.dtype)


_RESIZE_MODES = ("nearest", "bilinear", "linear", "trilinear", "bicubic",
                 "area")


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """Resize the spatial axes to ``size``, or to floor(in *
    ``scale_factor``), by the reference's function (module docstring)."""
    if mode not in _RESIZE_MODES:
        raise KeyError(mode)
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    _, out_spatial = _sizes_out(x, size, scale_factor, channel_last)
    # "area" is the antialiased linear resize, as in the reference
    mode = "linear" if mode in ("bilinear", "trilinear", "area") else mode
    return apply_op("interpolate", _interpolate, x, out_spatial=out_spatial,
                    mode=mode, align_corners=align_corners,
                    channel_last=channel_last)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a)
                                                             for a in v)


def _unfold(x, kh, kw, sh, sw, dh, dw, ph0, ph1, pw0, pw1):
    N, C, H, W = x.shape
    xp = torch.nn.functional.pad(x, (pw0, pw1, ph0, ph1))
    oh = (H + ph0 + ph1 - (dh * (kh - 1) + 1)) // sh + 1
    ow = (W + pw0 + pw1 - (dw * (kw - 1) + 1)) // sw + 1
    patches = [xp[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                  j * dw:j * dw + (ow - 1) * sw + 1:sw]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, 2).reshape(N, C * kh * kw, oh * ow)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of NCHW ``x``: (N, C * kh * kw, L) in the reference's
    order; ``paddings`` an int, (h, w), or (top, left, bottom, right)."""
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    if isinstance(paddings, int):
        ph0 = ph1 = pw0 = pw1 = paddings
    elif len(paddings) == 2:
        ph0 = ph1 = paddings[0]
        pw0 = pw1 = paddings[1]
    else:
        ph0, pw0, ph1, pw1 = paddings
    return apply_op("unfold", _unfold, x, kh=kh, kw=kw, sh=sh, sw=sw, dh=dh,
                    dw=dw, ph0=ph0, ph1=ph1, pw0=pw0, pw1=pw1)


def _fold(x, oh, ow, kh, kw, sh, sw, dh, dw, ph, pw):
    N = x.shape[0]
    C = x.shape[1] // (kh * kw)
    lh = (oh + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    lw = (ow + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    cols = x.reshape(N, C, kh, kw, lh, lw)
    out = torch.zeros((N, C, oh + 2 * ph, ow + 2 * pw), dtype=x.dtype,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + (lh - 1) * sh + 1:sh,
                j * dw:j * dw + (lw - 1) * sw + 1:sw] += cols[:, :, i, j]
    return out[:, :, ph:ph + oh, pw:pw + ow]


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, the sum of ``unfold``'s columns back into (N, C, oh, ow)."""
    oh, ow = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    ph, pw = _pair(paddings)[:2]
    return apply_op("fold", _fold, x, oh=oh, ow=ow, kh=kh, kw=kw, sh=sh,
                    sw=sw, dh=dh, dw=dw, ph=ph, pw=pw)


def _pixel_shuffle(x, r, data_format):
    if data_format == "NCHW":
        N, C, H, W = x.shape
        out = x.reshape(N, C // (r * r), r, r, H, W).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(N, C // (r * r), H * r, W * r)
    N, H, W, C = x.shape
    out = x.reshape(N, H, W, r, r, C // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(N, H * r, W * r, C // (r * r))


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    return apply_op("pixel_shuffle", _pixel_shuffle, x,
                    r=int(upscale_factor), data_format=data_format)


def _pixel_unshuffle(x, r):
    N, C, H, W = x.shape
    out = x.reshape(N, C, H // r, r, W // r, r).permute(0, 1, 3, 5, 2, 4)
    return out.reshape(N, C * r * r, H // r, W // r)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    return apply_op("pixel_unshuffle", _pixel_unshuffle, x,
                    r=int(downscale_factor))


def _channel_shuffle(x, g):
    N, C, H, W = x.shape
    return x.reshape(N, g, C // g, H, W).transpose(1, 2).reshape(N, C, H, W)


def channel_shuffle(x, groups, data_format="NCHW"):
    return apply_op("channel_shuffle", _channel_shuffle, x, g=int(groups))


def _bilinear(a, b, w, bias):
    out = torch.einsum("bi,oij,bj->bo", a, w, b)
    return out + bias if bias is not None else out


def bilinear(x1, x2, weight, bias=None):
    """x1 (B, in1), weight (out, in1, in2), x2 (B, in2) -> (B, out)."""
    return apply_op("bilinear", _bilinear, x1, x2, weight, bias)


def _cosine_similarity(a, b, axis, eps):
    dot = torch.sum(a * b, axis)
    return dot / torch.clamp_min(torch.linalg.vector_norm(a, dim=axis)
                                 * torch.linalg.vector_norm(b, dim=axis),
                                 eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return apply_op("cosine_similarity", _cosine_similarity, x1, x2,
                    axis=axis, eps=eps)


def _label_smooth(label, prior_dist, epsilon):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def label_smooth(label, prior_dist=None, epsilon=0.1):
    return apply_op("label_smooth", _label_smooth, label,
                    prior_dist=prior_dist, epsilon=epsilon)


def _sequence_mask(lengths, maxlen, dtype):
    m = maxlen if maxlen is not None else int(lengths.max())
    mask = torch.arange(m, device=lengths.device)[None, :] \
        < lengths.reshape(-1, 1)
    return mask.to(dtype).reshape(tuple(lengths.shape) + (m,))


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """(..., maxlen) mask of j < lengths[...]; 64-bit types become 32-bit
    ones, as in the reference (``core.dtype.x32``)."""
    return apply_op("sequence_mask", _sequence_mask, lengths, maxlen=maxlen,
                    dtype=x32(convert_dtype(dtype)), nondiff=True)


def _one_hot(x, num_classes):
    return (x[..., None] == torch.arange(num_classes, device=x.device)
            ).to(torch.float32)


def one_hot(x, num_classes, name=None):
    """float32 (..., num_classes); an id outside [0, num_classes) gives a
    zero row (``jax.nn.one_hot``'s)."""
    return apply_op("one_hot", _one_hot, x, num_classes=int(num_classes))


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    """Diagonal matrices from the last axis of ``input``, on the diagonal
    ``offset`` of the output axes ``dim1`` and ``dim2``."""
    return apply_op("diag_embed", torch.diag_embed, input, offset=offset,
                    dim1=dim1, dim2=dim2)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding of [left, right, top, bottom]."""
    l, r, t, b = (int(p) for p in padding)
    if data_format == "NCHW":
        return apply_op("zeropad2d", torch.nn.functional.pad, x,
                        pad=(l, r, t, b))
    return apply_op("zeropad2d", torch.nn.functional.pad, x,
                    pad=(0, 0, l, r, t, b))


def class_center_sample(label, num_classes, num_samples, group=None,
                        *, generator=None):
    """(remapped label, sampled class ids): every class in ``label``
    (sorted) and, while fewer than ``num_samples``, classes drawn from the
    rest in random order; each label becomes its class's index among the
    sampled. A host-side op, as in the reference."""
    lab = label.detach().cpu().numpy() if isinstance(label, torch.Tensor) \
        else np.asarray(label)
    pos = np.unique(lab)
    n_extra = max(0, num_samples - pos.size)
    sampled = pos
    if n_extra > 0:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        perm = torch.randperm(rest.size, generator=torch_generator(
            generator, "cpu")).numpy()
        sampled = np.concatenate([pos, rest[perm[:n_extra]]])
    remap = -np.ones(num_classes, dtype=lab.dtype)
    remap[sampled] = np.arange(sampled.size)
    dev = label.device if isinstance(label, torch.Tensor) else "cpu"
    dtype = x32(torch.from_numpy(lab[:0]).dtype)
    return (torch.as_tensor(remap[lab], device=dev).to(dtype),
            torch.as_tensor(sampled, device=dev).to(dtype))
