"""``paddle.static.nn`` of the PyTorch port: program-building layer
functions and the sequence ops.

Counterpart of ``paddle_tpu/static/nn.py`` (``:21-725``): each layer
function instantiates the port's eager ``nn`` layer (its parameters on the
default device), calls it on the symbolic input and parks it on the
program (``_park``) so its parameters stay alive; the parameters join the
program when the captured ops meet them. The functions that are one
formula (``data_norm``, ``row_conv``, ``nce``, ``crf_decoding``'s
Viterbi, the ``sequence_*`` ops) are the reference's formulas through the
op dispatch under its op names. The sequence ops take the padded dense
(B, T, ...) form with an optional lengths vector, as the reference's do.

Refused by name: ``conv2d_transpose`` and ``conv3d_transpose`` (the
port's transposed convolutions are ROADMAP item 16) and ``deform_conv2d``
(``vision.ops``, item 16).

Where the port departs from the reference: ``spectral_norm`` runs the
port's ``nn.SpectralNorm`` on the weight (the reference imports a
``spectral_normalize`` its ``nn`` does not have, and raises).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import place as _place
from ..core.generator import torch_generator
from ..core.tensor import Parameter
from ..ops.dispatch import apply_op
from . import graph as G


def _park(layer):
    G.default_main_program()._layers.append(layer)
    return layer


def _act(out, act):
    if not act:
        return out
    from ..nn import functional as F
    return getattr(F, act)(out)


def _refuse(name, what):
    raise NotImplementedError(
        f"static.nn.{name}: {what} is not ported yet: ROADMAP Queue 1 item "
        "16 (vision.ops and the transposed convolutions)")


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """~ static.nn.fc: flattens the trailing dims, affine, optional act."""
    from .. import nn
    from ..ops import manipulation as M
    in_shape = x.shape
    in_features = int(np.prod(in_shape[num_flatten_dims:]))
    layer = _park(nn.Linear(in_features, size, weight_attr=weight_attr,
                            bias_attr=bias_attr))
    h = x
    if len(in_shape) > num_flatten_dims + 1:
        h = M.reshape(h, list(in_shape[:num_flatten_dims]) + [in_features])
    return _act(layer(h), activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """~ static.nn.embedding."""
    from .. import nn
    layer = _park(nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                               weight_attr=param_attr))
    return layer(input)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, param_attr=None,
               bias_attr=None, data_layout="NCHW", is_test=False,
               name=None, **kwargs):
    """~ static.nn.batch_norm. The running statistics stay frozen in the
    program (a training program normalizes with the batch's)."""
    from .. import nn
    nc = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = _park(nn.BatchNorm2D(nc, momentum=momentum, epsilon=epsilon,
                                 data_format=data_layout)
                  if input.ndim == 4 else
                  nn.BatchNorm1D(nc, momentum=momentum, epsilon=epsilon))
    if is_test:
        layer.eval()
    return _act(layer(input), act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    """~ static.nn.conv2d."""
    from .. import nn
    in_ch = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    layer = _park(nn.Conv2D(in_ch, num_filters, filter_size, stride=stride,
                            padding=padding, dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr,
                            data_format=data_format))
    return _act(layer(input), act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None):
    _refuse("conv2d_transpose", "nn.Conv2DTranspose")


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCDHW", name=None):
    """~ static.nn.conv3d."""
    from .. import nn
    in_ch = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    layer = _park(nn.Conv3D(in_ch, num_filters, filter_size, stride=stride,
                            padding=padding, dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr,
                            data_format=data_format))
    return _act(layer(input), act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCDHW", name=None):
    _refuse("conv3d_transpose", "nn.Conv3DTranspose")


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from .. import nn
    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    layer = _park(nn.LayerNorm(shape, epsilon=epsilon))
    if not scale:
        layer.weight = None
    if not shift:
        layer.bias = None
    return _act(layer(input), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    from .. import nn
    nc = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = _park(nn.GroupNorm(groups, nc, epsilon=epsilon))
    return _act(layer(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    from .. import nn
    cls = {3: nn.InstanceNorm1D, 4: nn.InstanceNorm2D,
           5: nn.InstanceNorm3D}[input.ndim]
    return _park(cls(input.shape[1], epsilon=epsilon))(input)


def _data_norm(x, epsilon):
    mean = torch.mean(x, 0, keepdim=True)
    var = torch.mean(torch.square(x - mean), 0, keepdim=True)
    return (x - mean) / torch.sqrt(var + epsilon)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              enable_scale_and_shift=False, **kwargs):
    """~ static.nn.data_norm: normalization by the batch's statistics
    (the reference's single-program form)."""
    return _act(apply_op("data_norm", _data_norm, input, epsilon=epsilon),
                act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` over its largest singular value: the port's
    ``nn.SpectralNorm`` (module docstring)."""
    from .. import nn
    layer = _park(nn.SpectralNorm(list(weight.shape), dim=dim,
                                  power_iters=power_iters, eps=eps))
    return layer(weight)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from ..nn import functional as F
    from ..ops.manipulation import reshape
    if mode == "all":
        n = 1
    elif mode == "channel":
        n = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    else:
        n = int(np.prod(x.shape[1:]))
    alpha = Parameter(torch.full((n,), 0.25, dtype=torch.float32,
                                 device=_place.resolve_device(None)))
    G.default_main_program()._layers.append(alpha)
    a = reshape(alpha, [1, n] + [1] * (x.ndim - 2)) \
        if mode == "channel" and data_format == "NCHW" else alpha
    return F.prelu(x, a)


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    from .. import nn
    layer = _park(nn.Bilinear(x.shape[-1], y.shape[-1], size))
    return _act(layer(x, y), act)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    _refuse("deform_conv2d", "vision.ops.DeformConv2D")


def _row_conv(x, wv, k):
    # x: (B, T, D); each step mixes the next k - 1 steps per channel
    xp = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * wv[i]
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """~ static.nn.row_conv (lookahead conv, Deep Speech)."""
    d = input.shape[-1]
    k = future_context_size + 1
    w = Parameter(torch.full((k, d), 1.0 / k, dtype=torch.float32,
                             device=_place.resolve_device(None)))
    G.default_main_program()._layers.append(w)
    return _act(apply_op("row_conv", _row_conv, input, w, k=k), act)


def _viterbi(emis, trans):
    """(scores (B,), paths (B, T) int64): the reference's Viterbi
    (``paddle_tpu/text/__init__.py:20-53``), the first best on ties."""
    score = emis[:, 0]
    ptrs = []
    for t in range(1, emis.shape[1]):
        total = score[:, :, None] + trans[None]
        score = torch.amax(total, 1) + emis[:, t]
        ptrs.append(torch.argmax(total, 1))
    last = torch.argmax(score, -1)
    path = [last]
    for ptr in reversed(ptrs):
        last = torch.gather(ptr, 1, last[:, None])[:, 0]
        path.append(last)
    return torch.amax(score, -1), torch.stack(path[::-1], 1).to(torch.int64)


def crf_decoding(input, param_attr=None, label=None, length=None,
                 transition=None):
    """~ static.nn.crf_decoding: the Viterbi path over the emissions; the
    transition matrix is a parameter made here when not passed. As in
    the reference, ``length`` is not read."""
    n = input.shape[-1]
    if transition is None:
        transition = Parameter(torch.zeros(
            (n, n), dtype=torch.float32, device=_place.resolve_device(None)))
        G.default_main_program()._layers.append(transition)
    emis = input if input.ndim == 3 else input[None]
    _scores, path = apply_op("viterbi_decode", _viterbi, emis, transition)
    return path


def _softplus(z):
    return torch.clamp_min(z, 0) + torch.log1p(torch.exp(-torch.abs(z)))


def _nce(x, lab, wv, bv, neg):
    lab = lab.reshape(-1)
    pos_logit = torch.sum(x * wv[lab], -1) + bv[lab]
    neg_logit = x @ wv[neg].T + bv[neg]
    loss = _softplus(-pos_logit) + torch.sum(_softplus(neg_logit), -1)
    return loss[:, None]


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=5, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """~ static.nn.nce (noise-contrastive estimation): logistic loss on
    the true class and ``num_neg_samples`` negatives drawn once, when the
    program is built."""
    d = input.shape[-1]
    dev = _place.resolve_device(None)
    gen = torch_generator(None, dev)
    w = Parameter(torch.randn((num_total_classes, d), generator=gen,
                              device=dev) * 0.01)
    b = Parameter(torch.zeros((num_total_classes,), device=dev))
    G.default_main_program()._layers.extend([w, b])
    neg = torch.randint(0, num_total_classes, (num_neg_samples,),
                        generator=gen, device=dev)
    return apply_op("nce", _nce, input, label, w, b, neg=neg)


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, param_attr=None, dtype="float32"):
    """~ static.nn.sparse_embedding: a dense table here (the distributed
    table is ROADMAP item 15)."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """~ static.nn.py_func: called through, as in the reference."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return func(*xs)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, offset=0.5, flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """~ static.nn.multi_box_head (the SSD head): per feature map a loc
    and a conf conv head, and the prior boxes with their variances."""
    from .. import nn
    from ..ops.manipulation import concat, reshape, transpose
    n_layers = len(inputs)
    if min_sizes is None:
        min_ratio, max_ratio = int(min_ratio), int(max_ratio)
        step = int((max_ratio - min_ratio) / max(1, n_layers - 2))
        min_sizes, max_sizes = [], []
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[:n_layers - 1]
        max_sizes = [base_size * 0.2] + max_sizes[:n_layers - 1]
    locs, confs, priors, vars_ = [], [], [], []
    img_h, img_w = image.shape[2], image.shape[3]
    for i, feat in enumerate(inputs):
        ars = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                             (list, tuple)) \
            else [aspect_ratios[i]]
        n_prior = len([a for a in ars if a != 1]) * (2 if flip else 1) + 2
        h, w = feat.shape[2], feat.shape[3]
        loc_head = _park(nn.Conv2D(feat.shape[1], n_prior * 4, kernel_size,
                                   padding=pad, stride=stride))
        conf_head = _park(nn.Conv2D(feat.shape[1], n_prior * num_classes,
                                    kernel_size, padding=pad, stride=stride))
        loc = loc_head(feat)
        conf = conf_head(feat)
        locs.append(reshape(transpose(loc, [0, 2, 3, 1]),
                            [loc.shape[0], -1, 4]))
        confs.append(reshape(transpose(conf, [0, 2, 3, 1]),
                             [conf.shape[0], -1, num_classes]))
        step_w = steps[i] if steps else img_w / w
        step_h = steps[i] if steps else img_h / h
        cx = (np.arange(w) + offset) * step_w / img_w
        cy = (np.arange(h) + offset) * step_h / img_h
        cxg, cyg = np.meshgrid(cx, cy)
        smin = min_sizes[i] / base_size
        smax = (max_sizes[i] / base_size) if max_sizes else smin
        sizes = [(smin, smin), (float(np.sqrt(smin * smax)),) * 2]
        for ar in ars:
            if ar == 1:
                continue
            sizes.append((smin * np.sqrt(ar), smin / np.sqrt(ar)))
            if flip:
                sizes.append((smin / np.sqrt(ar), smin * np.sqrt(ar)))
        boxes = [np.stack([cxg - sw / 2, cyg - sh / 2, cxg + sw / 2,
                           cyg + sh / 2], -1) for sw, sh in sizes[:n_prior]]
        pb = np.stack(boxes, 2).reshape(-1, 4).astype(np.float32)
        if clip:
            pb = pb.clip(0, 1)
        priors.append(pb)
        vars_.append(np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                             (len(pb), 1)))
    dev = _place.resolve_device(None)
    box = torch.as_tensor(np.concatenate(priors), device=dev)
    var = torch.as_tensor(np.concatenate(vars_), device=dev)
    return concat(locs, axis=1), concat(confs, axis=1), box, var


# ---- sequence ops ----------------------------------------------------------

def _seq_mask(x, length):
    B, T = x.shape[0], x.shape[1]
    if length is None:
        return torch.ones((B, T), dtype=torch.bool, device=x.device)
    return torch.arange(T, device=x.device)[None, :] < length[:, None]


def _with_len(x, length):
    return [x] + ([length] if length is not None else [])


def _seq_pool(x, *rest, pool_type):
    m = _seq_mask(x, rest[0] if rest else None)
    mf = m.to(x.dtype)
    while mf.dim() < x.dim():
        mf = mf[..., None]
    pt = pool_type.lower()
    if pt == "sum":
        return torch.sum(x * mf, 1)
    if pt in ("average", "mean"):
        return torch.sum(x * mf, 1) / torch.clamp_min(mf.sum(1), 1.0)
    if pt == "sqrt":
        return torch.sum(x * mf, 1) / torch.sqrt(
            torch.clamp_min(mf.sum(1), 1.0))
    if pt == "max":
        lowest = torch.finfo(x.dtype).min
        return torch.amax(torch.where(mf > 0, x, lowest), 1)
    if pt == "last":
        if rest:
            idx = torch.clamp_min(rest[0].to(torch.int64) - 1, 0)
        else:
            idx = torch.full((x.shape[0],), x.shape[1] - 1,
                             dtype=torch.int64, device=x.device)
        sel = idx.reshape(-1, *([1] * (x.dim() - 1)))
        sel = sel.expand((x.shape[0], 1) + tuple(x.shape[2:]))
        return torch.gather(x, 1, sel)[:, 0]
    if pt == "first":
        return x[:, 0]
    raise ValueError(f"unknown pool_type {pool_type}")


def sequence_pool(input, pool_type="sum", length=None, pad_value=0.0):
    return apply_op("sequence_pool", _seq_pool, *_with_len(input, length),
                    pool_type=pool_type)


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def _seq_softmax(x, *rest):
    m = _seq_mask(x, rest[0] if rest else None)
    while m.dim() < x.dim():
        m = m[..., None]
    return torch.softmax(torch.where(m, x, torch.finfo(x.dtype).min), 1)


def sequence_softmax(input, length=None):
    return apply_op("sequence_softmax", _seq_softmax,
                    *_with_len(input, length))


def _seq_reverse(v, *rest):
    if not rest:
        return torch.flip(v, (1,))
    lv = rest[0].to(torch.int64)
    T = v.shape[1]
    idx = torch.arange(T, device=v.device)[None, :]
    rev = torch.where(idx < lv[:, None], lv[:, None] - 1 - idx, idx)
    sel = rev.reshape(tuple(rev.shape) + (1,) * (v.dim() - 2))
    return torch.gather(v, 1, sel.expand(v.shape))


def sequence_reverse(x, length=None, name=None):
    return apply_op("sequence_reverse", _seq_reverse, *_with_len(x, length))


def sequence_concat(input, name=None):
    from ..ops.manipulation import concat
    return concat(list(input), axis=1)


def _seq_expand(xv, yv):
    reps = yv.shape[1]
    if xv.dim() == 2:
        return torch.repeat_interleave(xv[:, None], reps, 1)
    return torch.repeat_interleave(xv, reps // xv.shape[1], 1)


def sequence_expand(x, y, ref_level=-1, name=None):
    """Repeat each row of x to y's time length (padded-form expand)."""
    return apply_op("sequence_expand", _seq_expand, x, y)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def _seq_pad(v, pv, maxlen):
    T = v.shape[1]
    target = maxlen or T
    if target > T:
        return torch.nn.functional.pad(
            v, (0, 0) * (v.dim() - 2) + (0, target - T))
    return v[:, :target]


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """(B, T, ...) dense input, padded or trimmed to ``maxlen``: (padded,
    lengths). As in the reference, the padding is zeros whatever
    ``pad_value`` says."""
    padded = apply_op("sequence_pad", _seq_pad, x, pad_value, maxlen=maxlen)
    lengths = torch.full((x.shape[0],), min(x.shape[1], maxlen or x.shape[1]),
                         dtype=torch.int32, device=x.device)
    return padded, lengths


def sequence_unpad(x, length, name=None):
    """Trim to max(length) (read on the host; per-row raggedness stays
    masked)."""
    lv = length.detach().cpu().numpy() if isinstance(length, torch.Tensor) \
        else np.asarray(length)
    tmax = int(lv.max()) if lv.size else 0
    return apply_op("sequence_unpad", lambda v, l: v[:, :tmax], x, length)


def sequence_reshape(input, new_dim):
    from ..ops.manipulation import reshape
    return reshape(input, [input.shape[0], -1, new_dim])


def _seq_enumerate(v, win_size, pad_value):
    T = v.shape[1]
    vp = torch.nn.functional.pad(v, (0, win_size - 1), value=pad_value)
    return torch.stack([vp[:, i:i + T] for i in range(win_size)], -1)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return apply_op("sequence_enumerate", _seq_enumerate, input,
                    win_size=win_size, pad_value=pad_value, nondiff=True)


def _seq_slice(v, off, ln):
    T = v.shape[1]
    ar = torch.arange(T, device=v.device)[None]
    idx = torch.clamp(off.reshape(-1, 1).to(torch.int64) + ar, 0, T - 1)
    m = ar < ln.reshape(-1, 1)
    sel = idx.reshape(tuple(idx.shape) + (1,) * (v.dim() - 2))
    g = torch.gather(v, 1, sel.expand((v.shape[0], T) + tuple(v.shape[2:])))
    mf = m.to(v.dtype)
    while mf.dim() < g.dim():
        mf = mf[..., None]
    return g * mf


def sequence_slice(input, offset, length, name=None):
    return apply_op("sequence_slice", _seq_slice, input, offset, length)


def _seq_scatter(v, idx, upd):
    b = torch.arange(v.shape[0], device=v.device)[:, None].expand(idx.shape)
    return torch.index_put(v, (b, idx.to(torch.int64)), upd.to(v.dtype),
                           accumulate=True)


def sequence_scatter(input, index, updates, name=None):
    return apply_op("sequence_scatter", _seq_scatter, input, index, updates)


def _seq_conv(x, wv, *rest, filter_size, start):
    T = x.shape[1]
    cols = []
    for k in range(filter_size):
        shift = start + k
        if shift < 0:
            xs = torch.nn.functional.pad(x, (0, 0, -shift, 0))[:, :T]
        elif shift > 0:
            xs = torch.nn.functional.pad(x, (0, 0, 0, shift))[:, shift:]
        else:
            xs = x
        cols.append(xs)
    out = torch.cat(cols, -1) @ wv
    if rest:
        out = out + rest[0]
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, act=None,
                  param_attr=None, bias_attr=None, name=None):
    """~ static.nn.sequence_conv: a context-window conv over time."""
    d = input.shape[-1]
    dev = _place.resolve_device(None)
    limit = math.sqrt(6.0 / (filter_size * d + num_filters))
    w = Parameter(torch.empty((filter_size * d, num_filters),
                              device=dev).uniform_(
        -limit, limit, generator=torch_generator(None, dev)))
    b = Parameter(torch.zeros((num_filters,), device=dev)) \
        if bias_attr is not False else None
    G.default_main_program()._layers.extend([w] + ([b] if b is not None
                                                   else []))
    start = padding_start if padding_start is not None \
        else -(filter_size // 2)
    args = [input, w] + ([b] if b is not None else [])
    return _act(apply_op("sequence_conv", _seq_conv, *args,
                         filter_size=filter_size, start=start), act)


def _seq_erase(v, *rest, tokens):
    keep = _seq_mask(v, rest[0] if rest else None)
    for t in tokens:
        keep = keep & (v != t)
    # stable compaction: kept entries first, original order preserved
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.gather(v, 1, order)
    kept_sorted = torch.gather(keep, 1, order)
    return (torch.where(kept_sorted, compacted, torch.zeros_like(compacted)),
            keep.sum(1).to(torch.int32))


def sequence_erase(input, tokens, length=None, name=None):
    """Every occurrence of ``tokens`` removed from each row, the rest
    compacted left: (erased (B, T), trailing pad 0; new lengths (B,))."""
    tok = [int(t) for t in (tokens if hasattr(tokens, "__len__")
                            else [tokens])]
    out, new_len = apply_op("sequence_erase", _seq_erase,
                            *_with_len(input, length), tokens=tok,
                            nondiff=True)
    return out, new_len


def _seq_topk(x, *rest, ks):
    B, C, R, L = x.shape
    if rest:
        valid = (torch.arange(L, device=x.device)[None, :]
                 < rest[0].to(torch.int64)[:, None])[:, None, None, :]
    else:
        valid = torch.ones((B, 1, 1, L), dtype=torch.bool, device=x.device)
    masked = torch.where(valid, x, torch.finfo(x.dtype).min)
    kk = min(max(ks), L)
    top = torch.topk(masked, kk, -1).values
    n_valid = valid.expand(x.shape).sum(-1)
    outs = []
    for k in ks:
        hit = torch.clamp_max(n_valid, min(k, kk))
        take = torch.arange(kk, device=x.device) < hit[..., None]
        s = torch.where(take, top, torch.zeros_like(top)).sum(-1)
        outs.append(s / torch.clamp_min(hit, 1).to(x.dtype))
    return torch.stack(outs, -1).permute(0, 2, 1, 3).reshape(B, R, -1)


def sequence_topk_avg_pooling(input, topks, channel_num=None, row=None,
                              col=None, name=None):
    """Per-row top-k column averages per channel: input (B, C, R, L), for
    each k of ``topks`` the mean of the real top-k values over L; ``col``
    (B,) masks the valid columns. Returns (B, R, C * len(topks))."""
    return apply_op("sequence_topk_avg_pooling", _seq_topk,
                    *_with_len(input, col), ks=[int(k) for k in topks])


# ---- control flow re-exports ----------------------------------------------
from ..ops.control_flow import case, cond, switch_case, while_loop  # noqa
