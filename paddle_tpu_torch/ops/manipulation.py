"""Shape, layout, gather and scatter ops of the PyTorch port.

Counterpart of ``paddle_tpu/ops/manipulation.py`` with the reference's
signatures and its meanings where torch's differ: ``transpose(x, perm)``
permutes, ``gather(x, index, axis)`` takes whole slices at the flattened
``index`` (``jnp.take``), ``scatter`` writes or adds rows along axis 0,
``split`` takes a count or sizes with one -1, ``squeeze`` / ``unsqueeze``
take lists, ``sort`` returns the values and ``topk`` / ``argsort`` /
``unique`` / ``nonzero`` / ``searchsorted`` give int32 indices. ``flatten``
merges ``start_axis`` .. ``stop_axis`` (a 0-d tensor becomes shape (1,)).
As in the reference, the registry's ``unstack`` is an identity
placeholder while the public ``unstack`` is ``unbind`` (ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ._util import call, op, shape_list

__all__ = ["reshape", "flatten", "transpose", "moveaxis", "swapaxes",
           "squeeze", "unsqueeze", "concat", "stack", "split", "chunk",
           "unbind", "tile", "repeat_interleave", "expand", "expand_as",
           "broadcast_to", "broadcast_tensors", "flip", "roll", "rot90",
           "slice_", "strided_slice", "gather", "gather_nd",
           "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
           "scatter_nd", "index_select", "index_sample", "masked_select",
           "masked_fill", "index_put", "pad", "unstack", "unique", "nonzero",
           "sort", "argsort", "topk", "searchsorted", "bincount", "one_hot",
           "as_real", "as_complex", "shard_index"]


@op("reshape")
def reshape(x, shape):
    return torch.reshape(x, shape_list(shape))


@op("flatten")
def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    start, stop = start_axis % nd, stop_axis % nd
    shape = tuple(x.shape)
    return x.reshape(shape[:start] + (math.prod(shape[start:stop + 1]),)
                     + shape[stop + 1:])


@op("transpose")
def transpose(x, perm=None):
    perm = list(range(x.dim()))[::-1] if perm is None else \
        [int(p) for p in perm]
    return x.permute(perm)


@op("moveaxis")
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op("swapaxes")
def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, int(axis1), int(axis2))


@op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, axis) if axis else x
    return torch.squeeze(x, int(axis))


@op("unsqueeze")
def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, int(a))
        return x
    return torch.unsqueeze(x, int(axis))


def _axis(axis):
    return int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)


def concat(x, axis=0):
    return call("concat", _cat, *x, axis=_axis(axis))


def _cat(*vs, axis):
    return torch.cat(vs, axis)


def stack(x, axis=0):
    return call("stack", _stack, *x, axis=_axis(axis))


def _stack(*vs, axis):
    return torch.stack(vs, axis)


def split(x, num_or_sections, axis=0):
    axis = _axis(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [int(s) for s in num_or_sections]
        if -1 in sections:
            known = sum(s for s in sections if s != -1)
            sections[sections.index(-1)] = dim - known
    offsets = np.cumsum(sections)[:-1].tolist()
    out = call("split", lambda v: tuple(torch.tensor_split(v, offsets, axis)),
               x)
    return list(out)



def chunk(x, chunks, axis=0):
    return split(x, int(chunks), axis)


def unbind(x, axis=0):
    n = x.shape[axis]
    return [squeeze(o, axis=axis) for o in split(x, n, axis)]


@op("tile")
def tile(x, repeat_times):
    return torch.tile(x, tuple(int(r) for r in repeat_times))


@op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@op("expand")
def expand(x, shape):
    shape = shape_list(shape)
    pad = len(shape) - x.dim()
    full = [x.shape[i - pad] if s == -1 else s for i, s in enumerate(shape)]
    return x.expand(full)


def expand_as(x, y):
    return expand(x, list(y.shape))


def broadcast_to(x, shape):
    return expand(x, shape)


def broadcast_tensors(inputs):
    shape = list(torch.broadcast_shapes(*[tuple(t.shape) for t in inputs]))
    return [expand(t, shape) for t in inputs]


@op("flip")
def flip(x, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


@op("roll")
def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, axis)


@op("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@op("slice")
def slice_(x, axes, starts, ends):
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = slice(int(st), int(en))
    return x[tuple(idx)]


@op("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        keep = range(*slice(int(st), int(en), int(sd)).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(list(keep),
                                                   dtype=torch.long,
                                                   device=x.device))
    return x


@op("gather")
def gather(x, index, axis=0):
    return torch.index_select(x, int(axis), index.reshape(-1).long())


def _index_tuple(index):
    return tuple(index.long().movedim(-1, 0))


@op("gather_nd")
def gather_nd(x, index):
    return x[_index_tuple(index)]


@op("take_along_axis")
def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices.long(), int(axis))


@op("put_along_axis")
def put_along_axis(x, indices, values, axis, reduce="assign"):
    axis, idx = int(axis), indices.long()
    src = torch.as_tensor(values, dtype=x.dtype, device=x.device)
    src = src.expand(idx.shape) if src.dim() <= idx.dim() else src
    if reduce == "assign":
        return torch.scatter(x, axis, idx, src)
    if reduce == "add":
        return torch.scatter_add(x, axis, idx, src)
    if reduce == "multiply":
        return torch.scatter_reduce(x, axis, idx, src, "prod")
    raise ValueError(f"unknown reduce {reduce}")


@op("scatter")
def scatter(x, index, updates, overwrite=True):
    index = index.reshape(-1).long()
    if overwrite:
        return torch.index_copy(x, 0, index, updates.to(x.dtype))
    return torch.index_add(x, 0, index, updates.to(x.dtype))


@op("scatter_nd_add")
def scatter_nd_add(x, index, updates):
    return torch.index_put(x, _index_tuple(index), updates.to(x.dtype),
                           accumulate=True)


def scatter_nd(index, updates, shape):
    def _snd(index, updates):
        zeros = torch.zeros(shape_list(shape), dtype=updates.dtype,
                            device=updates.device)
        return torch.index_put(zeros, _index_tuple(index), updates,
                               accumulate=True)
    return call("scatter_nd", _snd, index, updates)


@op("index_select")
def index_select(x, index, axis=0):
    return torch.index_select(x, int(axis), index.reshape(-1).long())


@op("index_sample")
def index_sample(x, index):
    return torch.take_along_dim(x, index.long(), 1)


@op("masked_select")
def masked_select(x, mask):
    return x[mask]


@op("masked_fill")
def masked_fill(x, mask, value):
    if not isinstance(value, torch.Tensor):
        # a Python number is weak, as in jnp.where: x's dtype, or float32
        # for a float into integers
        value = torch.as_tensor(value, device=x.device)
        value = value.to(x.dtype if x.is_floating_point()
                         or not value.is_floating_point() else torch.float32)
    return torch.where(mask, value, x)


@op("index_put")
def index_put(x, indices, value, accumulate=False):
    idx = tuple(i.long() if isinstance(i, torch.Tensor) and
                i.dtype != torch.bool else i for i in indices)
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.index_put(x, idx, value, accumulate=accumulate)


def _pad_index(n, before, after, mode, device):
    """Indices into an axis of length ``n`` that pad it by ``before`` /
    ``after`` in ``mode`` (numpy's reflect, edge and wrap)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "reflect":
        period = 2 * (n - 1)
        i = torch.remainder(i, period) if period else torch.zeros_like(i)
        i = torch.where(i >= n, period - i, i)
    elif mode == "replicate":
        i = i.clamp(0, n - 1)
    else:
        i = torch.remainder(i, n)
    return i


@op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    if len(pad) == 2 * x.dim():
        pairs = [(int(pad[2 * i]), int(pad[2 * i + 1]))
                 for i in range(x.dim())]
    else:
        n_spatial = len(pad) // 2
        spat = [(int(pad[2 * i]), int(pad[2 * i + 1]))
                for i in range(n_spatial)]
        if data_format.endswith("C"):    # channel-last: spatial axes 1..
            pairs = ([(0, 0)] + spat + [(0, 0)])[:x.dim()]
        else:
            pairs = [(0, 0)] * (x.dim() - n_spatial) + spat
    if mode == "constant":
        flat = [p for pr in reversed(pairs) for p in pr]
        return F.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for ax, (b, a) in enumerate(pairs):
        if b or a:
            x = torch.index_select(x, ax, _pad_index(x.shape[ax], b, a, mode,
                                                     x.device))
    return x


@op("unstack")
def _unstack_placeholder(x):
    return x


def unstack(x, axis=0, num=None):
    return unbind(x, axis)


def _first_index(inverse, n):
    """The index of each unique value's first occurrence."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n,), inverse.numel(), dtype=pos.dtype,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


@op("unique", nondiff=True)
def unique(x, return_index=False, return_inverse=False,
           return_counts=False):
    vals, inv, counts = torch.unique(x.reshape(-1), sorted=True,
                                     return_inverse=True,
                                     return_counts=True)
    out = [vals]
    if return_index:
        out.append(_first_index(inv, vals.numel()))
    if return_inverse:
        out.append(inv.reshape(x.shape))
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


@op("nonzero", nondiff=True)
def nonzero(x, as_tuple=False):
    if as_tuple:
        return torch.nonzero(x, as_tuple=True)
    return torch.nonzero(x)


@op("sort")
def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=int(axis), stable=True).values
    return torch.flip(out, [int(axis)]) if descending else out


@op("argsort", nondiff=True)
def argsort(x, axis=-1, descending=False):
    out = torch.argsort(x, dim=int(axis), stable=True)
    return torch.flip(out, [int(axis)]) if descending else out


def topk(x, k, axis=-1, largest=True, sorted=True):
    return call("topk", lambda v: tuple(torch.topk(v, int(k), int(axis),
                                                   largest, True)), x)


@op("searchsorted", nondiff=True)
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=True)


@op("bincount", nondiff=True)
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights, int(minlength))


@op("one_hot", nondiff=True)
def one_hot(x, num_classes):
    return F.one_hot(x.long(), int(num_classes)).to(torch.float32)


@op("as_real", nondiff=True)
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


@op("as_complex")
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def _shard(x):
        size = index_num // nshards
        lo, hi = shard_id * size, (shard_id + 1) * size
        ok = (x >= lo) & (x < hi)
        return torch.where(ok, x - lo, torch.full_like(x, ignore_value))
    return call("shard_index", _shard, input, nondiff=True)
