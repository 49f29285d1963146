"""Ulysses (DeepSpeed-style) sequence parallelism for the PyTorch port:
the head-scatter all-to-all.

Counterpart of ``paddle_tpu/parallel/ulysses.py``. The sister strategy of
ring attention on the "sep" axis: two all-to-alls in all,

    in : (B, H,   S/n, D) the rank's sequence chunk
    a2a: (B, H/n, S,   D) its head shard, over the whole sequence
    ... attention over the full sequence ...
    a2a: (B, H,   S/n, D) its sequence chunk again

As in ``ring_attention.py``, the port takes the rank's LOCAL chunks (the
reference takes global arrays inside a ``shard_map``). The exchanges are
``collective.all_to_all_tiled`` (device tensors under NCCL, pinned host
memory under gloo) in an autograd function whose backward is the reverse
exchange; the attention is ``flash_attention`` (the multi-head kernels)
where ``flash_eligible(S, D, dtype)``, else the dense f32 softmax of the
reference's ``_local_attention``. K/V come at the query heads' count, as
the reference's Llama path repeats them.
"""
from __future__ import annotations

import math

import torch

from ..distributed.collective import all_to_all_tiled


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all_tiled(x.contiguous(), group, split_axis,
                                concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (all_to_all_tiled(g.contiguous(), ctx.group, concat_axis,
                                 split_axis), None, None, None)


def _local_attention(q, k, v, causal: bool, sm_scale: float):
    """Attention over the whole sequence of the rank's heads
    (``:28-45``): the flash kernels where the gate admits the shape,
    exact dense softmax in f32 otherwise."""
    from ..ops.flash_attention import flash_attention, flash_eligible
    if flash_eligible(q.shape[2], q.shape[-1], q.dtype):
        return flash_attention(q, k, v, causal, sm_scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * sm_scale
    if causal:
        S = q.shape[2]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)


def ulysses_attention(q, k, v, mesh, axis: str = "sep", causal: bool = True,
                      sm_scale=None):
    """q/k/v: the rank's chunks (B, H, S/n, D) of a sequence whose chunks
    lie on ``mesh``'s ``axis``; returns its chunk of the output,
    differentiable in q, k and v. The heads must divide the axis (the
    reference's ValueError). Every rank of the axis must call it."""
    B, H, Sloc, D = q.shape
    group = mesh.group(axis)
    n = max(group.nranks, 1)
    if H % n != 0:
        raise ValueError(f"heads {H} not divisible by '{axis}' size {n}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)

    def seq_to_heads(x):
        return _AllToAll.apply(x, group, 1, 2)

    oh = _local_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal, sm_scale)
    return _AllToAll.apply(oh, group, 2, 1)
