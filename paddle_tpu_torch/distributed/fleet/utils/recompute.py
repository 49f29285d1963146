"""Activation recompute (gradient checkpointing) for the PyTorch port.

Counterpart of ``paddle_tpu/distributed/fleet/utils/recompute.py``
(``recompute``, ``recompute_sequential``). The forward of a segment runs
without a graph (``torch.no_grad``: none of its activations is kept);
one autograd node stands for it, whose backward re-runs the segment with
grad enabled and backpropagates the output gradients through the fresh
graph. Parameters the segment uses receive their gradients there, as in
a plain backward (``.grad`` accumulates); the inputs' gradients go back
to the outer graph. With ``preserve_rng_state`` the port's default
generator (``core.generator``: the seed and every device's torch state)
is put back where the forward found it before the re-run, and where the
re-run found it after, so that dropout masks match and later draws are
those of a run without recompute.

As in the reference, the node's gradients reach parameters by
accumulation into ``.grad``: drive it with ``backward()``.
"""
from __future__ import annotations

import torch

from ....core import generator as _gen


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, function, preserve_rng_state, kwargs, _anchor, *args):
        ctx.function, ctx.kwargs = function, kwargs
        ctx.rng = _gen.get_rng_state() if preserve_rng_state else None
        ctx.tensor_at = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.others = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        outputs = function(*args, **kwargs)
        ctx.single = torch.is_tensor(outputs)
        return outputs if ctx.single else tuple(outputs)

    @staticmethod
    def backward(ctx, *grads):
        args = list(ctx.others)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(t.requires_grad)
        if ctx.rng is not None:
            after = _gen.get_rng_state()
            _gen.set_rng_state(ctx.rng)
        try:
            with torch.enable_grad():
                outputs = ctx.function(*args, **ctx.kwargs)
        finally:
            if ctx.rng is not None:
                _gen.set_rng_state(after)
        outputs = [outputs] if ctx.single else list(outputs)
        pairs = [(o, g) for o, g in zip(outputs, grads)
                 if torch.is_tensor(o) and o.requires_grad and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, None, None, None) + tuple(
            a.grad if torch.is_tensor(a) and a.requires_grad else None
            for a in args)


def recompute(function, *args, preserve_rng_state: bool = True, **kwargs):
    """``function(*args, **kwargs)``, its activations dropped and
    recomputed in the backward (``fleet.utils.recompute``)."""
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    # makes the node's outputs require grad also when no input does: the
    # segment's parameters still receive their gradients
    anchor = torch.empty(0, requires_grad=True)
    return _Recompute.apply(function, bool(preserve_rng_state), kwargs,
                            anchor, *args)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``functions`` (a ``Sequential`` or a list of layers) in
    ``ctx["segments"]`` recomputed segments (the reference's
    ``recompute_sequential``)."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    seg_size = max(1, len(funcs) // segments)
    out = args
    for s in range(0, len(funcs), seg_size):
        chunk = funcs[s:s + seg_size]

        def run_chunk(*a, _chunk=chunk):
            o = a
            for f in _chunk:
                o = f(*o) if isinstance(o, tuple) else (f(o),)
            return o[0] if len(o) == 1 else o

        out = recompute(run_chunk,
                        *(out if isinstance(out, tuple) else (out,)))
        if not isinstance(out, tuple):
            out = (out,)
    return out[0] if isinstance(out, tuple) and len(out) == 1 else out
