"""Structured control flow of the PyTorch port, eager and captured.

Counterpart of ``paddle_tpu/ops/control_flow.py`` (``cond`` :29,
``while_loop`` :50, ``scan`` :74, ``case`` :87, ``switch_case`` :98).

Eagerly (a concrete predicate) the chosen branch runs, and autograd
records through it. While ``jit`` captures a program (the capture flag
of ``jit.dy2static``), a tensor predicate goes through dy2static's
converters, as the reference lowers it to ``lax.cond`` / ``while_loop``
/ ``switch``: ``cond`` and ``case`` become ``torch.cond``, ``while_loop``
``torch._higher_order_ops.while_loop``, ``switch_case`` a chain of
``torch.cond`` over the index clipped to the branches (the reference's
``lax.switch`` of the clipped index, its dict keys taken in sorted order
and ``default`` unread). ``scan`` runs ``body_fn`` over the leading axis
of ``xs`` (a tensor or a tuple / list of them), static in a captured
program too, and stacks the per-step outputs: the reference's result
structure.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["cond", "while_loop", "scan", "case", "switch_case"]


_converters = None


def _cv():
    """dy2static's converters, imported at the first call (``jit`` imports
    this package) and kept: a branch that dynamo traces reads a global."""
    global _converters
    if _converters is None:
        from ..jit.dy2static import convert_operators
        _converters = convert_operators
    return _converters


def _captured(v) -> bool:
    return isinstance(v, torch.Tensor) and _cv().is_capturing()


def _truth(v) -> bool:
    return bool(v.item()) if isinstance(v, torch.Tensor) else bool(v)


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    if _captured(pred):
        return _cv().captured_cond(pred, true_fn, false_fn, operands)
    return true_fn(*operands) if _truth(pred) else false_fn(*operands)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence):
    loop_vars = list(loop_vars)
    cv = _cv()
    if cv.is_capturing() and any(isinstance(v, torch.Tensor)
                                 for v in _leaves(loop_vars)):
        return list(cv.convert_while_loop(lambda c: cond_fn(*c),
                                          lambda c: body_fn(*c),
                                          tuple(loop_vars)))
    while _truth(cond_fn(*loop_vars)):
        loop_vars = list(body_fn(*loop_vars))
    return loop_vars


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _stack(ys):
    first = ys[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[i] for y in ys])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return torch.stack(ys) if isinstance(first, torch.Tensor) else ys


def scan(body_fn: Callable, init, xs, length=None):
    """carry, y = body_fn(carry, x) for each x along xs's leading axis;
    returns (the last carry, the stacked ys)."""
    n = int(length) if xs is None else _leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        x = None if xs is None else _tree_map(lambda t: t[i], xs)
        carry, y = body_fn(carry, x)
        ys.append(y)
    return carry, _stack(ys) if ys else ys


def case(pred_fn_pairs, default=None):
    pairs = list(pred_fn_pairs)
    for j, (pred, fn) in enumerate(pairs):
        if _captured(pred):
            # the rest of the chain becomes the false branch
            return _cv().captured_cond(
                pred, fn, lambda: case(pairs[j + 1:], default))
        if _truth(pred):
            return fn()
    if default is not None:
        return default()
    raise ValueError("no branch taken and no default given")


def _switch(index, fns):
    """fns[index] with ``index`` a captured tensor already in range."""
    if len(fns) == 1:
        return fns[0]()
    return _cv().captured_cond(index == 0, fns[0],
                               lambda: _switch(index - 1, fns[1:]))


def switch_case(branch_index, branch_fns, default=None):
    if _captured(branch_index):
        fns = ([branch_fns[k] for k in sorted(branch_fns)]
               if isinstance(branch_fns, dict) else list(branch_fns))
        return _switch(branch_index.clamp(0, len(fns) - 1), fns)
    i = int(branch_index.item()) if isinstance(branch_index, torch.Tensor) \
        else int(branch_index)
    if isinstance(branch_fns, dict):
        fn = branch_fns.get(i)
        if fn is not None:
            return fn()
        if default is not None:
            return default()
        raise ValueError(f"branch {i} not found")
    fns = list(branch_fns)
    if 0 <= i < len(fns):
        return fns[i]()
    if default is not None:
        return default()
    raise IndexError(f"branch index {i} out of range")
