"""Structured control flow of the PyTorch port: the eager branch.

Counterpart of ``paddle_tpu/ops/control_flow.py`` (``cond`` :29,
``while_loop`` :50, ``scan`` :74, ``case`` :87, ``switch_case`` :98) with
a concrete predicate: the chosen branch runs, and autograd records
through it. The reference's traced branch (``lax.cond`` / ``while_loop``
/ ``scan`` / ``switch`` under ``jit``) belongs to ``jit`` (ROADMAP Queue 1
item 14) and is not ported. ``scan`` runs ``body_fn`` over the leading
axis of ``xs`` (a tensor or a tuple / list of them) and stacks the
per-step outputs.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["cond", "while_loop", "scan", "case", "switch_case"]


def _truth(v) -> bool:
    return bool(v.item()) if isinstance(v, torch.Tensor) else bool(v)


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    return true_fn(*operands) if _truth(pred) else false_fn(*operands)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence):
    loop_vars = list(loop_vars)
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
    for pred, fn in pred_fn_pairs:
        if _truth(pred):
            return fn()
    if default is not None:
        return default()
    raise ValueError("no branch taken and no default given")


def switch_case(branch_index, branch_fns, default=None):
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
