"""Graph passes over the captured Program DAG of the PyTorch port.

Counterpart of ``paddle_tpu/static/passes.py`` (``:21-153``; ~ the
reference's ir ``Pass`` / ``PassRegistry``): the registry and
``apply_pass``, dead code elimination, constant folding (outputs of ops no
feed reaches become ``_const_value``, which the Executor reads instead of
replaying them), ``freeze_feed`` and the ``op_stats`` histogram. Ops
without a symbolic input never reach the program at all: they run when
the program is built (capture-time folding of pure constants).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .executor import _node_inputs
from .graph import DynDim, Program, StaticVar

PASS_REGISTRY: Dict[str, Callable] = {}


def register_pass(name: str):
    """~ REGISTER_PASS(name, class) ir/pass.h:317."""
    def deco(fn):
        PASS_REGISTRY[name] = fn
        fn.pass_name = name
        return fn
    return deco


def apply_pass(program: Program, name: str, **kwargs):
    """~ Pass::Apply(graph)."""
    if name not in PASS_REGISTRY:
        raise KeyError(f"no pass registered under {name!r}; "
                       f"have {sorted(PASS_REGISTRY)}")
    return PASS_REGISTRY[name](program, **kwargs)


def apply_build_strategy(program: Program, build_strategy=None,
                         fetch_vars=None):
    """The standard pipeline (~ a BuildStrategy-driven pass list)."""
    return {"dead_ops_removed": apply_pass(
                program, "dead_code_elimination", fetch_vars=fetch_vars),
            "ops_folded": apply_pass(program, "constant_folding")}


def _reachable_nodes(fetch_vars) -> set:
    seen, stack = set(), []
    for v in fetch_vars or []:
        if getattr(v, "_node", None) is not None:
            stack.append(v._node)
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.extend(a._node for a in _node_inputs(node)
                     if a._node is not None)
    return seen


@register_pass("dead_code_elimination")
def dead_code_elimination(program: Program, fetch_vars=None) -> int:
    """Drop the captured vars whose producing ops reach no fetch target;
    returns how many."""
    if not fetch_vars:
        return 0
    live = _reachable_nodes(fetch_vars)
    dead = [name for name, v in program._vars.items()
            if v._node is not None and id(v._node) not in live]
    for name in dead:
        del program._vars[name]
    program._version += 1
    return len(dead)


def _const_arg(a):
    """(ok, value) of an argument when no feed reaches it."""
    if isinstance(a, StaticVar):
        cv = getattr(a, "_const_value", None)
        return (cv is not None), cv
    if isinstance(a, DynDim):
        cv = getattr(a.var, "_const_value", None)
        return (cv is not None), (None if cv is None else cv.shape[a.axis])
    if isinstance(a, torch.nn.Parameter):
        return False, None
    if isinstance(a, (list, tuple)):
        vals = []
        for e in a:
            ok, v = _const_arg(e)
            if not ok:
                return False, None
            vals.append(v)
        return True, (vals if isinstance(a, list) else tuple(vals))
    if isinstance(a, dict):
        vals = {}
        for k, e in a.items():
            ok, v = _const_arg(e)
            if not ok:
                return False, None
            vals[k] = v
        return True, vals
    return True, a


@register_pass("constant_folding")
def constant_folding(program: Program) -> int:
    """Evaluate the ops no feed slot reaches: their outputs become
    constants (``_const_value``). Parameters are not constants: they
    change across steps. Returns the number of folded ops."""
    folded, seen = 0, set()
    # program._vars is insertion-ordered = topological
    for v in list(program._vars.values()):
        node = v._node
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if getattr(node.out_vars[0], "_const_value", None) is not None:
            continue
        ok, args = _const_arg(list(node.args))
        ok2, kwargs = _const_arg(dict(node.kwargs)) if ok else (False, None)
        if not (ok and ok2):
            continue
        try:
            with torch.no_grad():
                out = node.fn(*args, **kwargs)
        except Exception:  # noqa: BLE001 — left to the Executor
            continue
        outs = (out,) if node.single else tuple(out)
        for ov in node.out_vars:
            ov._const_value = outs[ov._output_index]
        folded += 1
    program._version += 1
    return folded


def freeze_feed(var, value):
    """Bind a feed slot to a fixed value so constant_folding can collapse
    everything downstream of it (on the variable's device)."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    var._const_value = t.to(var.device, var.dtype)
    return var


@register_pass("op_stats")
def op_stats(program: Program) -> Dict[str, int]:
    """Analysis pass: the op-name histogram."""
    counts: Dict[str, int] = {}
    seen = set()
    for v in program._vars.values():
        node = v._node
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        counts[node.name] = counts.get(node.name, 0) + 1
    return counts

