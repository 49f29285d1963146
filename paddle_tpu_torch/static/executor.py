"""Static-graph Executor of the PyTorch port: replay the captured DAG.

Counterpart of ``paddle_tpu/static/executor.py`` (``:24-369``). The
reference composes the DAG into one function of (feeds, params) and
``jax.jit``-compiles forward, gradients and the optimizer update per feed
signature. Here ``_build`` orders the nodes a fetch set needs once per
(program, version, feed names, shapes, dtypes, fetches) and ``run``
replays them one by one on the Executor's device: each node calls the
function it captured (the port's op, which launches the kernels on the
card, or the torch function), gradients come from ``torch.autograd.grad``
from the one loss, and each optimizer's update is the port optimizer's own
rule (``_apply_grad_clip``, ``_accs_for``, ``_update_with_master``) under
``torch.no_grad()``, written into the parameters in place. A replayed op
that fails raises; nothing re-runs the program eagerly.

The device: ``Executor(place)``, or the default device (``cuda`` unless
``set_device("cpu")``) when ``place`` is None; a card asked for and
missing raises. Feeds, and parameters or constants that lie elsewhere,
are moved to it for the replay (an op captured under
``device_guard("cpu")`` runs on the CPU). ``return_numpy`` gives numpy
arrays with a bfloat16 fetch as float32 (the port's convention,
``hapi.model._host``); else tensors on the device.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..core.dtype import numpy_to_torch
from ..core.place import resolve_device
from ..hapi.model import _host
from . import graph as G


class Scope:
    """~ framework/scope.h seen from python: name -> var view over the
    program's persistables."""

    def __init__(self):
        self._extra: Dict[str, np.ndarray] = {}

    def find_var(self, name):
        prog = G.default_main_program()
        try:
            return prog.var(name)
        except KeyError:
            return self._extra.get(name)

    def var(self, name):
        return self.find_var(name)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    yield scope


def _node_inputs(node):
    """The StaticVars a node reads, DynDims' variables included."""
    out = []
    for a in G._leaves([node.args, node.kwargs], []):
        if isinstance(a, G.DynDim):
            out.append(a.var)
        elif isinstance(a, G.StaticVar):
            out.append(a)
    return out


def _order(targets) -> List[G.OpNode]:
    """The nodes the variables ``targets`` need, producers first (an
    iterative depth-first walk; folded and fed variables stop it)."""
    done, expanded, order = set(), set(), []
    stack = [(t, False) for t in reversed(targets)]
    while stack:
        v, finish = stack.pop()
        node = v._node
        if node is None or getattr(v, "_const_value", None) is not None:
            continue
        k = id(node)
        if finish:
            if k not in done:
                done.add(k)
                order.append(node)
            continue
        if k in expanded:
            continue
        expanded.add(k)
        stack.append((v, True))
        for a in reversed(_node_inputs(node)):
            if a._node is not None and id(a._node) not in expanded:
                stack.append((a, False))
    return order


def _resolve(a, env, dev):
    if isinstance(a, G.StaticVar):
        v = env[id(a)]
    elif isinstance(a, G.DynDim):
        return env[id(a.var)].shape[a.axis]
    elif isinstance(a, torch.Tensor):
        v = env.get(id(a), a)
    elif isinstance(a, (list, tuple)):
        vals = [_resolve(e, env, dev) for e in a]
        if isinstance(a, list):
            return vals
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    elif isinstance(a, dict):
        return {k: _resolve(e, env, dev) for k, e in a.items()}
    else:
        return a
    if dev is not None and v.device != dev:
        v = v.to(dev)
    return v


def _run_node(node, env, dev):
    d = node.device or dev
    args = [_resolve(a, env, d) for a in node.args]
    kwargs = {k: _resolve(v, env, d) for k, v in node.kwargs.items()}
    with torch.no_grad() if node.nondiff else contextlib.nullcontext():
        out = node.fn(*args, **kwargs)
    outs = (out,) if node.single else tuple(out)
    for v in node.out_vars:
        env[id(v)] = outs[v._output_index]


def _unfed(var):
    raise RuntimeError(
        f"StaticVar '{var.name}' was not fed (feed slots present: check the "
        "feed dict keys against static.data names)")


def _eval_var(var, env, dev=None):
    """Evaluate ``var`` under ``env`` (id(var-or-param) -> value): its
    producers replayed in order, each value memoized in ``env``."""
    if id(var) in env:
        return env[id(var)]
    const = getattr(var, "_const_value", None)
    if const is not None:
        return const
    if var._node is None:
        _unfed(var)
    _seed_consts([var], env)
    for node in _order([var]):
        if id(node.out_vars[0]) not in env:
            _check_fed(node, env)
            _run_node(node, env, dev)
    return env[id(var)]


def _seed_consts(targets, env):
    """Put the values folded by ``constant_folding`` (``_const_value``)
    of ``targets`` and of the variables they reach into ``env``."""
    reached = list(targets)
    for node in _order(targets):
        reached += _node_inputs(node)
    for a in reached:
        c = getattr(a, "_const_value", None)
        if c is not None and id(a) not in env:
            env[id(a)] = c


def _check_fed(node, env):
    for a in _node_inputs(node):
        if a._node is None and id(a) not in env:
            _unfed(a)


class CompiledProgram:
    """~ fluid.CompiledProgram/compiler.py: a strategy-carrying view
    (``Executor.run`` replays the program either way)."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy

    def __getattr__(self, name):
        return getattr(self._program, name)


class Executor:
    """~ paddle.static.Executor over one device (module docstring)."""

    def __init__(self, place=None):
        self.place = place
        dev = resolve_device(place)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._cache: Dict[tuple, callable] = {}

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_prune=False):
        prog = program if program is not None else G.default_main_program()
        if isinstance(prog, CompiledProgram):
            prog = prog._program
        feed = feed or {}
        fetch_list = fetch_list or []

        # startup program: snapshot/restore parameter init values
        if prog._n_ops == 0 and not prog._opts and not fetch_list:
            self._run_startup(prog)
            return []

        fetch_vars = [self._resolve_fetch(prog, f) for f in fetch_list]
        feed_names, feed_vals = [], []
        for name, v in sorted(feed.items()):
            dv = prog._datas.get(name)
            if dv is None:
                raise KeyError(
                    f"feed key {name!r} does not match any static.data var "
                    f"(have {list(prog._datas)})")
            if not isinstance(v, torch.Tensor):
                v = numpy_to_torch(np.asarray(v))
            feed_names.append(name)
            feed_vals.append(v.to(self._device, dv.dtype))

        key = (prog.id, prog._version, tuple(feed_names),
               tuple((tuple(v.shape), v.dtype) for v in feed_vals),
               tuple(id(f) for f in fetch_vars))
        step = self._cache.get(key)
        if step is None:
            step = self._build(prog, feed_names, fetch_vars)
            self._cache[key] = step
        fetches = step(feed_vals)
        if return_numpy:
            return [_host(f) for f in fetches]
        return fetches

    # ------------------------------------------------------------------
    def _run_startup(self, prog):
        params = prog._params or G.default_main_program()._params
        if prog._param_snapshot is None:
            prog._param_snapshot = {id(p): p.detach().clone()
                                    for p in params}
            return
        with torch.no_grad():
            for p in params:
                snap = prog._param_snapshot.get(id(p))
                if snap is not None:
                    p.copy_(snap)

    def _resolve_fetch(self, prog, f):
        if isinstance(f, str):
            return prog.var(f)
        if isinstance(f, torch.Tensor):
            return f
        raise TypeError(f"bad fetch_list entry: {f!r}")

    @staticmethod
    def _shard_opt_states(prog):
        """The reference places a ZeRO optimizer's states on its mesh
        (``:194-216``); the port refuses it by name."""
        for optimizer, _loss, _ps in prog._opts:
            if getattr(optimizer, "_shard_states_axis", None) or \
                    getattr(optimizer, "_offload_states", False):
                raise NotImplementedError(
                    "a ZeRO optimizer (state sharding or offload) in the "
                    "static Executor is not ported yet: ROADMAP Queue 1 "
                    "item 15, distributed / parallel")

    @staticmethod
    def _opt_params(prog, optimizer, opt_params):
        if opt_params:
            ps = opt_params
        elif optimizer._parameters:
            ps = optimizer._parameters
        else:
            ps = prog._params
        return [p for p in ps if p.requires_grad]

    # ------------------------------------------------------------------
    def _build(self, prog, feed_names, fetch_vars):
        """The replay of one (program, feed signature, fetch set)."""
        self._shard_opt_states(prog)
        dev = self._device
        data_vars = [prog._datas[n] for n in feed_names]
        opt_entries = [(opt, loss, self._opt_params(prog, opt, ps))
                       for opt, loss, ps in prog._opts]
        train = bool(opt_entries)
        grad_fetches = [f for f in fetch_vars if isinstance(f, G.GradVar)]
        need_grads = train or bool(grad_fetches)
        aux_losses = [g.loss for g in grad_fetches]
        assert len({id(loss) for _, loss, _ in opt_entries}
                   | {id(v) for v in aux_losses}) <= 1 or not need_grads, \
            "all grads in one program must flow from a single loss"
        loss_var = (opt_entries[0][1] if train
                    else (aux_losses[0] if aux_losses else None))
        # what the gradients are taken with respect to: every optimizer's
        # parameters and the fetched GradVars' parameters and data
        wrt, seen = [], set()
        for _opt, _loss, ps in opt_entries:
            for p in ps:
                if id(p) not in seen:
                    seen.add(id(p))
                    wrt.append(p)
        for g in grad_fetches:
            if id(g.wrt) not in seen:
                seen.add(id(g.wrt))
                wrt.append(g.wrt)
        diff_feeds = {id(w) for w in wrt if isinstance(w, G.StaticVar)}
        targets = [f for f in fetch_vars if isinstance(f, G.StaticVar)
                   and not isinstance(f, G.GradVar)]
        if loss_var is not None:
            targets.append(loss_var)
        order = _order(targets)
        consts = {}
        _seed_consts(targets, consts)
        fed = {**consts, **{id(dv): None for dv in data_vars}}
        for node in order:
            _check_fed(node, fed)

        def step(feed_vals):
            env = dict(consts)
            for dv, v in zip(data_vars, feed_vals):
                if id(dv) in diff_feeds:
                    v = v.detach().requires_grad_(True)
                env[id(dv)] = v
            with torch.enable_grad() if need_grads else torch.no_grad():
                for node in order:
                    _run_node(node, env, dev)
                grads = {}
                if need_grads:
                    inputs = [env[id(w)] if isinstance(w, G.StaticVar)
                              else w for w in wrt]
                    got = torch.autograd.grad(env[id(loss_var)], inputs,
                                              allow_unused=True)
                    for w, x, g in zip(wrt, inputs, got):
                        grads[id(w)] = torch.zeros_like(x) if g is None \
                            else (g.to_dense() if g.is_sparse else g)
            outs = []
            for f in fetch_vars:
                if isinstance(f, G.GradVar):
                    outs.append(grads[id(f.wrt)])
                elif isinstance(f, G.StaticVar):
                    outs.append(env[id(f)].detach())
                else:  # a concrete tensor: its value before the update
                    outs.append(f.detach().clone() if train else f.detach())
            del env
            if train:
                self._update(opt_entries, grads)
            return outs

        return step

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """~ Executor::RunFromDataset: one ``run`` per batch of
        ``dataset`` (any iterable of feed tuples, in the sorted order of
        the program's ``static.data`` names); returns the last
        fetches."""
        prog = program if program is not None else \
            G.default_main_program()
        if isinstance(prog, CompiledProgram):
            prog = prog._program
        if dataset is None:
            raise ValueError("dataset must be provided")
        feed_names = sorted(prog._datas)
        last = None
        for it, batch in enumerate(dataset):
            if not isinstance(batch, (tuple, list)):
                batch = (batch,)
            last = self.run(prog, feed=dict(zip(feed_names, batch)),
                            fetch_list=fetch_list)
            if debug and fetch_list and it % print_period == 0:
                print(f"[dataset iter {it}] "
                      + " ".join(str(v) for v in last))
        return last

    infer_from_dataset = train_from_dataset

    @staticmethod
    @torch.no_grad()
    def _update(opt_entries, grads):
        """Each optimizer's rule over its parameters (the reference's
        ``:294-309``): float32 gradients, the clip, then the rule on the
        master or the parameter with the optimizer's rate and step."""
        for optimizer, _loss, ps in opt_entries:
            gs = optimizer._apply_grad_clip(
                ps, [grads[id(p)].to(torch.float32) for p in ps])
            scalars = {}
            for p, g in zip(ps, gs):
                if p.device not in scalars:
                    scalars[p.device] = optimizer._scalars(p.device)
                lr, t = scalars[p.device]
                nv, na = optimizer._update_with_master(
                    p, g.to(p.device), optimizer._accs_for(p), lr, t)
                p.copy_(nv)
                optimizer._accumulators[id(p)] = na
            optimizer._step_count += 1
