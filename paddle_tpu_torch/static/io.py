"""``static.save_inference_model`` / ``load_inference_model`` of the
PyTorch port.

Counterpart of ``paddle_tpu/static/io.py`` (``:23-73``): the captured DAG
pruned to feed -> fetch, the parameters frozen in, written as
``jit.save``'s four artifacts with ``.pdmeta`` class ``"StaticProgram"``,
so ``jit.load`` and ``inference.Predictor`` load it. The replay of the
pruned DAG is a ``torch.nn.Module`` holding the parameters and the tensor
constants the nodes read, exported by ``jit.symbolic_export``: the graph
holds the ops replay runs (the flash forward as its ``gqa_fwd``
operator), and -1 feed dimensions become symbolic dimensions shared per
dimension position.

A symbolic sequence length puts a guard on the flash gate (S >= 256 and a
multiple of 128 are read at capture), so an attention program is saved
with a static S and a dynamic batch: ``static.data("ids", [-1, 512])``.
"""
from __future__ import annotations

import io as _io
import os
import pickle

import torch

from ..jit import _numpy_state_of, symbolic_export
from . import graph as G
from .executor import _eval_var, _node_inputs, _order, _seed_consts


class _FrozenProgram(torch.nn.Module):
    """feeds -> fetches by replaying the nodes ``order`` lists; the
    parameters and the tensor constants they read are this module's
    state, so the export freezes them in."""

    def __init__(self, feed_vars, fetch_vars, order):
        super().__init__()
        self._feeds = list(feed_vars)
        self._fetches = list(fetch_vars)
        tensors, seen = [], set()
        for node in order:
            for a in G._leaves([node.args, node.kwargs], []):
                if isinstance(a, torch.Tensor) and \
                        not isinstance(a, G.StaticVar) and id(a) not in seen:
                    seen.add(id(a))
                    tensors.append(a)
        self._ids = [id(t) for t in tensors]
        self.weights = torch.nn.ParameterList(
            [t for t in tensors if isinstance(t, torch.nn.Parameter)])
        self._param_pos = [i for i, t in enumerate(tensors)
                           if isinstance(t, torch.nn.Parameter)]
        self._buffer_pos = []
        for i, t in enumerate(tensors):
            if not isinstance(t, torch.nn.Parameter):
                self.register_buffer(f"c{i}", t.detach())
                self._buffer_pos.append(i)

    def forward(self, *xs):
        env = {id(dv): x for dv, x in zip(self._feeds, xs)}
        for i, w in zip(self._param_pos, self.weights):
            env[self._ids[i]] = w
        for i in self._buffer_pos:
            env[self._ids[i]] = getattr(self, f"c{i}")
        return tuple(_eval_var(f, env) for f in self._fetches)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Write ``path_prefix``'s ``.pdmodel`` (the exported program's text),
    ``.pdexport`` (``torch.export.save`` bytes, weights frozen in),
    ``.pdiparams`` (the program's parameters by name, numpy; bfloat16 as
    the uint16 record) and ``.pdmeta`` (class ``"StaticProgram"``, the
    feed and fetch names)."""
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    prog = program if program is not None else G.default_main_program()
    order = _order(fetch_vars)
    consts = {}
    _seed_consts(fetch_vars, consts)
    fed = {id(v) for v in feed_vars} | set(consts)
    for node in order:
        for a in _node_inputs(node):
            if a._node is None and id(a) not in fed:
                raise ValueError(
                    f"save_inference_model: the fetches read '{a.name}', "
                    "which is not among feed_vars")
    module = _FrozenProgram(feed_vars, fetch_vars, order)
    device = feed_vars[0].device if feed_vars else None
    with torch.no_grad():
        ep = symbolic_export(
            module, [(list(v._shape), v.dtype) for v in feed_vars], device,
            warn_prefix="save_inference_model")
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".pdmodel", "w") as f:
        f.write(str(ep))
    buf = _io.BytesIO()
    torch.export.save(ep, buf)
    with open(path_prefix + ".pdexport", "wb") as f:
        f.write(buf.getvalue())
    state = _numpy_state_of(
        {getattr(p, "param_name", None) or f"param_{i}": p
         for i, p in enumerate(prog._params)})
    with open(path_prefix + ".pdiparams", "wb") as f:
        pickle.dump(state, f, protocol=4)
    with open(path_prefix + ".pdmeta", "wb") as f:
        pickle.dump({"class": "StaticProgram", "has_model": True,
                     "has_export": True,
                     "feed_names": [v.name for v in feed_vars],
                     "fetch_names": [v.name for v in fetch_vars]}, f)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """(program_like, feed_names, fetch_names); the program_like is
    ``jit.load``'s ``TranslatedLayer``, callable on the feed arrays."""
    from ..jit import load as jit_load
    layer = jit_load(path_prefix)
    meta = {}
    if os.path.exists(path_prefix + ".pdmeta"):
        with open(path_prefix + ".pdmeta", "rb") as f:
            meta = pickle.load(f)
    return (layer, meta.get("feed_names", []), meta.get("fetch_names", []))
