"""paddle_tpu_torch.jit: to_static capture and the deployment export.

Counterpart of ``paddle_tpu/jit/__init__.py`` (~ python/paddle/jit:
dygraph_to_static ProgramTranslator, StaticFunction, PartialProgramLayer).
The reference traces the eager function with ``jax.jit``: the jaxpr is the
Program, XLA the executor, and the program cache is keyed by the input
signature. Here the program is a ``torch.export`` ``ExportedProgram``:

* ``StaticFunction`` captures ``fn`` with a non-strict ``torch.export``
  under ``torch.no_grad()``, its layer's parameters and buffers passed
  as inputs (``torch.func.functional_call``), as the reference passes
  ``params`` on every call (``:129-145``): a cached program always reads
  the layer's current weights, and ``set_state_dict`` leaves none stale.
  The cache key is the reference's signature (``:84-97``): the tree, the
  shape and dtype of each leaf (and its device), the training flag.
  Python scalars in the arguments become 0-d tensor inputs, as ``jax.jit``
  makes them tracers, so one program serves every value. The graph holds
  the ops eager mode runs: aten operators and the port's kernel operators
  (``paddle_tpu_torch::gqa_fwd``), so a captured program launches the
  same kernels and gives the same bits. Running it runs that graph.
* Python control flow is rewritten first by ``dy2static`` (the AST pass),
  whose converters capture ``torch.cond`` / ``while_loop`` for a tensor
  predicate; the capture flag is ``dy2static.capturing()``.
* A capture that fails raises. Nothing re-runs the eager function.
* ``save`` writes the reference's four artifacts (``:281-339``):
  ``.pdmodel`` (the exported program's text), ``.pdiparams`` (the pickled
  numpy state dict; a bfloat16 tensor as the uint16 record of
  ``framework/io.py``), ``.pdexport`` (the bytes of ``torch.export.save``,
  the weights frozen in) and ``.pdmeta``. ``InputSpec`` dimensions of
  None or -1 become one ``torch.export.Dim`` per dimension position,
  shared across inputs (``:249-258``); the example inputs take size 2
  there (torch specializes sizes 0 and 1). A failed symbolic export
  falls back to concrete shapes with the reference's warning
  (``:265-272``). ``load`` refuses a reference ``.pdexport`` (jax bytes)
  by name; its ``.pdiparams`` loads.

``import paddle_tpu_torch`` registers the kernel operators, which a saved
program names; load an artifact after it.

Kept as the reference has them (ROADMAP Queue 3): ``to_static(layer)``
returns the layer itself with the captured forward as
``layer.forward_static`` (calling the layer stays eager);
``TracedLayer.save_inference_model`` never reads ``feed`` / ``fetch``;
``save`` without ``input_spec`` writes no program, and the loaded layer's
forward raises.
"""
from __future__ import annotations

import functools
import inspect
import io
import os
import pickle
import time
import types
import warnings
from typing import Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.dtype import convert_dtype, numpy_to_torch
from ..framework.io import _host_tensor, _record
from ..nn.layer.layers import Layer
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from .dy2static import capturing

__all__ = ["InputSpec", "StaticFunction", "to_static", "not_to_static",
           "ignore_module", "symbolic_export", "save", "load",
           "TranslatedLayer", "ProgramTranslator", "enable_to_static",
           "set_verbosity", "set_code_level", "TracedLayer"]

_SCALARS = (bool, int, float)


class InputSpec:
    """~ paddle.static.InputSpec (python/paddle/static/input.py)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _leaf_key(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device)
    if isinstance(leaf, _SCALARS):
        return ("scalar", type(leaf).__name__)
    # anything else is captured as a constant of the program
    return ("static", type(leaf).__name__, repr(leaf))


def _state_of(layer) -> dict:
    """The parameters and buffers a captured program reads, by name."""
    if layer is None:
        return {}
    out = dict(layer.named_parameters())
    out.update(layer.named_buffers())
    return out


class _Bound(torch.nn.Module):
    """``fn`` (a method of ``layer`` or a function) called directly, as
    the reference calls it (no forward hooks), with ``layer`` (or None)
    as the module ``functional_call`` swaps the inputs' weights into."""

    def __init__(self, layer, fn):
        super().__init__()
        self.layer = layer
        self._fn = fn

    def forward(self, args, kwargs):
        return self._fn(*args, **kwargs)


class _Program(torch.nn.Module):
    """The module ``torch.export`` captures: (weights, tensor leaves) ->
    ``fn``'s output. Holds no weights itself, so the program has none."""

    def __init__(self, bound, spec, leaves):
        super().__init__()
        # kept out of the module tree, so export does not lift its state
        object.__setattr__(self, "_bound", bound)
        self._spec = spec
        self._static = [None if isinstance(v, torch.Tensor) else v
                        for v in leaves]

    def forward(self, params, tensors):
        it = iter(tensors)
        full = [next(it) if s is None else s for s in self._static]
        args, kwargs = pytree.tree_unflatten(full, self._spec)
        return torch.func.functional_call(
            self._bound, {f"layer.{k}": v for k, v in params.items()},
            (args, kwargs))


def _flat_inputs(args, kwargs):
    """The leaves of (args, kwargs), a Python scalar made a 0-d tensor
    (an input of the program, as ``jax.jit`` makes it a tracer), and the
    tree's spec."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    return [torch.tensor(v) if isinstance(v, _SCALARS) else v
            for v in leaves], spec


def _converted(fn):
    """``fn`` after the dy2static pass: ``fn`` itself while the pass is
    off (``ProgramTranslator``) or when its source does not parse."""
    if not ProgramTranslator().enable_to_static:
        return fn
    from .dy2static import convert_to_static
    try:
        if inspect.ismethod(fn):
            return types.MethodType(convert_to_static(fn.__func__),
                                    fn.__self__)
        return convert_to_static(fn)
    except SyntaxError:
        return fn


def _modes(layer):
    return [(m, m.training) for m in layer.modules()] if layer else []


def _restore(modes):
    for m, mode in modes:
        m.training = mode


class StaticFunction:
    """~ dygraph_to_static/program_translator.py StaticFunction:237.

    Wraps an eager function or Layer method; on call, runs the program
    captured for the call's signature (module docstring)."""

    def __init__(self, fn: Callable, input_spec=None,
                 layer: Layer | None = None):
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec
        self._converted_fn = None
        self._run_fn = None
        self._programs: dict = {}
        self._last = None
        # the program-cache ledger behind cache_stats(); _cache_info is
        # the legacy (pre-obs) alias and stays the SAME dict
        self._cache_info = {"hits": 0, "misses": 0, "compiles": 0,
                            "last_compile_s": None}
        self._ctr_hit = _obs_metrics.counter(
            "jit_cache_hits_total", "to_static program-cache hits")
        self._ctr_miss = _obs_metrics.counter(
            "jit_cache_misses_total", "to_static program-cache misses")
        self._hist_compile = _obs_metrics.histogram(
            "jit_compile_seconds", "wall seconds per to_static compile")

    @staticmethod
    def _signature(tree, training: bool):
        """The program-cache key: the tree's structure, each leaf's shape,
        dtype and device (a Python scalar by its type), and the training
        flag."""
        leaves, spec = pytree.tree_flatten(tree)
        return (spec, tuple(_leaf_key(v) for v in leaves), bool(training))

    def cache_stats(self) -> dict:
        """``hits`` / ``misses`` / ``compiles`` (captures: every miss
        captures one program) and ``last_compile_s`` (wall seconds of the
        most recent capture). Mirrored into the obs metrics registry
        (``jit_cache_{hits,misses}_total``, ``jit_compile_seconds``)."""
        return dict(self._cache_info)

    def _capture(self, params, args, kwargs, training):
        """Export ``fn`` (after the dy2static pass, done once) for these
        inputs: an ``ExportedProgram`` of (params, tensor leaves)."""
        if self._run_fn is None:
            self._run_fn = _converted(self._fn)
            if self._run_fn is not self._fn:
                self._converted_fn = self._run_fn
        leaves, spec = _flat_inputs(args, kwargs)
        tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
        layer = self._layer
        prog = _Program(_Bound(layer, self._run_fn), spec, leaves)
        modes = _modes(layer)
        try:
            if layer is not None:
                layer.train(training)
            with torch.no_grad(), capturing():
                return torch.export.export(prog, (params, tensors),
                                           strict=False)
        finally:
            _restore(modes)

    def __call__(self, *args, **kwargs):
        layer = self._layer
        params = _state_of(layer)
        training = layer.training if layer is not None else False
        key = self._signature((params, args, kwargs), training)
        ci = self._cache_info
        prog = self._programs.get(key)
        if prog is not None:
            ci["hits"] += 1
            self._ctr_hit.inc()
        else:
            ci["misses"] += 1
            self._ctr_miss.inc()
            t0 = time.perf_counter()
            ep = self._capture(params, args, kwargs, training)
            prog = self._programs[key] = ep.module()
            self._last = ep
            dt = time.perf_counter() - t0
            ci["compiles"] += 1
            ci["last_compile_s"] = dt
            self._hist_compile.observe(dt)
            tr = _obs_trace.active()
            if tr is not None:
                name = getattr(self._fn, "__qualname__",
                               getattr(self._fn, "__name__", "fn"))
                tr.instant("jit.compile", track="jit", fn=str(name),
                           wall_s=round(dt, 6))
        leaves, _ = _flat_inputs(args, kwargs)
        with torch.no_grad():
            return prog(params, [v for v in leaves
                                 if isinstance(v, torch.Tensor)])

    @property
    def concrete_program(self):
        """The most recently captured ``ExportedProgram``."""
        return self._last

    def get_traced(self, *example_args, **example_kwargs):
        """The ``ExportedProgram`` for these example inputs (not cached),
        for inspection and golden tests."""
        layer = self._layer
        return self._capture(_state_of(layer), example_args, example_kwargs,
                             layer.training if layer is not None else False)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """~ paddle.jit.to_static decorator. A Layer comes back itself, its
    captured forward as ``forward_static`` (the reference's)."""
    def decorate(fn):
        if isinstance(fn, Layer):
            sf = StaticFunction(fn.forward, input_spec, layer=fn)
            fn._static_forward = sf
            fn.forward_static = sf
            return fn
        layer = getattr(fn, "__self__", None)
        sf = StaticFunction(fn, input_spec,
                            layer=layer if isinstance(layer, Layer) else None)
        functools.update_wrapper(sf, fn)
        return sf
    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    return None


def _is_dynamic(d) -> bool:
    return d is None or (isinstance(d, int) and d <= 0)


class _Frozen(torch.nn.Module):
    """``fn`` over ``layer`` with the weights as the program's own state:
    the tokens-only signature of the deployment artifact."""

    def __init__(self, layer, fn):
        super().__init__()
        if layer is not None:
            self.layer = layer
        self._fn = fn

    def forward(self, *xs):
        return self._fn(*xs)


def symbolic_export(module, shapes_dtypes, device=None,
                    warn_prefix="jit.save"):
    """Export ``module`` with ``torch.export``, mapping None/-1 dims to
    symbolic dimensions shared per dim-position (one artifact serves any
    batch/seq size); falls back to concrete example shapes (dynamic dims
    -> 1) when the capture is shape-dependent, with the reference's
    warning.

    ``shapes_dtypes``: list of (shape, dtype) with None/-1 for dynamic
    dims. The shared contract for ``jit.save`` and
    ``static.save_inference_model``."""
    dims, dyn, any_sym = {}, [], False
    for shape, _ in shapes_dtypes:
        spec = {}
        for j, d in enumerate(shape):
            if _is_dynamic(d):
                # one symbol PER DIM POSITION shared across inputs: the
                # common case is a shared batch (and seq) dimension
                spec[j] = dims.setdefault(
                    j, torch.export.Dim(f"_d{j}", min=1))
                any_sym = True
        dyn.append(spec or None)

    def example(fill):
        return tuple(torch.zeros(tuple(fill if _is_dynamic(d) else d
                                       for d in shape),
                                 dtype=convert_dtype(dtype), device=device)
                     for shape, dtype in shapes_dtypes)

    with torch.no_grad(), capturing():
        if any_sym:
            try:
                return torch.export.export(module, example(2), strict=False,
                                           dynamic_shapes={"xs": tuple(dyn)})
            except Exception as e:  # noqa: BLE001 — shape-dependent capture
                warnings.warn(
                    f"{warn_prefix}: symbolic-shape export failed "
                    f"({type(e).__name__}: {str(e)[:120]}); falling back "
                    "to the concrete example shapes — the artifact will "
                    "only accept those exact shapes", stacklevel=2)
        return torch.export.export(module, example(1), strict=False)


def _numpy_state(layer) -> dict:
    """{name: ndarray} of ``layer``'s state dict (``_numpy_state_of``)."""
    return _numpy_state_of(layer.state_dict())


def _numpy_state_of(tensors: dict) -> dict:
    """{name: ndarray} of {name: tensor}; a bfloat16 tensor as
    ``framework/io.py``'s record (its bits as uint16, ``"dtype":
    "bfloat16"``)."""
    out = {}
    for k, v in tensors.items():
        t = v.detach().cpu()
        out[k] = _record(t) if t.dtype == torch.bfloat16 else t.numpy().copy()
    return out


def _device_of(layer):
    for t in layer.parameters() if layer is not None else ():
        return t.device
    return None


def save(layer, path, input_spec=None, **configs):
    """~ paddle.jit.save: the exported program and the weights.

    Writes <path>.pdmodel (the program's text), <path>.pdiparams (the
    pickled numpy state dict), <path>.pdexport (``torch.export.save``
    bytes, weights frozen in) and <path>.pdmeta. Without ``input_spec``
    only the weights and the meta are written (the reference's)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    is_layer = isinstance(layer, torch.nn.Module)
    state = _numpy_state(layer) if is_layer else {}
    text = None
    exported_bytes = None
    if input_spec:
        specs = [s if isinstance(s, InputSpec) else InputSpec(s)
                 for s in input_spec]
        fn = _converted(layer.forward if is_layer else layer)
        module = _Frozen(layer if is_layer else None, fn)
        device = _device_of(layer if is_layer else None)
        ep = symbolic_export(module, [(s.shape, s.dtype) for s in specs],
                             device)
        text = str(ep)
        with open(path + ".pdmodel", "w") as f:
            f.write(text)
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        exported_bytes = buf.getvalue()
        with open(path + ".pdexport", "wb") as f:
            f.write(exported_bytes)
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(state, f, protocol=4)
    meta = {"class": type(layer).__name__,
            "has_model": text is not None,
            "has_export": exported_bytes is not None}
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f)


def _tensor_of(v) -> torch.Tensor:
    if isinstance(v, dict) and v.get("__tensor__"):
        return _host_tensor(v)
    return numpy_to_torch(v)


class TranslatedLayer(Layer):
    """~ paddle.jit.TranslatedLayer — runtime for loaded artifacts.

    ``forward`` runs the loaded ``.pdexport`` program (its weights frozen
    in): the deployment path (the AnalysisPredictor slot)."""

    def __init__(self, state, text=None, exported=None):
        super().__init__()
        self._state = {k: _tensor_of(v) for k, v in state.items()}
        self._text = text
        self._exported = exported
        self._program = exported.module() if exported is not None else None

    def state_dict(self, *a, **kw):
        return dict(self._state)

    @property
    def program(self):
        """The loaded ``ExportedProgram`` (None without one)."""
        return self._exported

    def forward(self, *args):
        if self._program is None:
            raise RuntimeError(
                "no executable artifact was saved (pass input_spec to "
                "jit.save); weights are available via state_dict()")
        with torch.no_grad():
            return self._program(*[a if isinstance(a, torch.Tensor)
                                   else torch.as_tensor(np.asarray(a))
                                   for a in args])


def _is_torch_export(path) -> bool:
    """A ``torch.export.save`` file is a zip archive; the reference's
    ``.pdexport`` is jax.export's flatbuffer."""
    with open(path, "rb") as f:
        return f.read(4) == b"PK\x03\x04"


def load(path, **configs):
    """~ paddle.jit.load: a ``TranslatedLayer`` over the artifacts at
    ``path``. Raises on a reference ``.pdexport`` (jax.export bytes,
    which the port cannot run); the reference's ``.pdiparams`` loads."""
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    text = None
    if os.path.exists(path + ".pdmodel"):
        with open(path + ".pdmodel") as f:
            text = f.read()
    exported = None
    if os.path.exists(path + ".pdexport"):
        if not _is_torch_export(path + ".pdexport"):
            raise ValueError(
                f"{path}.pdexport is not a torch.export archive (a "
                "jax.export artifact of the JAX package?): the port runs "
                "only programs it exported; its .pdiparams weights load "
                "with load_numpy_state_dict")
        with open(path + ".pdexport", "rb") as f:
            exported = torch.export.load(io.BytesIO(f.read()))
    return TranslatedLayer(state, text, exported)


class ProgramTranslator:
    """~ dygraph_to_static/program_translator.py ProgramTranslator:847 —
    process-wide switch for the dy2static pass (singleton)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.enable_to_static = True
        return cls._instance

    @classmethod
    def get_instance(cls):
        return cls()

    def enable(self, enable_to_static: bool):
        self.enable_to_static = bool(enable_to_static)


def enable_to_static(flag: bool = True):
    ProgramTranslator().enable(flag)


_verbosity = 0
_code_level = 0


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """~ paddle.jit.set_verbosity — dy2static transform logging level."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """~ paddle.jit.set_code_level — which transformed code stage to print."""
    global _code_level
    _code_level = int(level)


class TracedLayer:
    """~ paddle.jit.TracedLayer (fluid/dygraph/jit.py): trace a dygraph
    layer into an executable program with example inputs."""

    def __init__(self, static_fn, layer, example_args):
        self._sf = static_fn
        self._layer = layer
        self._example = example_args

    @staticmethod
    def trace(layer, inputs):
        inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        sf = StaticFunction(layer.forward, layer=layer)
        out = sf(*inputs)
        return out, TracedLayer(sf, layer, inputs)

    def __call__(self, *args):
        return self._sf(*args)

    def save_inference_model(self, path, feed=None, fetch=None):
        """Saves the layer with its example inputs' shapes; ``feed`` and
        ``fetch`` are not read (the reference's)."""
        specs = [InputSpec(t.shape, t.dtype) for t in self._example]
        save(self._layer, path, input_spec=specs)

    @property
    def program(self):
        return self._sf.get_traced(*self._example)
