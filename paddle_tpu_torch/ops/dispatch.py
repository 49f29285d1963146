"""Op dispatch of the PyTorch port: the by-name hook every ``nn.functional``
entry point goes through.

Counterpart of ``paddle_tpu/ops/dispatch.py:78-170`` (``OP_REGISTRY``,
``def_op``, ``apply_op``). Autograd is torch's own, so there is no tape
and no recorded node; what the dispatch keeps of the reference's is:

* the amp cast by op name (``:104-105``): under ``amp.auto_cast`` the
  op's positional tensor arguments are cast by ``amp._maybe_cast``
  before ``fn`` runs;
* an ``op::{name}`` span on the ``ops`` track of the ``obs`` tracer
  while one is active (``:85-95``);
* the nan / inf scan of the op's floating outputs under
  ``FLAGS_check_nan_inf`` (``:52-58``).

The reference's ``fn`` is raw ``jnp`` and never dispatched again; here an
entry point may call another (``F.linear`` calls ``ops.linalg.matmul``).
So ``fn`` runs with amp suspended and the dispatch bypassed for the ops it
calls (a thread-local depth): a nested op is neither cast a second time
nor counted as an op of its own. With amp off and nothing watching (no
static mode, no tracer, no nan / inf flag, no ``census``), ``apply_op``
calls ``fn`` after one thread-local read and four module-level reads.

``census()`` records each dispatched op's input dtypes (after the amp
cast) and output dtypes by name, the measure the tests and
``chip_smoke.py`` hold against the reference's.
The static-graph capture (``:38-39``, ``:100-102``): while
``STATIC_MODE`` is on (``paddle.enable_static()``), an op with a
``static.StaticVar`` among its positional arguments is appended to the
default main program by ``static.graph.capture`` under its name, before
any amp cast, and returns symbolic outputs; the torch functions and
methods called on a ``StaticVar`` directly are captured by the
variable's ``__torch_function__``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable

import torch

from ..core import flags as _flags
from ..obs import trace as _trace

__all__ = ["apply_op", "def_op", "OP_REGISTRY", "census"]

# name -> api function of the ops made with ``def_op``
OP_REGISTRY: dict[str, Callable] = {}


class _State(threading.local):
    amp = None      # the auto_cast state (amp.auto_cast), or None
    depth = 0       # > 0 while an op's fn runs


_state = _State()
_census = None      # {op name: [output dtype names, ...]} while recording
_check = _flags._values
# set by static.enable_static(): an op whose positional arguments hold a
# StaticVar is captured into the default main program instead of run
STATIC_MODE = False


def _watching() -> bool:
    return (STATIC_MODE or _census is not None or _trace._active is not None
            or _check["check_nan_inf"])


def apply_op(name: str, fn: Callable, *args, nondiff: bool = False,
             **kwargs):
    """Run ``fn(*args, **kwargs)`` as the op ``name``. Positional tensor
    arguments are the op's data inputs (cast under amp); keyword arguments
    are its attributes. ``nondiff``: the outputs carry no gradient."""
    st = _state
    if st.amp is None and (st.depth or not _watching()):
        if nondiff:
            with torch.no_grad():
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)
    return _apply_watched(st, name, fn, args, kwargs, nondiff)


def _apply_watched(st, name, fn, args, kwargs, nondiff):
    if STATIC_MODE and any(getattr(a, "_symbolic", False) for a in args):
        from ..static import graph as _sg
        return _sg.capture(name, fn, args, kwargs, nondiff=nondiff)
    amp = st.amp
    if amp is not None:
        from .. import amp as _amp
        args = _amp._maybe_cast(name, args, amp)
    tracer = _trace._active
    t0 = tracer.now() if tracer is not None else None
    st.amp, st.depth = None, st.depth + 1
    try:
        with torch.no_grad() if nondiff else contextlib.nullcontext():
            out = fn(*args, **kwargs)
    finally:
        st.amp, st.depth = amp, st.depth - 1
    if tracer is not None:
        tracer.add_span(f"op::{name}", t0, tracer.now() - t0, track="ops")
    outs = out if isinstance(out, (tuple, list)) else (out,)
    tensors = [o for o in outs if isinstance(o, torch.Tensor)]
    if _census is not None:
        _census.setdefault(name, []).append(
            (_dtypes(args), _dtypes(tensors)))
    if _check["check_nan_inf"]:
        for t in tensors:
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"nan/inf detected in output of op '{name}' "
                    "(FLAGS_check_nan_inf=1)")
    return out


def _dtypes(vals):
    return tuple(str(v.dtype).removeprefix("torch.") for v in vals
                 if isinstance(v, torch.Tensor))


@contextlib.contextmanager
def census():
    """Record, while open, every dispatched op's dtypes: yields {op name:
    [(its tensor inputs' dtype names after the amp cast, its tensor
    outputs'), one pair per call in order]}. Ops nested inside another
    op's function are not recorded."""
    global _census
    prev, _census = _census, {}
    try:
        yield _census
    finally:
        _census = prev


def def_op(name: str | None = None, nondiff: bool = False):
    """Decorator making ``fn`` a registered op: its positional arguments
    are the data inputs, its keyword arguments the attributes;
    ``nondiff``: its outputs carry no gradient."""
    def deco(fn):
        opname = name or fn.__name__

        @functools.wraps(fn)
        def api(*args, **kwargs):
            return apply_op(opname, fn, *args, nondiff=nondiff, **kwargs)

        api.raw_fn = fn
        api.op_name = opname
        OP_REGISTRY[opname] = api
        return api
    return deco

