"""Typed global flags of the PyTorch port.

Counterpart of ``paddle_tpu/core/flags.py``: one registry of typed
defaults, each overridden at definition by the environment variable
``FLAGS_<name>``, read with ``get_flags`` / ``get_flag`` and written with
``set_flags`` (which coerces to the flag's type and refuses an unknown
name with KeyError). The port defines the flags its code reads:
``check_nan_inf`` (``ops.dispatch``: scan each dispatched op's floating
outputs for nan / inf and raise FloatingPointError) and
``context_parallel_backend`` (the Llama attention under a "sep" axis:
``"ring"`` or ``"ulysses"``). The reference's other flags steer XLA or the
TPU, or time its eager ops, and have no counterpart here yet.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}
# lock-free mirror of the values for the dispatch's hot path (dict reads
# are atomic under the GIL; every write below keeps it in step)
_values: Dict[str, Any] = {}


class _Flag:
    __slots__ = ("name", "value", "type", "help")

    def __init__(self, name: str, value: Any, typ: type, help: str):
        self.name = name
        self.value = value
        self.type = typ
        self.help = help


def _coerce(typ: type, raw: Any) -> Any:
    if typ is bool and isinstance(raw, str):
        return raw.lower() in ("1", "true", "yes", "on")
    return typ(raw)


def define_flag(name: str, default: Any, help: str = "",
                typ: type | None = None) -> None:
    typ = typ or type(default)
    env = os.environ.get(f"FLAGS_{name}")
    value = _coerce(typ, env) if env is not None else default
    with _lock:
        _registry[name] = _Flag(name, value, typ, help)
        _values[name] = value


def get_flags(names=None) -> Dict[str, Any]:
    with _lock:
        if names is None:
            return {k: f.value for k, f in _registry.items()}
        if isinstance(names, str):
            names = [names]
        return {n: _registry[n].value for n in names}


def get_flag(name: str) -> Any:
    return _values[name]


def set_flags(flags: Dict[str, Any]) -> None:
    with _lock:
        for name, value in flags.items():
            if name not in _registry:
                raise KeyError(f"unknown flag {name!r}")
            f = _registry[name]
            f.value = _coerce(f.type, value)
            _values[name] = f.value


define_flag("check_nan_inf", False,
            "scan op outputs for nan/inf after each dispatched op")
define_flag("context_parallel_backend", "ring",
            "sequence-parallel attention impl: ring (KV ppermute, any head "
            "count) | ulysses (two all-to-alls, needs heads % sep == 0)")
