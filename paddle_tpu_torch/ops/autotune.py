"""Runtime autotuning with a persistent cache, in the PyTorch port.

Counterpart of ``paddle_tpu/ops/autotune.py:25-147``: ``AutoTuneCache``
((op, shapes and dtypes of the arguments, tag) -> the chosen candidate's
index, with ``export`` / ``load`` as JSON), the flag ``use_autotune`` with
``enable_autotune`` / ``disable_autotune`` / ``autotune_enabled``, and
``autotune``, which times each candidate on the real arguments the first
time a key is seen and keeps the fastest. On the card a candidate is timed
with CUDA events after a warm-up, between two ``torch.cuda.synchronize``;
on the CPU with the host clock. A candidate that raises counts as never
finishing. The reference's ``tuned_flash_attention`` picks TPU block
sizes (VMEM tuning) and is left out (ROADMAP Queue 2).
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, Sequence

import torch

from ..core import flags as _flags

_flags.define_flag("use_autotune", False, "enable runtime kernel autotune")


class AutoTuneCache:
    """(op, signature, tag) -> chosen candidate index (and the timings)."""

    def __init__(self):
        self._cache: Dict[tuple, int] = {}
        self._timings: Dict[tuple, list] = {}
        self.hits = 0
        self.misses = 0

    def key(self, op: str, args, tag: str = "") -> tuple:
        """``tag`` names the candidate list: a stored entry is a bare
        index, so another list must give another key."""
        sig = tuple((tuple(a.shape), str(a.dtype).removeprefix("torch."))
                    for a in args if hasattr(a, "shape"))
        return (op, sig, tag)

    def get(self, key):
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        return None

    def peek(self, key):
        """The entry, without counting a hit or a miss."""
        return self._cache.get(key)

    def put(self, key, idx, timings=None):
        self._cache[key] = idx
        if timings is not None:
            self._timings[key] = timings

    def report(self):
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._cache)}

    def export(self, path: str):
        payload = {json.dumps(list(k)): v for k, v in self._cache.items()}
        with open(path, "w") as f:
            json.dump(payload, f)

    def load(self, path: str):
        def canon(x):
            return (tuple(canon(i) for i in x) if isinstance(x, list)
                    else x)

        with open(path) as f:
            payload = json.load(f)
        for k, v in payload.items():
            parts = json.loads(k)
            op, sig = parts[0], canon(parts[1])
            tag = parts[2] if len(parts) > 2 else ""
            self._cache[(op, sig, tag)] = v


_CACHE = AutoTuneCache()


def cache() -> AutoTuneCache:
    return _CACHE


def enable_autotune():
    _flags.set_flags({"use_autotune": True})


def disable_autotune():
    _flags.set_flags({"use_autotune": False})


def autotune_enabled() -> bool:
    return bool(_flags.get_flag("use_autotune"))


def _time_once(fn: Callable, args, warmup: int = 1, iters: int = 3) -> float:
    """Seconds per call of ``fn(*args)``: CUDA events when an argument is
    on the card, else the host clock; inf when it raises."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    try:
        for _ in range(warmup):
            fn(*args)
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    except Exception:  # noqa: BLE001 — a failing candidate never wins
        return float("inf")


def autotune(op: str, candidates: Sequence[Callable], args,
             default: int = 0, tag: str = "") -> Callable:
    """The fastest of ``candidates`` for these arguments' shapes: off
    (the default) ``candidates[default]``; on, the first call of a key
    times every candidate and later calls hit the cache."""
    if not autotune_enabled() or len(candidates) == 1:
        return candidates[default]
    key = _CACHE.key(op, args, tag)
    idx = _CACHE.get(key)
    if idx is not None:
        return candidates[idx]
    timings = [_time_once(c, args) for c in candidates]
    best = min(range(len(timings)), key=timings.__getitem__)
    if timings[best] == float("inf"):
        best = default
    _CACHE.put(key, best, timings)
    return candidates[best]
