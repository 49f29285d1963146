"""Process-global metrics registry: counters, gauges, fixed-bucket
histograms; Prometheus text exposition + JSONL snapshots. No deps.

The numeric half of the observability layer (the tracing half is
``obs.trace``): long-lived process aggregates that answer "how many /
how much / how long, ever" where a trace answers "what happened to
THIS request". Instrumented call sites (the serving engine, the jit
program cache, ``route_decode``) call ``REGISTRY.counter(...).inc()``
unconditionally; the registry's ``enabled`` flag turns every mutation
into one attribute check + return, which is what the ``obs_overhead``
bench gate prices (tools/bench_gate.py obs: tracing-off overhead on
the serving workload must stay <= 2%).

Naming follows the Prometheus conventions the exposition format
implies: ``*_total`` for counters, ``*_seconds`` for durations,
labels for low-cardinality dimensions (a routing rule, a backend —
never a request id).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

# latency-shaped default buckets (seconds), Prometheus-style
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(items: Iterable[Tuple[str, str]]) -> str:
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}" if body else ""


class _Metric:
    __slots__ = ("name", "labels", "_reg")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 reg: "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._reg = reg


class Counter(_Metric):
    """Monotonic count. ``inc`` is the hot-path call: one enabled
    check, one add."""

    __slots__ = ("value",)

    def __init__(self, name, labels, reg):
        super().__init__(name, labels, reg)
        self.value = 0.0

    def inc(self, n: float = 1.0):
        if not self._reg.enabled:
            return
        if n < 0:
            raise ValueError("counters only go up (use a gauge)")
        self.value += n


class Gauge(_Metric):
    """A value that goes up and down (queue depth, cache size)."""

    __slots__ = ("value",)

    def __init__(self, name, labels, reg):
        super().__init__(name, labels, reg)
        self.value = 0.0

    def set(self, v: float):
        if self._reg.enabled:
            self.value = float(v)

    def inc(self, n: float = 1.0):
        if self._reg.enabled:
            self.value += n

    def dec(self, n: float = 1.0):
        self.inc(-n)


class Histogram(_Metric):
    """Fixed upper-bound buckets (cumulative at exposition), plus
    running sum/count — enough for rate + quantile-bound queries
    without reservoirs or deps."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, name, labels, reg, buckets=None):
        super().__init__(name, labels, reg)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self.counts = [0] * len(bs)  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        if not self._reg.enabled:
            return
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        # above every bound: lands only in the implicit +Inf bucket

    def cumulative(self):
        """[(le, cumulative_count)] including +Inf, exposition order."""
        out, c = [], 0
        for b, n in zip(self.buckets, self.counts):
            c += n
            out.append((b, c))
        out.append((float("inf"), self.count))
        return out


class MetricsRegistry:
    """Get-or-create registry keyed by (name, sorted labels). One
    process-global instance (``REGISTRY``); tests construct private
    ones. ``disable()`` is the kill switch the no-obs baseline arm of
    the overhead bench runs under."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, _Metric] = {}
        self._types: Dict[str, type] = {}
        self._help: Dict[str, str] = {}
        self.enabled = True

    # --- registration -----------------------------------------------------
    def _get(self, cls, name: str, help_: str, labels: dict,
             **kw) -> _Metric:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(f"{name}: already registered as "
                                 f"{type(m).__name__}")
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                prev = self._types.get(name)
                if prev is not None and prev is not cls:
                    raise ValueError(f"{name}: already registered as "
                                     f"{prev.__name__}")
                m = cls(name, key[1], self, **kw)
                self._metrics[key] = m
                self._types[name] = cls
                if help_:
                    self._help[name] = help_
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[tuple] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # --- lifecycle --------------------------------------------------------
    def enable(self):
        self.enabled = True

    def disable(self):
        """Every subsequent inc/set/observe becomes a no-op (the
        registry keeps its metrics; re-enable resumes accumulation)."""
        self.enabled = False

    def reset(self):
        with self._lock:
            self._metrics.clear()
            self._types.clear()
            self._help.clear()

    # --- exposition -------------------------------------------------------
    def expose_text(self) -> str:
        """Prometheus text exposition format (families sorted by name,
        children by label string — deterministic output)."""
        by_name: Dict[str, list] = {}
        for (name, _), m in self._metrics.items():
            by_name.setdefault(name, []).append(m)
        lines = []
        for name in sorted(by_name):
            cls = self._types[name]
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "histogram"}[cls.__name__]
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} {kind}")
            for m in sorted(by_name[name], key=lambda m: m.labels):
                lab = _fmt_labels(m.labels)
                if isinstance(m, Histogram):
                    for le, c in m.cumulative():
                        le_s = "+Inf" if le == float("inf") else \
                            format(le, "g")
                        items = m.labels + (("le", le_s),)
                        lines.append(f"{name}_bucket"
                                     f"{_fmt_labels(items)} {c}")
                    lines.append(f"{name}_sum{lab} "
                                 f"{format(m.sum, 'g')}")
                    lines.append(f"{name}_count{lab} {m.count}")
                else:
                    lines.append(f"{name}{lab} {format(m.value, 'g')}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """One JSON-ready dict: metric name + label string -> value
        (histograms -> {sum, count, buckets})."""
        out = {}
        for (name, labels), m in sorted(self._metrics.items()):
            key = name + _fmt_labels(labels)
            if isinstance(m, Histogram):
                out[key] = {"sum": m.sum, "count": m.count,
                            "buckets": {format(b, "g"): c
                                        for b, c in m.cumulative()
                                        if b != float("inf")},
                            "inf": m.count}
            else:
                out[key] = m.value
        return out

    def write_jsonl(self, path: str, **extra) -> dict:
        """Append one snapshot line (wall-stamped) — the scrape-to-file
        analog of a Prometheus pull."""
        rec = {"ts": round(time.time(), 3), **extra,
               "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "", buckets=None,
              **labels) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets, **labels)
