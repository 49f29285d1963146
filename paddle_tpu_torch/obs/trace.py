"""Request-scoped tracing: named tracks, nested spans, async request
lifecycles, chrome://tracing JSON export.

Dapper-style (Sigelman et al., 2010) host-side tracing for the serving
stack: a ``Tracer`` collects timestamped events on named TRACKS (the
chrome-trace "thread" axis — the engine uses one track per decode slot
and one per tenant), and exports them as a chrome://tracing /
Perfetto-loadable JSON object. Timestamps come from a pluggable clock
so the serving engine's VIRTUAL clock (``EngineClock``) and wall time
(``time.perf_counter``) both work; durations are stored in clock
units (seconds for wall/measured clocks) and scaled to microseconds at
export, which is what the chrome trace format expects.

Event kinds map onto chrome trace phases:

- ``span`` / ``add_span``  -> complete events (ph "X"): nested work on
  one track (prefill, decode_n, a dense wave). Same-track spans must
  nest (contained or disjoint) — the engine emits them from a single
  sequential loop, so they do by construction.
- ``async_begin``/``async_end`` -> async events (ph "b"/"e"): REQUEST
  ROOT SPANS, which overlap freely on a tenant track (request B
  arrives before request A finishes).
- ``instant`` -> instant events (ph "i"): scheduler decisions (admit
  wave, shed, degrade), jit compiles.
- ``counter`` -> counter events (ph "C"): queue depth over time.

A process-global ACTIVE tracer (``use``/``activate``/``active``) lets
layers that cannot be threaded a tracer handle (the jit program cache,
``route_decode``) attach events to whatever trace is being recorded;
when none is active they fall through at the cost of one ``is None``
check. ``trace_id`` rides a contextvar: ``trace_scope(rid)`` tags
every span recorded inside with the owning request.

The port has no profiler span store yet, so spans are not mirrored into
one (the reference feeds its profiler's store from ``add_span``).
"""
from __future__ import annotations

import contextvars
import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

_trace_id: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_obs_trace_id", default=None)


def get_trace_id() -> Optional[str]:
    """The request id owning the current context (None outside one)."""
    return _trace_id.get()


@contextmanager
def trace_scope(trace_id: str):
    """Tag every span/instant recorded inside with ``trace_id``."""
    tok = _trace_id.set(trace_id)
    try:
        yield
    finally:
        _trace_id.reset(tok)


class Tracer:
    """One trace: an event list plus a track-name -> tid registry.

    ``clock``: zero-arg callable returning the current time in this
    trace's units (default ``time.perf_counter``). The serving engine
    swaps in its virtual clock for the duration of a run.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.perf_counter
        self._events: List[dict] = []
        self._tracks: Dict[str, int] = {}
        # the mirror seam: an optional per-event sink (the incident
        # flight recorder's bounded ring) fed alongside the event
        # list — one is-None check per recorded event, nothing when
        # tracing is off (no events are recorded at all then)
        self._sink: Optional[Callable[[dict], None]] = None

    # --- clock / tracks ---------------------------------------------------
    def set_clock(self, clock: Callable[[], float]):
        self._clock = clock

    def now(self) -> float:
        return self._clock()

    def track(self, name: str) -> int:
        """tid for a named track (assigned in first-use order, so track
        layout in the viewer follows instrumentation order)."""
        tid = self._tracks.get(name)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[name] = tid
        return tid

    def set_sink(self, sink: Optional[Callable[[dict], None]]):
        """Install (or clear, with None) the per-event mirror sink —
        ``obs.flight.FlightRecorder.attach`` uses this to keep a
        bounded ring of the most recent events."""
        self._sink = sink

    def _emit(self, evt: dict):
        self._events.append(evt)
        if self._sink is not None:
            self._sink(evt)

    # --- event emission ---------------------------------------------------
    def _args(self, attrs: dict) -> dict:
        tid = _trace_id.get()
        if tid is not None and "trace_id" not in attrs:
            attrs = dict(attrs, trace_id=tid)
        return attrs

    def add_span(self, name: str, t0: float, dur: float,
                 track: str = "main", **attrs):
        """A complete span with explicit start/duration (clock units)."""
        self._emit({"name": name, "ph": "X", "ts": t0,
                    "dur": max(dur, 0.0),
                    "tid": self.track(track),
                    "args": self._args(attrs)})

    @contextmanager
    def span(self, name: str, track: str = "main", **attrs):
        """Context-managed span on this tracer's clock."""
        t0 = self.now()
        try:
            yield self
        finally:
            self.add_span(name, t0, self.now() - t0, track=track, **attrs)

    def instant(self, name: str, t: Optional[float] = None,
                track: str = "main", **attrs):
        self._emit({"name": name, "ph": "i",
                    "ts": self.now() if t is None else t,
                    "s": "t", "tid": self.track(track),
                    "args": self._args(attrs)})

    def counter(self, name: str, value: float,
                t: Optional[float] = None, track: str = "counters"):
        self._emit({"name": name, "ph": "C",
                    "ts": self.now() if t is None else t,
                    "tid": self.track(track),
                    "args": {"value": value}})

    def async_begin(self, name: str, id_: str,
                    t: Optional[float] = None, track: str = "main",
                    cat: str = "request", **attrs):
        """Open an async (overlap-capable) span, e.g. a request root."""
        self._emit({"name": name, "ph": "b", "cat": cat,
                    "id": str(id_),
                    "ts": self.now() if t is None else t,
                    "tid": self.track(track),
                    "args": self._args(attrs)})

    def async_end(self, name: str, id_: str,
                  t: Optional[float] = None, track: str = "main",
                  cat: str = "request", **attrs):
        self._emit({"name": name, "ph": "e", "cat": cat,
                    "id": str(id_),
                    "ts": self.now() if t is None else t,
                    "tid": self.track(track),
                    "args": self._args(attrs)})

    # --- introspection / export -------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def clear(self):
        """Empty the trace — events AND track registrations (a reused
        tracer must not export ghost tracks from a previous run; tids
        are re-derived on first use)."""
        self._events.clear()
        self._tracks.clear()

    def to_chrome(self, pid: int = 1,
                  process_name: str = "paddle_tpu") -> dict:
        """The chrome://tracing JSON object (ts/dur in microseconds)."""
        evts: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name}}]
        for name, tid in sorted(self._tracks.items(),
                                key=lambda kv: kv[1]):
            evts.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": name}})
            evts.append({"name": "thread_sort_index", "ph": "M",
                         "pid": pid, "tid": tid,
                         "args": {"sort_index": tid}})
        for e in self._events:
            out = dict(e, pid=pid, ts=round(e["ts"] * 1e6, 3))
            if "dur" in out:
                out["dur"] = round(out["dur"] * 1e6, 3)
            evts.append(out)
        return {"traceEvents": evts,
                "displayTimeUnit": "ms"}

    def export(self, path: str, pid: int = 1,
               process_name: str = "paddle_tpu") -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(pid, process_name), f)
        return path


# --- the process-global active tracer -----------------------------------
_active: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    """The tracer currently recording, or None (the common, free case)."""
    return _active


def activate(tracer: Tracer):
    global _active
    _active = tracer


def deactivate():
    global _active
    _active = None


@contextmanager
def use(tracer: Optional[Tracer]):
    """Install ``tracer`` as the process-global active tracer for the
    duration (None is allowed and is a no-op, so call sites need no
    branch)."""
    global _active
    prev = _active
    if tracer is not None:
        _active = tracer
    try:
        yield tracer
    finally:
        _active = prev
