"""Incident flight recorder: an always-on bounded ring of recent
trace events + metric samples, frozen into a postmortem bundle the
moment an SLO incident fires.

The black-box-recorder pattern: full tracing at production scale is
too heavy to leave on, but the moments you need are exactly the ones
you cannot predict — so keep the LAST N spans and samples in O(1)
memory (two ``deque(maxlen=...)`` rings), and when ``slo.SLOMonitor``
opens an incident, freeze the rings into a replayable bundle on disk:

    <bundle_dir>/<incident-id>/
        incident.json     the typed Incident record
        trace.json        chrome://tracing excerpt (the span ring +
                          thread-name metadata — loads in Perfetto)
        metrics.jsonl     the sample ring, one JSONL line per sample
        requests.json     the offending request ids

Every file is written under the repo's atomic tmp+``os.replace``
discipline, and every value in a bundle comes from the VIRTUAL clock,
so two replays of one seeded trace produce byte-identical bundles
(paths aside). ``load_bundle`` reads it back, tolerating a torn final
``metrics.jsonl`` line via the shared
``workload.iter_jsonl_tolerant`` policy.

Span capture reuses the Tracer mirror seam: ``attach(tr)``
installs the ring as the tracer's event sink (the same pattern that
feeds the profiler's span store), so the recorder sees every span /
instant / counter the engine emits with zero extra instrumentation.
With no tracer attached the span ring stays empty and bundles carry
only samples — the recorder itself never forces tracing on.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import List, Optional

from .slo import _atomic_write


class FlightRecorder:
    """Bounded recent-history rings + the bundle writer.

    ``span_capacity`` / ``sample_capacity`` bound memory regardless of
    run length. ``bundle_dir`` (optional) arms automatic bundle writes
    on incident open (``slo.SLOMonitor`` calls ``on_incident``);
    without it the recorder still rings — ``write_bundle`` can be
    called manually."""

    def __init__(self, *, span_capacity: int = 2048,
                 sample_capacity: int = 2048,
                 bundle_dir: Optional[str] = None):
        if span_capacity < 1 or sample_capacity < 1:
            raise ValueError("ring capacities must be >= 1")
        self._events: deque = deque(maxlen=int(span_capacity))
        self._samples: deque = deque(maxlen=int(sample_capacity))
        self.bundle_dir = bundle_dir
        self.bundles_written: List[str] = []
        self._tracer = None

    # --- feeds -------------------------------------------------------------
    def attach(self, tracer) -> "FlightRecorder":
        """Mirror every event ``tracer`` records into the span ring
        (the mirror seam: ``Tracer.set_sink``)."""
        tracer.set_sink(self.on_event)
        self._tracer = tracer
        return self

    def on_event(self, evt: dict):
        """Tracer sink: one raw trace event (span/instant/counter/
        async begin-end), already timestamped in virtual units."""
        self._events.append(evt)

    def sample(self, name: str, value, t: float,
               source: Optional[str] = None):
        """One metric sample (queue depth, a request's TTFT, ...)."""
        rec = {"t": round(float(t), 6), "name": name,
               "value": round(float(value), 6)}
        if source is not None:
            rec["source"] = source
        self._samples.append(rec)

    # --- freeze ------------------------------------------------------------
    def snapshot(self) -> dict:
        """A frozen copy of both rings (plus the attached tracer's
        track registry, so the chrome excerpt keeps its lane names)."""
        tracks = dict(self._tracer._tracks) \
            if self._tracer is not None else {}
        return {"events": [dict(e) for e in self._events],
                "samples": [dict(s) for s in self._samples],
                "tracks": tracks}

    def _chrome_excerpt(self, snap: dict) -> dict:
        evts: List[dict] = [{"name": "process_name", "ph": "M",
                             "pid": 1, "tid": 0,
                             "args": {"name": "paddle_tpu_flight"}}]
        for name, tid in sorted(snap["tracks"].items(),
                                key=lambda kv: kv[1]):
            evts.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": name}})
        for e in snap["events"]:
            out = dict(e, pid=1, ts=round(e["ts"] * 1e6, 3))
            if "dur" in out:
                out["dur"] = round(out["dur"] * 1e6, 3)
            evts.append(out)
        return {"traceEvents": evts, "displayTimeUnit": "ms"}

    def on_incident(self, incident) -> Optional[str]:
        """``slo.SLOMonitor``'s hook: freeze + write a bundle when
        armed with a ``bundle_dir`` (no-op otherwise — the rings keep
        rolling either way)."""
        if self.bundle_dir is None:
            return None
        return self.write_bundle(incident)

    def write_bundle(self, incident,
                     out_dir: Optional[str] = None) -> str:
        """Freeze the rings and write the four-file postmortem bundle
        for ``incident`` under ``out_dir`` (default
        ``<bundle_dir>/<incident.id>``). Atomic per file; returns the
        bundle directory."""
        base = out_dir if out_dir is not None else \
            os.path.join(self.bundle_dir or ".", incident.id)
        os.makedirs(base, exist_ok=True)
        snap = self.snapshot()
        _atomic_write(os.path.join(base, "incident.json"),
                      json.dumps(incident.to_json(), indent=2) + "\n")
        _atomic_write(os.path.join(base, "trace.json"),
                      json.dumps(self._chrome_excerpt(snap)) + "\n")
        _atomic_write(os.path.join(base, "metrics.jsonl"),
                      "".join(json.dumps(s) + "\n"
                              for s in snap["samples"]))
        _atomic_write(os.path.join(base, "requests.json"),
                      json.dumps({"rids": list(incident.rids)},
                                 indent=2) + "\n")
        self.bundles_written.append(base)
        return base


def load_bundle(path: str) -> dict:
    """Read a bundle back: ``{"incident", "trace_events", "samples",
    "rids"}``. ``metrics.jsonl`` loads through the shared tolerant
    JSONL policy (a torn final line — the file a crashing process
    leaves — warns and yields the valid prefix; an earlier tear
    raises). Missing optional files load as empty."""
    from ..serving.workload import iter_jsonl_tolerant
    from .slo import Incident
    with open(os.path.join(path, "incident.json")) as f:
        incident = Incident.from_json(json.load(f))
    out = {"incident": incident, "trace_events": [], "samples": [],
           "rids": []}
    tp = os.path.join(path, "trace.json")
    if os.path.exists(tp):
        with open(tp) as f:
            out["trace_events"] = json.load(f).get("traceEvents", [])
    mp = os.path.join(path, "metrics.jsonl")
    if os.path.exists(mp) and os.path.getsize(mp):
        out["samples"] = list(iter_jsonl_tolerant(mp))
    rp = os.path.join(path, "requests.json")
    if os.path.exists(rp):
        with open(rp) as f:
            out["rids"] = json.load(f).get("rids", [])
    return out
