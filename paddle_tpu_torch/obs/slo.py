"""Streaming SLO evaluation: declarative rules over the signals the
serving stack already emits, firing typed ``Incident`` objects.

The passive spine is ``obs.trace`` / ``obs.metrics``; this is
the layer that EVALUATES it — the SRE half of observability (Google
SRE workbook ch. 5: multi-window burn-rate alerts over an error
budget), built for the repo's virtual-clock harness: every timestamp
is virtual, every evaluation order deterministic, so one seeded chaos
replay yields the SAME incident set byte-for-byte, twice.

Three rule kinds, all frozen declarative dataclasses (a rule object
carries no state, so one rule list can parameterize N per-replica
monitors):

- ``ThresholdRule``: a signal (a gauge sample like ``queue_depth``, or
  a per-request field like ``ttft``) breaches a bound, optionally
  sustained for ``for_units`` of virtual time. Fires once per breach
  episode; recovery closes the incident and re-arms.
- ``BurnRateRule``: multi-window burn rate over an error budget. With
  objective ``o`` (target good fraction), the error budget rate is
  ``1 - o``; over each trailing window the observed error rate divided
  by the budget rate is the BURN. The rule fires only when EVERY
  window burns above its threshold (the long window proves it is
  real, the short window proves it is still happening) with at least
  ``min_events`` in the shortest window — the standard fast+slow
  multiwindow alert, evaluated streaming on the virtual clock.
- ``HeartbeatRule``: the watched source has been silent (no heartbeat,
  no signal at all) for ``timeout`` units. A stalled-but-alive replica
  keeps answering probes and never trips this; a crashed one goes
  silent and does.

``SLOMonitor`` consumes the streams: per-request completion records
(``MetricsCollector`` feeds ``observe_request`` at finish/shed),
gauge samples (``observe_value``), heartbeats, and externally observed
fault events (``event`` — the cluster's crash/stall/failover
machinery auto-opens incidents through it). Incidents land in a
(shareable) ``IncidentLog`` with deterministic ``inc-NNNN`` ids
assigned in open order; ``on_incident`` callbacks are the subscription
seam (detect-and-report only — the QoS scheduler's
``note_incident`` is wired there so a later PR can degrade on page,
nothing degrades today). A monitor given a ``flight.FlightRecorder``
freezes a postmortem bundle the moment an incident opens.

No torch, no serving imports at module load (the JSONL loader borrows
``serving.workload.iter_jsonl_tolerant`` lazily).
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("warn", "page")


def _atomic_write(path: str, text: str):
    """The repo's tmp+``os.replace`` write discipline (see
    framework/io.py save): parents created, a crash mid-write can
    never leave a truncated file where the old one was. Shared with
    ``obs.flight``'s bundle writer."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)

# what the per-request predicates call "bad": a missed deadline (sheds
# included — a shed request can never meet its SLO), a shed itself, or
# a deadline-timeout eviction
BAD_PREDICATES = ("deadline_missed", "shed", "timeout")


def _is_bad(pred: str, view: dict) -> Optional[bool]:
    """True/False = counts as bad/good for the burn stream; None = the
    record carries no verdict for this predicate (not counted)."""
    if pred == "deadline_missed":
        met = view.get("deadline_met")
        return None if met is None else (not met)
    if pred == "shed":
        return bool(view.get("shed"))
    if pred == "timeout":
        return view.get("finish_reason") == "timeout"
    raise ValueError(f"unknown bad-predicate {pred!r}")


@dataclasses.dataclass(frozen=True)
class ThresholdRule:
    """``signal`` ``op`` ``bound``, sustained ``for_units`` -> fire."""

    name: str
    signal: str
    bound: float
    op: str = ">="
    for_units: float = 0.0
    severity: str = "warn"
    kind: str = dataclasses.field(default="threshold", init=False)

    def __post_init__(self):
        if self.op not in (">=", "<="):
            raise ValueError(f"threshold op {self.op!r}: use '>=' or "
                             "'<='")
        if self.for_units < 0:
            raise ValueError("for_units must be >= 0")
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r}: use one of "
                             f"{SEVERITIES}")

    def breaches(self, value: float) -> bool:
        return value >= self.bound if self.op == ">=" \
            else value <= self.bound


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """Multi-window error-budget burn over a good/bad event stream.

    ``objective``: target good fraction (0.99 -> 1% error budget).
    ``windows``: ((window_units, burn_threshold), ...) — EVERY window
    must burn above its threshold to fire (classic long+short pair).
    ``bad``: the per-request predicate naming the bad event
    (``deadline_missed`` / ``shed`` / ``timeout``).
    ``min_events``: events required in the SHORTEST window before the
    rule may fire (no alert on 2-of-3 bad).
    """

    name: str
    objective: float
    windows: Tuple[Tuple[float, float], ...] = ((60.0, 10.0),
                                                (12.0, 10.0))
    bad: str = "deadline_missed"
    min_events: int = 20
    severity: str = "page"
    kind: str = dataclasses.field(default="burn_rate", init=False)

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1) — it is the "
                             "target GOOD fraction")
        if not self.windows:
            raise ValueError("burn-rate rule needs >= 1 window")
        for w, thr in self.windows:
            if w <= 0 or thr <= 0:
                raise ValueError("windows are (positive span, positive "
                                 "burn threshold) pairs")
        if self.bad not in BAD_PREDICATES:
            raise ValueError(f"bad={self.bad!r}: use one of "
                             f"{BAD_PREDICATES}")
        if self.min_events < 1:
            raise ValueError("min_events must be >= 1")
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r}: use one of "
                             f"{SEVERITIES}")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


@dataclasses.dataclass(frozen=True)
class HeartbeatRule:
    """The watched source silent for ``timeout`` units -> fire."""

    name: str
    timeout: float
    severity: str = "page"
    kind: str = dataclasses.field(default="heartbeat_silence",
                                  init=False)

    def __post_init__(self):
        if self.timeout <= 0:
            raise ValueError("heartbeat timeout must be > 0")
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r}: use one of "
                             f"{SEVERITIES}")


@dataclasses.dataclass
class Incident:
    """One fired rule or observed fault, with its window evidence.
    Times are VIRTUAL clock units; ids are assigned by the owning
    ``IncidentLog`` in open order (``inc-NNNN``) — deterministic, so
    two replays of one seeded trace produce byte-identical incident
    sets. ``t_close`` stays None while the incident is open."""

    id: str
    rule: str
    kind: str
    severity: str
    t_open: float
    source: Optional[str] = None
    t_close: Optional[float] = None
    resolution: Optional[str] = None
    evidence: dict = dataclasses.field(default_factory=dict)
    rids: List[str] = dataclasses.field(default_factory=list)

    @property
    def open(self) -> bool:
        return self.t_close is None

    def close(self, t: float, resolution: str):
        if self.t_close is None:
            self.t_close = round(float(t), 6)
            self.resolution = resolution

    def act(self, t: float, action: str):
        """An automated responder (the autoscaling control plane)
        ACTED on this incident: the action is stamped into the
        evidence (``action_taken``) and the incident closes with
        resolution ``"action_taken"`` — so the postmortem reader sees
        not just that the alert fired but WHICH remediation resolved
        it. Idempotent like ``close``: an already-closed incident is
        left as the first resolution recorded it."""
        if self.t_close is None:
            self.evidence["action_taken"] = action
            self.close(t, "action_taken")

    def to_json(self) -> dict:
        d = {"id": self.id, "rule": self.rule, "kind": self.kind,
             "severity": self.severity, "source": self.source,
             "t_open": self.t_open, "t_close": self.t_close,
             "resolution": self.resolution,
             "evidence": self.evidence}
        if self.rids:
            d["rids"] = list(self.rids)
        return d

    @staticmethod
    def from_json(d: dict) -> "Incident":
        return Incident(id=str(d["id"]), rule=str(d["rule"]),
                        kind=str(d["kind"]),
                        severity=str(d["severity"]),
                        t_open=float(d["t_open"]),
                        source=d.get("source"),
                        t_close=d.get("t_close"),
                        resolution=d.get("resolution"),
                        evidence=dict(d.get("evidence") or {}),
                        rids=list(d.get("rids") or ()))


class IncidentLog:
    """Ordered incident ledger, shareable across N per-replica
    monitors (the cluster hands every monitor ONE log, so ids stay
    cluster-unique and open-order deterministic). ``save`` is the
    JSONL dump under the repo's atomic tmp+``os.replace`` discipline;
    ``load`` tolerates a torn FINAL line via the shared
    ``workload.iter_jsonl_tolerant`` policy."""

    def __init__(self):
        self.incidents: List[Incident] = []

    def open(self, *, rule: str, kind: str, severity: str, t: float,
             source: Optional[str] = None, evidence: Optional[dict]
             = None, rids: Sequence[str] = ()) -> Incident:
        inc = Incident(id=f"inc-{len(self.incidents):04d}", rule=rule,
                       kind=kind, severity=severity,
                       t_open=round(float(t), 6), source=source,
                       evidence=dict(evidence or {}),
                       rids=list(rids))
        self.incidents.append(inc)
        return inc

    def __len__(self):
        return len(self.incidents)

    def __iter__(self):
        return iter(self.incidents)

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for inc in self.incidents:
            out[inc.kind] = out.get(inc.kind, 0) + 1
        return dict(sorted(out.items()))

    def save(self, path: str) -> str:
        _atomic_write(path, "".join(json.dumps(inc.to_json()) + "\n"
                                    for inc in self.incidents))
        return path

    @staticmethod
    def load(path: str) -> List[Incident]:
        return list(load_incidents(path))


def load_incidents(path: str) -> List[Incident]:
    """Parse a ``save``d incident JSONL. A torn FINAL line (crashing
    writer) warns and returns the valid prefix; a malformed earlier
    line raises — shared policy with traces and engine logs."""
    from ..serving.workload import iter_jsonl_tolerant
    return [Incident.from_json(d) for d in iter_jsonl_tolerant(path)]


class _Window:
    """One trailing window's INCREMENTAL event bookkeeping: each
    event is appended once and expired once, so evaluation is O(1)
    amortized per signal instead of rescanning the window — at
    10^5-request cluster scale the monitor advances on every
    observation and every heartbeat, and a rescan there is
    O(events-in-window) per advance."""

    __slots__ = ("span", "threshold", "events", "n", "bad")

    def __init__(self, span: float, threshold: float):
        self.span = span
        self.threshold = threshold
        self.events: deque = deque()   # (t, bad: 0/1) in time order
        self.n = 0
        self.bad = 0

    def add(self, t: float, bad: int):
        self.events.append((t, bad))
        self.n += 1
        self.bad += bad

    def expire(self, t: float):
        # keep events with et >= t - span (edge inclusive, matching
        # the epsilon the streaming tests pin down)
        cut = t - self.span - 1e-12
        ev = self.events
        while ev and ev[0][0] < cut:
            _, b = ev.popleft()
            self.n -= 1
            self.bad -= b

    def burn(self, budget: float) -> float:
        return (self.bad / self.n) / budget if self.n else 0.0

    def evidence(self, budget: float) -> dict:
        err = (self.bad / self.n) if self.n else 0.0
        return {"window": self.span, "threshold": self.threshold,
                "events": self.n, "bad": self.bad,
                "error_rate": round(err, 6),
                "burn": round(err / budget, 6)}


class _BurnState:
    __slots__ = ("windows", "cum", "cum_bad", "open_inc", "bad_rids")

    def __init__(self, rule: "BurnRateRule"):
        self.windows = [_Window(w, thr)
                        for w, thr in sorted(rule.windows,
                                             reverse=True)]
        self.cum = 0
        self.cum_bad = 0
        self.open_inc: Optional[Incident] = None
        self.bad_rids: deque = deque(maxlen=16)


class _ThresholdState:
    __slots__ = ("breach_since", "open_inc", "last_value", "last_rid")

    def __init__(self):
        self.breach_since: Optional[float] = None
        self.open_inc: Optional[Incident] = None
        self.last_value: Optional[float] = None
        self.last_rid: Optional[str] = None


class SLOMonitor:
    """Streaming evaluation of one source's SLO rules.

    Feed it the signals the system already produces — per-request
    records at finish/shed (``observe_request``), gauge samples
    (``observe_value``), liveness (``heartbeat``) — and drive time
    forward with ``advance``; rules evaluate as the stream arrives,
    incidents land in ``log``. ``event`` is the externally-observed
    fault path (the cluster's crash/stall/decode-error/failover
    machinery): it ALWAYS opens an incident (one per observed event —
    the exactly-once accounting the chaos gate checks), optionally
    self-closing at ``close_t``.

    A monitor observes and reports; it never mutates the system it
    watches — engine outputs, slot logs and metrics records are
    byte-identical with a monitor attached or not (gated by
    ``bench_gate.py obs``'s ``obs_slo`` family). ``on_incident``
    callbacks are the degradation seam: subscribers (e.g.
    ``QoSScheduler.note_incident``) receive each incident as it
    opens.
    """

    def __init__(self, rules: Sequence = (), *,
                 source: Optional[str] = None, t0: float = 0.0,
                 log: Optional[IncidentLog] = None, flight=None,
                 on_incident: Sequence[Callable] = ()):
        self.rules = list(rules)
        for r in self.rules:
            if not isinstance(r, (ThresholdRule, BurnRateRule,
                                  HeartbeatRule)):
                raise ValueError(f"unknown rule type "
                                 f"{type(r).__name__} — use "
                                 "ThresholdRule / BurnRateRule / "
                                 "HeartbeatRule")
        names = [r.name for r in self.rules]
        if len(names) != len(set(names)):
            raise ValueError("rule names must be unique within one "
                             "monitor")
        self.source = source
        self.log = log if log is not None else IncidentLog()
        self.flight = flight
        self._cbs = list(on_incident)
        self.t = float(t0)
        self.last_beat = float(t0)
        self.retired = False
        self._burn: Dict[str, _BurnState] = {
            r.name: _BurnState(r) for r in self.rules
            if isinstance(r, BurnRateRule)}
        self._thr: Dict[str, _ThresholdState] = {
            r.name: _ThresholdState() for r in self.rules
            if isinstance(r, ThresholdRule)}
        self._hb_open: Dict[str, Incident] = {}
        # event incidents left open by `event(close_t=...)` waiting for
        # their scheduled close, ordered by close time
        self._timed_open: List[Tuple[float, Incident]] = []

    def reset(self, t0: float = 0.0):
        """Fresh monitoring session over the same rules — the
        ``trace=Tracer`` convention: ``ServingEngine.run`` resets a
        caller-held monitor at each run's start, so a replay's low
        virtual timestamps are not instantly expired by the previous
        run's windows and ``ServeResult.incidents`` never re-reports
        an earlier run. Clears the incident log IN PLACE (callers
        sharing one log across monitors — the cluster's per-replica
        pattern — build fresh monitors instead of resetting)."""
        self.log.incidents.clear()
        self.t = float(t0)
        self.last_beat = float(t0)
        self.retired = False
        self._burn = {r.name: _BurnState(r) for r in self.rules
                      if isinstance(r, BurnRateRule)}
        self._thr = {r.name: _ThresholdState() for r in self.rules
                     if isinstance(r, ThresholdRule)}
        self._hb_open = {}
        self._timed_open = []

    # --- incident plumbing --------------------------------------------------
    def _open(self, *, rule: str, kind: str, severity: str, t: float,
              evidence: Optional[dict] = None,
              rids: Sequence[str] = ()) -> Incident:
        inc = self.log.open(rule=rule, kind=kind, severity=severity,
                            t=t, source=self.source,
                            evidence=evidence, rids=rids)
        for cb in self._cbs:
            cb(inc)
        if self.flight is not None:
            self.flight.on_incident(inc)
        return inc

    def subscribe(self, cb: Callable):
        """Add an incident callback (the degradation seam)."""
        self._cbs.append(cb)

    # --- signal feeds -------------------------------------------------------
    def heartbeat(self, t: float):
        """The source answered a liveness probe at ``t``. Closes any
        open silence incident (the source came back)."""
        if self.retired:
            return
        t = float(t)
        self.last_beat = max(self.last_beat, t)
        for name, inc in list(self._hb_open.items()):
            inc.close(t, "heartbeat_resumed")
            del self._hb_open[name]
        self.advance(t)

    def observe_request(self, view: dict, t: float):
        """One request reached its FINAL state (finish or shed) at
        ``t``; ``view`` is its ``MetricsCollector.request`` record
        (plus ``rid``). Feeds every burn-rate stream and any
        request-field threshold rule; any signal from the source also
        proves it alive."""
        if self.retired:
            return
        t = float(t)
        self.last_beat = max(self.last_beat, t)
        rid = view.get("rid")
        if self.flight is not None:
            # ring BEFORE evaluating: the observation that trips a
            # rule must be inside the frozen bundle
            for k in ("ttft", "tpot"):
                if view.get(k) is not None:
                    self.flight.sample(k, view[k], t,
                                       source=self.source)
        for r in self.rules:
            if isinstance(r, BurnRateRule):
                bad = _is_bad(r.bad, view)
                if bad is None:
                    continue
                st = self._burn[r.name]
                for w in st.windows:
                    w.add(t, 1 if bad else 0)
                st.cum += 1
                st.cum_bad += 1 if bad else 0
                if bad and rid is not None:
                    st.bad_rids.append((t, rid))
            elif isinstance(r, ThresholdRule) \
                    and r.signal in view \
                    and view[r.signal] is not None:
                self._thr_observe(r, float(view[r.signal]), t, rid=rid)
        self.advance(t)

    def observe_value(self, name: str, value: float, t: float):
        """One gauge/counter sample (queue depth, lane depth, ...)."""
        if self.retired:
            return
        t = float(t)
        self.last_beat = max(self.last_beat, t)
        if self.flight is not None:
            # ring before evaluating (see observe_request)
            self.flight.sample(name, value, t, source=self.source)
        for r in self.rules:
            if isinstance(r, ThresholdRule) and r.signal == name:
                self._thr_observe(r, float(value), t)
        self.advance(t)

    def event(self, kind: str, t: float, *, severity: str = "page",
              close_t: Optional[float] = None,
              evidence: Optional[dict] = None,
              rids: Sequence[str] = ()) -> Optional[Incident]:
        """An externally observed fault (crash/stall/decode_error/
        failover/...): auto-open one incident per event. ``close_t``
        schedules an automatic close (a stall's known end); ``close_t
        <= t`` closes immediately (a point event). Without it the
        incident stays open until ``close_kind`` / ``retire``."""
        if self.retired:
            return None
        if severity not in SEVERITIES:
            raise ValueError(f"severity {severity!r}: use one of "
                             f"{SEVERITIES}")
        t = float(t)
        inc = self._open(rule=kind, kind=kind, severity=severity,
                         t=t, evidence=evidence, rids=rids)
        if close_t is not None:
            if close_t <= t:
                inc.close(t, "event_complete")
            else:
                self._timed_open.append((float(close_t), inc))
                self._timed_open.sort(key=lambda p: p[0])
        self.advance(t)
        return inc

    def close_kind(self, kind: str, t: float, resolution: str) -> int:
        """Close every open incident of ``kind`` from this source
        (e.g. the crash incident once failover completes). Returns
        how many closed."""
        n = 0
        for inc in self.log.incidents:
            if inc.open and inc.kind == kind \
                    and inc.source == self.source:
                inc.close(t, resolution)
                n += 1
        self._timed_open = [(ct, i) for ct, i in self._timed_open
                            if i.open]
        return n

    # --- evaluation ---------------------------------------------------------
    def _thr_observe(self, r: ThresholdRule, value: float, t: float,
                     rid: Optional[str] = None):
        st = self._thr[r.name]
        prev = st.last_value
        st.last_value = value
        if r.breaches(value):
            if st.breach_since is None:
                st.breach_since = t
            st.last_rid = rid
            if st.open_inc is None \
                    and t - st.breach_since >= r.for_units - 1e-12:
                ev = {"signal": r.signal, "value": round(value, 6),
                      "bound": r.bound, "op": r.op,
                      "breach_since": round(st.breach_since, 6)}
                st.open_inc = self._open(
                    rule=r.name, kind=r.kind, severity=r.severity,
                    t=t, evidence=ev,
                    rids=[rid] if rid is not None else ())
        else:
            if st.open_inc is None and st.breach_since is not None \
                    and t - st.breach_since >= r.for_units - 1e-12:
                # the breach SUSTAINED past for_units but no other
                # signal advanced the clock mid-episode — the
                # recovering sample itself is the first evaluation
                # point, so the episode fires retroactively (with the
                # last BREACHING value as evidence) and closes at the
                # recovery. Detection must not depend on unrelated
                # traffic happening to arrive mid-breach.
                ev = {"signal": r.signal,
                      "value": round(prev, 6) if prev is not None
                      else None,
                      "bound": r.bound, "op": r.op,
                      "breach_since": round(st.breach_since, 6)}
                st.open_inc = self._open(
                    rule=r.name, kind=r.kind, severity=r.severity,
                    t=t, evidence=ev,
                    rids=[st.last_rid]
                    if st.last_rid is not None else ())
            st.breach_since = None
            st.last_rid = None
            if st.open_inc is not None:
                st.open_inc.close(t, "recovered")
                st.open_inc = None

    def advance(self, t: float):
        """Drive virtual time to ``t`` and evaluate every time-based
        rule: scheduled event closes, burn-rate windows, heartbeat
        silence, sustained thresholds."""
        if self.retired:
            return
        t = max(self.t, float(t))
        self.t = t
        while self._timed_open and self._timed_open[0][0] <= t + 1e-12:
            ct, inc = self._timed_open.pop(0)
            inc.close(ct, "event_complete")
        for r in self.rules:
            if isinstance(r, BurnRateRule):
                st = self._burn[r.name]
                budget = r.budget
                for w in st.windows:
                    w.expire(t)
                # windows are sorted longest-first; the SHORTEST
                # carries the min_events guard
                firing = (st.windows[-1].n >= r.min_events
                          and all(w.burn(budget) >= w.threshold
                                  for w in st.windows))
                if firing and st.open_inc is None:
                    budget_spent = (st.cum_bad / (st.cum * budget)) \
                        if st.cum else 0.0
                    st.open_inc = self._open(
                        rule=r.name, kind=r.kind, severity=r.severity,
                        t=t,
                        evidence={"objective": r.objective,
                                  "windows": [w.evidence(budget)
                                              for w in st.windows],
                                  "cum_events": st.cum,
                                  "cum_bad": st.cum_bad,
                                  "budget_spent":
                                  round(budget_spent, 6)},
                        # offending rids: only bad requests still
                        # inside the LONGEST firing window — a
                        # long-recovered burst must not send the
                        # postmortem reader to unrelated requests
                        rids=[rid for et, rid in st.bad_rids
                              if et >= t - st.windows[0].span
                              - 1e-12])
                elif not firing and st.open_inc is not None \
                        and all(w.burn(budget) < w.threshold
                                for w in st.windows):
                    st.open_inc.close(t, "burn_recovered")
                    st.open_inc = None
            elif isinstance(r, HeartbeatRule):
                silent = t - self.last_beat
                if silent >= r.timeout - 1e-9 \
                        and r.name not in self._hb_open:
                    self._hb_open[r.name] = self._open(
                        rule=r.name, kind=r.kind, severity=r.severity,
                        t=t,
                        evidence={"silent_for": round(silent, 6),
                                  "timeout": r.timeout,
                                  "last_beat":
                                  round(self.last_beat, 6)})
            elif isinstance(r, ThresholdRule):
                st = self._thr[r.name]
                if st.open_inc is None and st.breach_since is not None \
                        and st.last_value is not None \
                        and t - st.breach_since \
                        >= r.for_units - 1e-12:
                    ev = {"signal": r.signal,
                          "value": round(st.last_value, 6),
                          "bound": r.bound, "op": r.op,
                          "breach_since": round(st.breach_since, 6)}
                    st.open_inc = self._open(
                        rule=r.name, kind=r.kind, severity=r.severity,
                        t=t, evidence=ev,
                        rids=[st.last_rid]
                        if st.last_rid is not None else ())

    def retire(self, t: float, resolution: str = "source_removed"):
        """The watched source left the system (drain retirement or
        crash failover): close every incident still open from it and
        stop evaluating — a removed replica's silence is not an
        alert."""
        if self.retired:
            return
        for inc in self.log.incidents:
            if inc.open and inc.source == self.source:
                inc.close(t, resolution)
        self._hb_open.clear()
        self._timed_open = []
        for st in self._burn.values():
            st.open_inc = None
        for st in self._thr.values():
            st.open_inc = None
        self.retired = True

    @property
    def incidents(self) -> List[Incident]:
        """Every incident in the (possibly shared) log."""
        return list(self.log.incidents)


def default_serving_rules(*, objective: float = 0.85,
                          burn_threshold: float = 4.0,
                          long_window: float = 400.0,
                          short_window: float = 80.0,
                          min_events: int = 200,
                          queue_bound: Optional[float] = None) \
        -> List[object]:
    """The stock rule set the serving bench and docs share: a
    fast+slow deadline-attainment burn alert, a shed-storm burn alert
    (shedding is admission-time SLO loss — a crash's failover surge
    shows up here first), and optionally a queue-depth threshold.
    Calibrated against the seeded 10^5-request chaos trace: the
    fault-free replay fires NOTHING (the zero-false-positive gate),
    the crash replay's shed/deadline storms fire deterministically."""
    rules: List[object] = [
        BurnRateRule(name="deadline_burn", objective=objective,
                     windows=((long_window, burn_threshold),
                              (short_window, burn_threshold)),
                     bad="deadline_missed", min_events=min_events,
                     severity="page"),
        BurnRateRule(name="shed_burn", objective=objective,
                     windows=((long_window, burn_threshold),
                              (short_window, burn_threshold)),
                     bad="shed", min_events=min_events,
                     severity="warn"),
    ]
    if queue_bound is not None:
        rules.append(ThresholdRule(name="queue_depth_high",
                                   signal="queue_depth",
                                   bound=float(queue_bound),
                                   op=">=", severity="warn"))
    return rules
