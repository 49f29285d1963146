"""Deterministic fault injection for the serving cluster: seeded,
replayable failure schedules on the shared virtual clock.

A cluster that only knows *graceful* drain has never been tested
against the failures heavy traffic guarantees. This module is the
schedule half of the fault-tolerance layer (``cluster.ClusterRouter``
owns detection + failover, ``engine.EngineSession`` the teardown):

- ``FaultEvent``: one scheduled failure on the cluster's virtual
  timeline —

  ============ =========================================================
  crash        the replica process dies at ``t``: its in-flight rows
               are lost mid-decode, its pool (and every retained
               prefix page) is gone, and it goes SILENT — unlike a
               drain it hands nothing back; the router's heartbeat
               detector must notice the silence and fail its work over
  stall        the replica stops advancing for ``duration`` clock
               units (a GC pause / preemption / slow disk): it still
               answers health probes — the detector must NOT declare
               it dead — but every queued and in-flight request eats
               the delay
  decode_error an exception inside one decode slot at ``t``: the
               OLDEST in-flight row on the replica is torn down (pages
               freed, slot released, survivors untouched) and the
               request fails over; picking the oldest row makes a
               seeded plan deterministic without naming rids that may
               never be in flight
  ============ =========================================================

- ``FaultPlan``: an ordered list of events, JSONL round-tripped like
  traces (``save``/``load``), so one chaos incident replays
  bit-identically anywhere.
- ``synthesize_fault_plan``: one seeded crash+stall+decode-error
  schedule (the chaos gate's 1-of-N-replicas-crashing shape).
- ``FailoverConfig``: the detector/retry policy knobs — heartbeat
  cadence and timeout, per-request retry budget, exponential backoff.

The plan is pure data: replaying the same trace with the same plan and
config yields byte-identical cluster results, which is what lets
a gate hold chaos claims (zero lost/duplicated
requests, token parity vs the fault-free run, goodput floor) instead
of anecdotes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("crash", "stall", "decode_error")

# the SLO severity each observed fault auto-opens its incident at
# (obs.slo conventions: "page" wakes a human, "warn" files a ticket).
# A crash pages — capacity is gone and work is in flight; a stall or
# a single-slot decode error degrades service but self-heals, so it
# warns; a failover (the detector's conclusion after a crash) pages
# because it is the moment the cluster actually lost redundancy.
FAULT_SEVERITY = {"crash": "page", "stall": "warn",
                  "decode_error": "warn", "failover": "page",
                  "retry_exhausted": "page", "handoff_failed": "page"}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure. ``t`` is virtual clock time; ``replica``
    names the target (the ``r<i>`` names ``ClusterRouter`` spawns, or
    a joined replica's name); ``duration`` is required for stalls and
    meaningless otherwise."""

    t: float
    kind: str
    replica: str
    duration: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r}: use one of "
                             f"{KINDS}")
        if self.kind == "stall":
            if self.duration is None or self.duration <= 0:
                raise ValueError("a stall needs duration > 0")
        elif self.duration is not None:
            raise ValueError(f"{self.kind} takes no duration")
        if self.t < 0:
            raise ValueError("fault time must be >= 0")

    def to_json(self) -> dict:
        d = {"t": self.t, "kind": self.kind, "replica": self.replica}
        if self.duration is not None:
            d["duration"] = self.duration
        return d

    @staticmethod
    def from_json(d: dict) -> "FaultEvent":
        return FaultEvent(t=float(d["t"]), kind=str(d["kind"]),
                          replica=str(d["replica"]),
                          duration=d.get("duration"))


class FaultPlan:
    """An ordered failure schedule. Iterable; events are kept sorted
    by (t, kind, replica) so a plan built from any event order replays
    identically."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        evs = list(events)
        for e in evs:
            if not isinstance(e, FaultEvent):
                raise ValueError("FaultPlan takes FaultEvent items")
        self.events: List[FaultEvent] = sorted(
            evs, key=lambda e: (e.t, KINDS.index(e.kind), e.replica))
        crashes: dict = {}
        for e in self.events:
            if e.replica in crashes:
                raise ValueError(
                    f"{e.kind} targets {e.replica!r} at t={e.t} after "
                    f"its crash at t={crashes[e.replica]} — a dead "
                    "replica cannot fail again")
            if e.kind == "crash":
                crashes[e.replica] = e.t

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def crashes(self) -> List[FaultEvent]:
        return [e for e in self.events if e.kind == "crash"]

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e.to_json()) + "\n")
        return path

    @staticmethod
    def load(path: str) -> "FaultPlan":
        out = []
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if ln:
                    out.append(FaultEvent.from_json(json.loads(ln)))
        return FaultPlan(out)


@dataclasses.dataclass(frozen=True)
class FailoverConfig:
    """Detector + retry policy for ``ClusterRouter``.

    The heartbeat probe runs OUT OF BAND on the virtual timeline: a
    live replica (stalled or not — stall is a liveness-preserving
    fault) answers every probe; a crashed replica goes silent, and
    after ``heartbeat_timeout`` units of silence the router declares
    it dead and fails its queued + in-flight work over. Probe ticks
    every ``heartbeat_interval`` bound the detection latency to
    ``timeout + interval`` even when no request arrives.

    A failed-over request is re-placed with exponential backoff
    (``backoff_base * backoff_mult**(attempt-1)`` after the failure)
    and at most ``retry_budget`` re-placements; a request that exhausts
    the budget is recorded as FAILED — accounted exactly once, never
    silently lost."""

    heartbeat_interval: float = 2.0
    heartbeat_timeout: float = 6.0
    retry_budget: int = 3
    backoff_base: float = 1.0
    backoff_mult: float = 2.0

    def __post_init__(self):
        if self.heartbeat_interval <= 0 or self.heartbeat_timeout <= 0:
            raise ValueError("heartbeat interval/timeout must be > 0")
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if self.backoff_base < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff_base must be >= 0 and "
                             "backoff_mult >= 1.0")

    def backoff(self, attempt: int) -> float:
        """Delay before re-placement number ``attempt`` (1-based)."""
        return self.backoff_base * self.backoff_mult ** max(
            0, attempt - 1)


def synthesize_fault_plan(seed: int = 0, *, replicas: Sequence[str],
                          span: float, n_crashes: int = 1,
                          n_stalls: int = 2,
                          stall_duration: Tuple[float, float]
                          = (5.0, 20.0),
                          n_decode_errors: int = 2,
                          crash_window: Tuple[float, float]
                          = (0.35, 0.65)) -> FaultPlan:
    """One seeded chaos schedule over ``span`` clock units of trace:
    ``n_crashes`` replicas die inside ``crash_window`` (fractions of
    the span — mid-trace, where in-flight and queued work is richest),
    ``n_stalls`` transient stalls and ``n_decode_errors`` slot
    exceptions land on SURVIVING replicas at uniform times. Same
    (seed, knobs) -> same plan, every field."""
    reps = list(replicas)
    if n_crashes >= len(reps):
        raise ValueError("at least one replica must survive the plan")
    if not 0.0 <= crash_window[0] < crash_window[1] <= 1.0:
        raise ValueError("crash_window must be an increasing fraction "
                         "pair in [0, 1]")
    rng = np.random.default_rng(seed)
    victims = [reps[int(i)] for i in
               rng.choice(len(reps), n_crashes, replace=False)]
    survivors = [r for r in reps if r not in victims]
    events: List[FaultEvent] = []
    for v in victims:
        t = span * float(rng.uniform(*crash_window))
        events.append(FaultEvent(t=round(t, 6), kind="crash",
                                 replica=v))
    for _ in range(n_stalls):
        r = survivors[int(rng.integers(len(survivors)))]
        t = span * float(rng.uniform(0.1, 0.9))
        d = float(rng.uniform(*stall_duration))
        events.append(FaultEvent(t=round(t, 6), kind="stall",
                                 replica=r, duration=round(d, 6)))
    for _ in range(n_decode_errors):
        r = survivors[int(rng.integers(len(survivors)))]
        t = span * float(rng.uniform(0.1, 0.9))
        events.append(FaultEvent(t=round(t, 6), kind="decode_error",
                                 replica=r))
    return FaultPlan(events)
