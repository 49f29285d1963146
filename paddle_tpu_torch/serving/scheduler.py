"""QoS scheduling for the serving engine: the front door between trace
arrival and admission.

The plain engine admits FIFO — every request equal, no deadline consulted,
and under overload the queue just grows. This module is the scheduling
layer production stacks win with (Orca: iteration-level scheduling is
where continuous batching pays off; Clockwork: SLO attainment comes
from admission-time deadline-feasibility checks over a predictable
cost model):

- **Strict priority classes** above **weighted fair queueing across
  tenants** (start-time fair queueing: each tenant carries a virtual
  finish tag advanced by served-work/weight; the lowest tag in the top
  priority class goes next, so an aggressive tenant can saturate only
  its weight share, not the queue).
- **Deadline-feasibility admission**: estimated completion =
  now + queued-prefill delay + prefill + ceil(budget/chunk) x decode x
  headroom, from the engine's observed (EWMA) or fixed-clock per-action
  costs. A request that cannot meet its ``deadline_ms`` is shed AT
  ADMISSION — before burning prefill compute — not timed out after.
- **Overload as policy**: bounded queues shed lowest-value first
  (lowest priority class, then the request least likely to make its
  deadline, then latest arrival), and graceful-degradation tiers clamp
  ``max_new_tokens`` (1.0 -> 0.75 -> 0.5 -> 0.25 of budget) before
  rejecting outright — a shorter answer in time beats a full answer
  late or none at all.
- **Aging** (optional): a waiting request's effective priority rises by
  one class per ``aging`` clock units, so strict priority cannot
  starve a low class under a saturating high-priority tenant.

The scheduler owns the waiting set; the engine asks ``select`` for the
next admission wave, records the sheds, and ``commit``s the requests it
actually admitted (a wave blocked on slots/pages stays queued and is
NOT charged to its tenant's fair-queue tag). Timeout of RUNNING
requests is the engine's half of the contract, unified with the
``cancel_after`` eviction path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from .workload import Request


class ServiceEstimator:
    """Per-action cost model the feasibility check prices against.

    Seeded from the engine clock's fixed costs (exact under
    ``clock="fixed"``); under a measured clock the engine feeds every
    observed prefill/decode duration back and the EWMA tracks the real
    machine. ``headroom`` multiplies the decode estimate — co-scheduled
    prefills steal turns from a row's decode stream, so the lone-row
    lower bound is optimistic by design.

    ``prefill_unit`` + ``chunk_tokens`` switch prefill pricing from
    flat-per-call to per-chunk: ``prefill_cost(n_uncached_tokens)``
    then scales with the chunks the engine will actually compute —
    the cache-aware admission price (a request whose prompt is mostly
    prefix-cache resident is CHEAP, and the feasibility check should
    know that before shedding it).
    """

    def __init__(self, prefill: float = 1.0, decode: float = 1.0,
                 alpha: float = 0.25,
                 prefill_unit: Optional[float] = None,
                 chunk_tokens: Optional[int] = None):
        if prefill <= 0 or decode <= 0:
            raise ValueError("estimator costs must be positive")
        self.costs = {"prefill": float(prefill), "decode": float(decode)}
        if prefill_unit is not None:
            if prefill_unit <= 0:
                raise ValueError("estimator costs must be positive")
            if not chunk_tokens or chunk_tokens <= 0:
                raise ValueError("prefill_unit pricing needs "
                                 "chunk_tokens (the prefill chunk "
                                 "size in tokens)")
            self.costs["prefill_unit"] = float(prefill_unit)
        self.chunk_tokens = int(chunk_tokens) if chunk_tokens else None
        self.alpha = alpha

    def prefill_cost(self, uncached_tokens: Optional[int] = None,
                     prompt_tokens: Optional[int] = None) -> float:
        """Admission price of one prefill. Per-chunk pricing with a
        known uncached length charges exactly the chunks the engine
        will compute: ``ceil(prompt/chunk) - cached//chunk``, floored
        at one — the engine resumes at the CHUNK-ALIGNED cached count
        and the FINAL chunk always runs (the last-position logits
        must exist), so a cached prefix that is not chunk-aligned
        still pays for its partial chunk. Without ``prompt_tokens``
        the uncached length alone approximates (exact when the cache
        is page==chunk aligned); without per-chunk pricing, or
        without a probe result, the flat per-call cost keeps the
        legacy arithmetic exactly."""
        unit = self.costs.get("prefill_unit")
        if unit is None or uncached_tokens is None \
                or self.chunk_tokens is None:
            return self.prefill
        c = self.chunk_tokens
        u = max(0, uncached_tokens)
        if prompt_tokens is None:
            return unit * max(1, math.ceil(u / c))
        total = max(1, math.ceil(prompt_tokens / c))
        return unit * max(1, total - (prompt_tokens - u) // c)

    def observe(self, kind: str, dt: float):
        if dt <= 0:
            return
        c = self.costs.get(kind)
        self.costs[kind] = dt if c is None else \
            (1 - self.alpha) * c + self.alpha * dt

    @property
    def prefill(self) -> float:
        return self.costs["prefill"]

    @property
    def decode(self) -> float:
        return self.costs["decode"]


@dataclasses.dataclass
class SchedDecision:
    """One scheduler turn: the wave to admit (budgets possibly clamped
    by a degradation tier) and the requests shed this turn (original
    request, reason)."""

    wave: List[Request]
    shed: List[Tuple[Request, str]]
    degraded: Dict[str, Tuple[int, int]]  # rid -> (new, orig) budgets


class _Entry:
    __slots__ = ("req", "enq_t")

    def __init__(self, req: Request, enq_t: float):
        self.req = req
        self.enq_t = enq_t


class QoSScheduler:
    """SLO-aware admission + per-tenant fairness + overload shedding.

    ``tenant_weights``: WFQ weight per tenant (default 1.0; requests
    without a tenant pool under ``default_tenant``). ``max_queue``
    bounds the waiting set (None = unbounded; shedding then comes only
    from deadline infeasibility). ``degrade_tiers`` are budget
    fractions tried in order before shedding an infeasible-at-full-
    budget request; () disables degradation. ``headroom`` scales the
    decode-time estimate in the feasibility check. ``aging`` promotes a
    waiting request one priority class per that many clock units
    (None = strict classes, starvation possible by design).
    """

    name = "qos"

    def __init__(self, *, tenant_weights: Optional[Dict[str, float]]
                 = None, default_tenant: str = "_default",
                 max_queue: Optional[int] = None,
                 degrade_tiers: Tuple[float, ...] = (1.0, 0.75, 0.5,
                                                     0.25),
                 headroom: float = 1.5,
                 aging: Optional[float] = None,
                 incident_degrade: Optional[float] = None):
        self.tenant_weights = dict(tenant_weights or {})
        for t, w in self.tenant_weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r}: weight must be > 0")
        self.default_tenant = default_tenant
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.max_queue = max_queue
        if any(not 0 < f <= 1 for f in degrade_tiers):
            raise ValueError("degrade_tiers must be fractions in (0, 1]")
        self.degrade_tiers = tuple(sorted(degrade_tiers, reverse=True))
        if headroom < 1.0:
            raise ValueError("headroom must be >= 1.0")
        self.headroom = headroom
        if aging is not None and aging <= 0:
            raise ValueError("aging must be > 0 clock units (or None)")
        self.aging = aging
        if incident_degrade is not None \
                and not 0.0 < incident_degrade <= 1.0:
            raise ValueError("incident_degrade is a budget fraction "
                             "in (0, 1] (or None to disable incident-"
                             "driven degradation)")
        # incident-driven TIER ACTUATION (the autoscaling control
        # plane's "degrade before shedding" action): while any
        # page-severity incident delivered through note_incident is
        # still OPEN, admission budgets are clamped to at most this
        # fraction — every candidate degrades to a shorter answer
        # before the feasibility check ever sheds it. None (the
        # default) keeps the pre-actuation arithmetic bit-for-bit.
        self.incident_degrade = incident_degrade
        # the SLO subscription seam (obs.slo.SLOMonitor on_incident /
        # subscribe): every incident delivered accumulates here; page
        # incidents additionally arm the incident_degrade clamp while
        # open. Survives reset(): incident history is operator state,
        # not per-run queue state.
        self.incidents_seen: List = []
        self._page_open: List = []
        # overload tracking for the SPECULATIVE route's fallback
        # (``ServingEngine(spec=...)`` arms it; untracked otherwise —
        # the "tracked only when a consumer is armed"
        # discipline): while any page-severity incident delivered
        # through note_incident stays open, ``overload_active()``
        # answers True and the engine decodes spec rows plain —
        # draft compute is waste exactly when capacity is scarce.
        self.track_overload = False
        self._overload_open: List = []
        # pool-byte pressure tracking for the QUANTIZED page tier
        # (``ServingEngine(kv_quant='pressure')`` arms it; same
        # tracked-only-when-armed discipline): while any incident
        # whose evidence names the ``pool_bytes_per_device`` signal
        # stays open, ``pressure_active()`` answers True and the
        # engine compacts parked pages to int8 — compaction before
        # shedding, the gentler rung below the degrade clamp.
        self.track_pressure = False
        self._pressure_open: List = []
        # preemption-as-swap rung for the HOST-ARENA tier
        # (``ServingEngine(hostmem=...)`` arms it; same tracked-only-
        # when-armed discipline): when a wave candidate blocks on
        # capacity, ``preempt_victim`` names the running row worth
        # swapping OUT to the host arena so the blocked request can
        # run — the rung between degrade (shorter answers) and shed
        # (no answer): the victim still finishes, just later.
        self.track_preempt = False
        # grammar floor for CONSTRAINED streams
        # (``ServingEngine(grammar=...)`` arms it; same armed-only-
        # when-a-consumer-exists discipline): a callable mapping a
        # Request to the automaton's shortest-accept length (None for
        # free rows). A degrade tier must never clamp a constrained
        # budget below the shortest string its grammar accepts —
        # that would GUARANTEE a structurally broken answer, strictly
        # worse than shedding.
        self.grammar_min_tokens = None
        self.reset()

    # --- state ------------------------------------------------------------
    def reset(self):
        """Fresh run: empty queue, fair-queue tags back to zero (an
        engine reuses one scheduler across ``run`` calls). The
        overload-tracking list clears too: a run's per-run SLO
        monitor is discarded at run end, so an incident still open
        then would otherwise NEVER close and park the next run's
        spec route forever (``incidents_seen``/the degrade clamp
        keep their survive-reset semantics — they are operator
        state)."""
        self._q: Dict[str, _Entry] = {}
        self._tags: Dict[str, float] = {}
        self._priced: Dict[str, float] = {}
        self._overload_open = []
        self._pressure_open = []

    def note_incident(self, incident):
        """``obs.slo`` incident callback: record that an SLO incident
        fired (e.g. ``SLOMonitor(..., on_incident=[sched.
        note_incident])``). With ``incident_degrade`` unset this is
        detect-and-report only — admission arithmetic untouched.
        With it set, a delivered PAGE-severity incident arms the
        degradation clamp for as long as the incident object stays
        open (incidents close in place, so no un-note call exists or
        is needed): the tier actuation the autoscaling control plane
        drives through this seam."""
        self.incidents_seen.append(incident)
        if getattr(incident, "severity", None) == "page":
            if self.incident_degrade is not None:
                self._page_open.append(incident)
            if self.track_overload:
                self._overload_open.append(incident)
        if self.track_pressure and isinstance(
                getattr(incident, "evidence", None), dict) \
                and incident.evidence.get("signal") \
                == "pool_bytes_per_device":
            # any severity qualifies: compaction is the low-regret
            # rung, worth taking on a warn-level byte breach before
            # anything pages
            self._pressure_open.append(incident)

    def pressure_active(self) -> bool:
        """True while any pool-byte-pressure incident delivered
        through ``note_incident`` is still open (armed via
        ``track_pressure``; always False untracked). The quantized
        page tier's trigger: closed incidents prune lazily, so
        compaction stops the moment stored bytes recover below the
        rule's bound."""
        if self._pressure_open:
            self._pressure_open = [i for i in self._pressure_open
                                   if getattr(i, "open", False)]
        return bool(self._pressure_open)

    def overload_active(self) -> bool:
        """True while any page-severity incident delivered through
        ``note_incident`` is still open (armed via
        ``track_overload``; always False untracked). The speculative
        route's fallback signal: incidents close in place, so closed
        ones are pruned lazily and the route re-enables the moment
        the last one resolves."""
        if self._overload_open:
            self._overload_open = [i for i in self._overload_open
                                   if getattr(i, "open", False)]
        return bool(self._overload_open)

    def _degrade_cap(self) -> Optional[float]:
        """The active incident-degradation budget fraction, or None.
        Closed incidents are pruned lazily — the clamp lifts the
        moment the last armed incident closes."""
        if self.incident_degrade is None:
            return None
        if self._page_open:
            self._page_open = [i for i in self._page_open
                               if getattr(i, "open", False)]
        return self.incident_degrade if self._page_open else None

    def waiting(self) -> int:
        return len(self._q)

    def oldest_arrival(self) -> float:
        return min(e.req.arrival for e in self._q.values())

    def queued_rids(self) -> List[str]:
        return list(self._q)

    def queued_requests(self) -> List[Request]:
        """Non-destructive view of the queued requests in (arrival,
        rid) order — the disaggregated placement policy's backlog
        probe (``drain_queue`` is the destructive twin)."""
        return sorted((e.req for e in self._q.values()),
                      key=lambda r: (r.arrival, r.rid))

    def _tenant(self, r: Request) -> str:
        return r.tenant if r.tenant is not None else self.default_tenant

    def _weight(self, tenant: str) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    def _eff_priority(self, e: _Entry, now: float) -> int:
        p = e.req.priority
        if self.aging is not None:
            p += int((now - e.req.arrival) / self.aging)
        return p

    # --- enqueue + queue-bound shedding -----------------------------------
    def enqueue(self, r: Request, now: float) \
            -> List[Tuple[Request, str]]:
        """Accept an arrival; under a full queue, shed the lowest-value
        request (possibly the newcomer). Returns this turn's sheds."""
        t = self._tenant(r)
        if not any(self._tenant(e.req) == t for e in self._q.values()):
            # SFQ re-activation: a tenant returning from idle re-enters
            # at the current virtual time (the min tag among tenants
            # with queued work), never below — idle time earns no
            # credit, but accumulated debt is kept
            live = [self._tags.get(self._tenant(e.req), 0.0)
                    for e in self._q.values()]
            if live:
                self._tags[t] = max(self._tags.get(t, 0.0), min(live))
        self._q[r.rid] = _Entry(r, now)
        if self.max_queue is None or len(self._q) <= self.max_queue:
            return []
        victim = min(self._q.values(),
                     key=lambda e: self._shed_key(e, now))
        del self._q[victim.req.rid]
        return [(victim.req, f"queue bound ({self.max_queue}) — lowest-"
                 "value victim (priority, deadline slack, recency)")]

    def _shed_key(self, e: _Entry, now: float):
        """Lowest value first: lowest effective priority; then the
        request LEAST likely to meet its deadline (smallest slack —
        shedding the doomed wastes the least); deadline-free requests
        rank above any deadline (infinite slack); latest arrival last."""
        r = e.req
        dl = r.deadline_time()
        slack = math.inf if dl is None else dl - now
        return (self._eff_priority(e, now), slack, -r.arrival, r.rid)

    # --- the admission turn ------------------------------------------------
    def select(self, now: float, *, max_batch: int,
               est: ServiceEstimator, decode_chunk: int = 1,
               match_prefix=None,
               backlog_cost: float = 0.0) -> SchedDecision:
        """Build the next admission wave.

        Order: strict effective priority, then WFQ across tenants
        (lowest virtual finish tag), then FIFO within a tenant. Each
        candidate passes the deadline-feasibility check at its wave
        position (earlier wave members' prefills delay it); an
        infeasible candidate tries the degradation tiers, then is shed.
        Tags are NOT charged here — the engine ``commit``s what it
        actually admitted.

        ``match_prefix`` (optional, ``PagedKVCache.match_prefix``-
        shaped: tokens -> cached token count) makes admission CACHE-
        AWARE: each candidate's prefill is priced at
        ``est.prefill_cost(len(prompt) - match_prefix(prompt))``, so a
        recurring system prompt both admits more easily and delays the
        rest of the wave less. ``None`` keeps the flat legacy pricing
        bit-for-bit.

        ``backlog_cost`` seeds the queued-prefill delay with work
        ALREADY committed ahead of this wave — the async prefill
        lane's remaining chunks (``ServingEngine._lane_backlog_cost``)
        — so feasibility verdicts stay honest when admission and
        prefill are decoupled. 0.0 (the default) keeps the legacy
        arithmetic exactly.
        """
        shed: List[Tuple[Request, str]] = []
        degraded: Dict[str, Tuple[int, int]] = {}
        wave: List[Request] = []
        cap = self._degrade_cap()  # once per turn: one incident state
        # governs the whole wave
        remaining = dict(self._q)
        # prefill units ahead of the next candidate (the lane's
        # committed chunks first, then this wave's admitted prefills)
        queued_cost = float(backlog_cost)
        while remaining and len(wave) < max_batch:
            top = max(self._eff_priority(e, now)
                      for e in remaining.values())
            cands = [e for e in remaining.values()
                     if self._eff_priority(e, now) == top]
            tenants = {self._tenant(e.req) for e in cands}
            tenant = min(tenants,
                         key=lambda t: (self._tags.get(t, 0.0), t))
            e = min((c for c in cands if self._tenant(c.req) == tenant),
                    key=lambda c: (c.req.arrival, c.req.rid))
            del remaining[e.req.rid]
            uncached = None
            if match_prefix is not None:
                uncached = max(0, len(e.req.prompt)
                               - int(match_prefix(e.req.prompt)))
            elif "prefill_unit" in est.costs:
                # per-chunk clock pricing with NO probe (the cache-off
                # arm): everything computes — price the full prompt,
                # not the flat per-call cost, or every candidate looks
                # one-chunk cheap and blows its admitted deadline
                uncached = len(e.req.prompt)
            r, verdict, cost = self._feasible(e.req, now, queued_cost,
                                              est, decode_chunk,
                                              uncached, cap=cap)
            if r is None:
                del self._q[e.req.rid]
                shed.append((e.req, verdict))
                continue
            queued_cost += cost  # only ADMITTED prefills delay later
            # wave members (a shed candidate never runs)
            # bank the full admission price (prefill + budgeted decode
            # with headroom) — the cost ledger's calibration signal:
            # estimator-priced vs ledger-actual units per admission
            self._priced[r.rid] = (
                cost + math.ceil(r.max_new_tokens / decode_chunk)
                * est.decode * self.headroom)
            if r.max_new_tokens < e.req.max_new_tokens:
                degraded[r.rid] = (r.max_new_tokens,
                                   e.req.max_new_tokens)
            wave.append(r)
        return SchedDecision(wave=wave, shed=shed, degraded=degraded)

    def _feasible(self, r: Request, now: float, queued_cost: float,
                  est: ServiceEstimator, decode_chunk: int,
                  uncached: Optional[int] = None,
                  cap: Optional[float] = None):
        """Clockwork-style check: estimated completion =
        now + queued_cost + own prefill        (admissions serialize;
                                                each priced by its
                                                UNCACHED length when a
                                                probe is given)
            + ceil(budget / decode_chunk) * decode * headroom.
        ``cap`` (the open-incident degradation fraction) replaces the
        full-budget top tier: every admission — deadline-free ones
        included — is clamped to at most ``cap`` x its budget while
        an incident is open, trading answer length for admission
        headroom BEFORE any shed. Returns (request-or-degraded-copy,
        rule, prefill_cost) or (None, shed reason, 0.0)."""
        pf = est.prefill_cost(uncached, prompt_tokens=len(r.prompt))
        dl = r.deadline_time()
        budget = r.max_new_tokens
        # degrade floor: a constrained stream is never clamped below
        # its automaton's shortest-accept length (armed by the engine
        # through ``grammar_min_tokens``; free rows and unarmed
        # schedulers keep the legacy floor of 1 bit-for-bit)
        floor = 1
        if self.grammar_min_tokens is not None:
            g = self.grammar_min_tokens(r)
            if g is not None:
                floor = max(1, min(int(g), budget))
        if dl is None:
            if cap is not None:
                b = max(floor, math.ceil(budget * cap))
                if b < budget:
                    return (dataclasses.replace(r, max_new_tokens=b),
                            f"incident degradation tier {cap} "
                            f"({b}/{budget} tokens)", pf)
            return r, "no deadline", pf
        t0 = now + queued_cost + pf
        # the FULL budget is always tried first — degrade_tiers only
        # say what to fall back to when it does not fit (a tier tuple
        # without 1.0 must not silently clamp feasible requests).
        # Under an open incident the cap IS the top tier.
        if cap is not None:
            tiers = (cap,) + tuple(f for f in self.degrade_tiers
                                   if f < cap)
        else:
            tiers = (1.0,) + tuple(f for f in self.degrade_tiers
                                   if f < 1.0)
        for frac in tiers:
            b = max(floor, math.ceil(budget * frac))
            fin = t0 + math.ceil(b / decode_chunk) * est.decode \
                * self.headroom
            if fin <= dl + 1e-9:
                if b >= budget:
                    return r, "feasible at full budget", pf
                return (dataclasses.replace(r, max_new_tokens=b),
                        f"degraded to tier {frac} ({b}/{budget} tokens)",
                        pf)
        return None, (
            f"deadline-infeasible at admission: even the lowest "
            f"degradation tier ({tiers[-1]}) finishes past the "
            f"deadline (deadline in {max(0.0, dl - now):.3f} units, "
            f"estimated service {t0 - now + est.decode:.3f}+)"), 0.0

    def preempt_victim(self, now: float, blocked: Request,
                       running: List[Tuple[str, Request, int]]) \
            -> Optional[str]:
        """Name the running row to swap out so ``blocked`` (a selected
        wave member the engine could not admit for capacity) can run —
        or None when no row is worth displacing. Armed via
        ``track_preempt`` (always None untracked: the engine falls
        through to the legacy stay-queued/shed path bit-for-bit).

        ``running`` is the engine's view of in-flight rows as
        ``(rid, request, emitted_tokens)``. A victim must be STRICTLY
        lower priority than the blocked request's effective (aged)
        priority — equal-priority swapping would thrash — and must
        still have decode budget left (displacing a row about to
        finish buys nothing and pays two transfers). Among eligible
        victims: lowest priority first, then fewest emitted tokens
        (the least sunk decode work re-queued), then rid for
        determinism."""
        if not self.track_preempt:
            return None
        e = self._q.get(blocked.rid)
        want = self._eff_priority(e, now) if e is not None \
            else blocked.priority
        cands = [(rid, r, emitted) for rid, r, emitted in running
                 if r.priority < want
                 and emitted < r.max_new_tokens - 1]
        if not cands:
            return None
        return min(cands,
                   key=lambda c: (c[1].priority, c[2], c[0]))[0]

    def commit(self, rid: str, budget: Optional[int] = None):
        """The engine ADMITTED ``rid``: leave the queue and charge the
        tenant's fair-queue tag by served-work/weight. ``budget`` is
        the budget that actually ran (the degradation-clamped value
        when a tier fired) — a degraded tenant is charged for the
        short answer it got, not the long one it asked for.
        Uncommitted selections stay queued for the next turn,
        uncharged."""
        e = self._q.pop(rid)
        t = self._tenant(e.req)
        b = budget if budget is not None else e.req.max_new_tokens
        cost = (len(e.req.prompt) + b) / self._weight(t)
        self._tags[t] = self._tags.get(t, 0.0) + cost

    def priced(self, rid: str) -> Optional[float]:
        """The admission price ``select`` computed for ``rid`` on its
        LAST selection (prefill + budgeted decode with headroom), or
        None for a request never selected. Read by the engine at
        commit time to seed the cost ledger's estimator-vs-actual
        calibration rows; purely observational — admission arithmetic
        never reads it back."""
        return self._priced.get(rid)

    def drain_queue(self) -> List[Request]:
        """Remove and return EVERY queued (never-admitted) request, in
        (arrival, rid) order — the cluster router's drain AND failover
        path: a draining replica keeps its in-flight rows and hands
        its queue back; a replica declared dead after a crash hands
        back everything that was still queued there (including
        arrivals placed during the undetected-silence window).
        Fair-queue tags are untouched (history of served work survives
        the drain; a corpse's tags die with its session). A RESUMED
        request re-enqueues elsewhere with its original arrival, so
        aging credits the waiting it already suffered and
        ``shed_expired`` still prices its deadline honestly."""
        reqs = sorted((e.req for e in self._q.values()),
                      key=lambda r: (r.arrival, r.rid))
        self._q.clear()
        return reqs

    def shed_expired(self, now: float) -> List[Tuple[Request, str]]:
        """Drop queued requests whose deadline already passed (they
        could only be timed out later for more cost)."""
        out = []
        for rid in list(self._q):
            dl = self._q[rid].req.deadline_time()
            if dl is not None and now > dl + 1e-9:
                e = self._q.pop(rid)
                out.append((e.req, "deadline passed while queued"))
        return out
