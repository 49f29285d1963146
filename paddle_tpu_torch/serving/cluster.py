"""Multi-replica serving cluster: a prefix-aware router over N engines.

One ``ServingEngine`` is a building block; a service at
millions-of-users scale is N of them behind a front door that decides
WHERE each request runs. ``ClusterRouter`` is that front door, built
from pieces already in the repo:

- each replica is an ``EngineSession`` (its own engine, paged pool and
  QoS scheduler) on its own lane of one shared virtual timeline — the
  router advances EVERY lane to each arrival before placing it, so
  placement probes answer "as of now", not "as of whenever that
  replica last ran";
- **placement policies** (pluggable, ``place(request, replicas)``):

  ============== ========================================================
  round_robin    rotate over admitting replicas — the baseline every
                 cluster claim is measured against
  least_loaded   fewest queued + in-flight requests (the same live
                 queue-depth signal the obs gauges export), replica
                 index breaking ties
  prefix_aware   probe every replica's paged pool with the
                 NON-ACQUIRING ``match_prefix`` and send a request to
                 the replica already holding >= threshold tokens of its
                 prompt (ties: least loaded); below threshold, fall
                 back to least_loaded. The engine's cache-aware
                 co-scheduling generalized ACROSS replicas: sharers concentrate where
                 their prefix is resident instead of re-prefilling it
                 N times and thrashing every pool's retention LRU
  ============== ========================================================

- **lifecycle**: ``drain`` stops admission, hands the replica's
  queued-but-never-admitted backlog back to the router for placement
  on surviving replicas (requeued requests keep their original arrival
  — the queueing they suffered stays on their record — and are counted
  exactly ONCE cluster-wide), lets in-flight rows stream to
  completion, then retires the replica (its pool census must balance
  with zero resident pages at removal). ``join`` adds a cold replica
  mid-trace; placement starts steering traffic to it immediately
  (least-loaded finds it empty, prefix-aware falls back until its pool
  warms).

The router itself never touches tokens: placement is bookkeeping, each
replica's engine does exactly what a lone engine does, and every
request's greedy stream therefore agrees token-for-token with any
other placement's (and a single big engine's) on their common length —
stream LENGTHS may differ where policy-dependent timeouts, degradation
tiers or sheds truncate, the TOKENS may not. That overlap parity (with
its coverage counts) is the cluster bench's correctness gate.

Over ``serving.sim`` replicas the router replays the ~10^5-request
``synthesize_cluster_trace`` through every policy in seconds; the
claims it is held to are prefix_aware goodput above round_robin with
fairness held, strictly more prefill saved, parity, and the drain/join
conservation invariant.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

from ..obs import flight as obs_flight
from ..obs import ledger as obs_ledger
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from .autoscale import Autoscaler
from .engine import (EngineSession, KVHandoff, ServeResult,
                     ServingEngine, UnstampedHandoffError)
from .faults import (FAULT_SEVERITY, FailoverConfig, FaultEvent,
                     FaultPlan)
from .metrics import _pct, goodput_tokens, jain_fairness
from .workload import Request


class PlacementPolicy:
    """Chooses the replica one arriving request runs on. ``replicas``
    is the ADMITTING subset, creation order; return one of them. A
    policy may keep state (round-robin's rotation) — one policy
    instance serves one ``ClusterRouter.run``."""

    name = "base"

    def place(self, r: Request, replicas: List["_Replica"]) -> "_Replica":
        raise NotImplementedError


class RoundRobinPlacement(PlacementPolicy):
    name = "round_robin"

    def __init__(self):
        self._i = 0

    def place(self, r, replicas):
        rep = replicas[self._i % len(replicas)]
        self._i += 1
        return rep


def _least_loaded(replicas):
    return min(replicas, key=lambda rep: (rep.session.load(), rep.index))


class LeastLoadedPlacement(PlacementPolicy):
    name = "least_loaded"

    def place(self, r, replicas):
        return _least_loaded(replicas)


class PrefixAwarePlacement(PlacementPolicy):
    """Send sharers where their (cached) state lives; everyone else
    least loaded. Two residency signals, one discipline:

    - **adapter residency** (multi-model serving): a request naming a
      LoRA adapter prefers a replica whose device bank already HOLDS
      that adapter (non-acquiring ``adapter_resident`` probe; ties —
      least loaded among holders) — re-uploading a delta set on N
      replicas is exactly the thrash re-prefilling a shared prompt N
      times is, so the same placement rule covers both. Residency is
      a PREFERENCE, not a pin: when the least-loaded holder is
      already ``adapter_load_slack`` requests deeper than the
      least-loaded replica overall, the request goes there instead
      and the hot adapter REPLICATES (one more upload buys another
      replica's worth of capacity — the S-LoRA fleet behavior; a
      sticky rule would recreate the one-model-per-replica split's
      hot-spot exactly). With no holder, fall through to the
      prefix/least-loaded logic below (the chosen replica uploads
      once and becomes the holder).
    - **prefix residency**: the prefix rule — probe every replica's
      paged pool with the non-acquiring ``match_prefix`` and steer to
      a replica holding >= ``threshold`` tokens of the prompt (page
      multiple; default one page), ties least loaded; below
      threshold, least loaded overall."""

    name = "prefix_aware"

    def __init__(self, threshold: Optional[int] = None,
                 adapter_load_slack: Optional[int] = None):
        if threshold is not None and threshold < 1:
            raise ValueError("prefix threshold must be >= 1 token")
        if adapter_load_slack is not None and adapter_load_slack < 1:
            raise ValueError("adapter_load_slack must be >= 1 "
                             "request")
        self.threshold = threshold
        self.adapter_load_slack = adapter_load_slack

    def place(self, r, replicas):
        if r.adapter is not None:
            holders = [rep for rep in replicas
                       if rep.session.adapter_resident(r.adapter)]
            if holders:
                best_h = _least_loaded(holders)
                best_all = _least_loaded(replicas)
                slack = self.adapter_load_slack \
                    if self.adapter_load_slack is not None \
                    else max(1, replicas[0].session.eng.slots // 2)
                if best_h.session.load() \
                        <= best_all.session.load() + slack:
                    return best_h
                return best_all  # replicate the hot adapter there
        probes = [(rep.session.match_prefix(r.prompt), rep)
                  for rep in replicas]
        # the default threshold is each replica's OWN page geometry (a
        # pool publishes prefixes in its own page multiples) — the old
        # replicas[0] fallback silently mis-thresholded every other
        # member of a heterogeneous fleet; homogeneous fleets score
        # identically
        hits = [(p, rep) for p, rep in probes
                if p >= (self.threshold if self.threshold is not None
                         else rep.session.eng.page_size)]
        if hits:
            best = max(p for p, _ in hits)
            return _least_loaded([rep for p, rep in hits
                                  if p == best])
        return _least_loaded(replicas)


def _place_decode(h: KVHandoff, replicas,
                  prices=None) -> Optional["_Replica"]:
    """The decode stage's default placement: the CHEAPEST-to-import
    decode-capable replica (``prices`` maps replica name → priced
    reshard/repage/transcode cost on the virtual clock; a twin — same
    tp/geometry/codec — prices 0.0, so homogeneous fleets keep the
    pre-hetero order exactly), then the most open decode slots (slot
    availability is the decode lane's scarce resource; load then
    creation order break ties). None when no candidate is
    decode-capable."""
    cands = [rep for rep in replicas
             if rep.role in ("decode", "both")]
    if not cands:
        return None
    pr = prices or {}
    return min(cands, key=lambda rep: (pr.get(rep.name, 0.0),
                                       -rep.session.free_slot_count(),
                                       rep.session.load(), rep.index))


class DisaggregatedPlacement(PlacementPolicy):
    """DistServe/Splitwise-style phase-split placement: ADMISSIONS go
    to prefill-capable workers (role "prefill" or "both"), each
    placed where its prefill finishes soonest — the candidate's
    pending prefill-chunk backlog (queued prompts + async-lane
    remainder) plus THIS prompt's own uncached chunks via the
    non-acquiring ``match_prefix`` probe: the
    ``ServiceEstimator.prefill_cost`` arithmetic in chunk units
    (replicas share one cost table, so the unit cancels). DECODE
    placement happens per finished prefill at handoff time
    (``place_decode``): the decode-capable worker with the most open
    slots. With no roles configured every replica is "both" and this
    degrades to backlog-aware least-loaded placement (no handoffs
    ever fire)."""

    name = "disaggregated"

    def place(self, r, replicas):
        cands = [rep for rep in replicas
                 if rep.role in ("prefill", "both")] or list(replicas)

        def score(rep):
            s = rep.session
            own = -(-max(0, len(r.prompt)
                         - s.match_prefix(r.prompt)) // s.eng.chunk_C)
            # the final chunk always runs (last-position logits), so
            # even a fully-cached prompt costs one chunk
            return (s.prefill_backlog() + max(1, own), s.load(),
                    rep.index)
        return min(cands, key=score)

    @staticmethod
    def place_decode(h: KVHandoff, replicas, prices=None):
        return _place_decode(h, replicas, prices)


def make_placement(spec, threshold: Optional[int] = None) \
        -> PlacementPolicy:
    if isinstance(spec, PlacementPolicy):
        return spec
    if spec == "round_robin":
        return RoundRobinPlacement()
    if spec == "least_loaded":
        return LeastLoadedPlacement()
    if spec == "prefix_aware":
        return PrefixAwarePlacement(threshold)
    if spec == "disaggregated":
        return DisaggregatedPlacement()
    raise ValueError(f"placement {spec!r}: use 'round_robin', "
                     "'least_loaded', 'prefix_aware', "
                     "'disaggregated' or a PlacementPolicy instance")


class _ReplicaTracer:
    """Track-prefixing view of one shared Tracer: replica ``name``'s
    engine events land on ``<name>/...`` tracks, so a cluster trace
    renders one lane group per replica and ``trace_report.py --json``
    can report per-replica occupancy. Engine events always stamp
    explicit times, so N per-replica virtual clocks share the tracer
    safely."""

    def __init__(self, tracer, name: str):
        self._t = tracer
        self._p = name

    def add_span(self, name, t0, dur, track="main", **attrs):
        self._t.add_span(name, t0, dur, track=f"{self._p}/{track}",
                         **attrs)

    def instant(self, name, t=None, track="main", **attrs):
        self._t.instant(name, t=t, track=f"{self._p}/{track}", **attrs)

    def counter(self, name, value, t=None, track="counters"):
        self._t.counter(name, value, t=t, track=f"{self._p}/{track}")

    def async_begin(self, name, id_, t=None, track="main", **kw):
        self._t.async_begin(name, id_, t=t,
                            track=f"{self._p}/{track}", **kw)

    def async_end(self, name, id_, t=None, track="main", **kw):
        self._t.async_end(name, id_, t=t,
                          track=f"{self._p}/{track}", **kw)

    def __getattr__(self, k):  # events/export/clear/... pass through
        return getattr(self._t, k)


class _Replica:
    __slots__ = ("name", "index", "session", "admitting", "joined_at",
                 "drained_at", "last_seen", "role", "monitor")

    def __init__(self, name: str, index: int, session: EngineSession,
                 joined_at: float, role: str = "both"):
        self.name = name
        self.index = index          # creation order: the tie-breaker
        self.session = session
        self.admitting = True
        self.joined_at = joined_at
        self.drained_at: Optional[float] = None
        # last time this replica answered a health probe (any timeline
        # step while its session is alive); a crashed session goes
        # silent and the gap is what the failure detector reads
        self.last_seen = joined_at
        # disaggregation stage ("prefill" / "decode" / "both") — the
        # session enforces it; the placement policy reads it
        self.role = role
        # this replica's SLOMonitor (shared IncidentLog), None when
        # the router runs without an SLO config
        self.monitor = None


@dataclasses.dataclass
class ClusterResult:
    """One cluster replay: per-replica ServeResults plus the router's
    own ledger (placements/requeues/retries) and lifecycle event log.
    Under a fault plan, ``salvaged`` holds the tokens each failed-over
    request had already emitted before its replica died (the stream
    prefix its retry resumed from) and ``failed`` the requests whose
    retry budget ran out — accounted exactly once, never silently
    lost."""

    placement: str
    results: Dict[str, ServeResult]     # replica -> final result
    ledger: Dict[str, dict]             # rid -> {tenant, replica,
    #                                     requeues, retries, path}
    events: List[dict]                  # drain/join/crash/remove log
    trace: Optional[object] = None      # the shared Tracer, if any
    salvaged: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)           # rid -> pre-crash tokens
    failed: Dict[str, str] = dataclasses.field(default_factory=dict)
    # rid -> reason (retry budget exhausted / unplaceable)
    faulted: bool = False               # a fault plan ran OR the
    # failover machinery actually engaged (backend-raised DecodeErrors
    # under a failover-only config); gates the chaos report/census
    # blocks so fault-free replays keep the fault-free records byte-for-byte
    handoffs: Dict = dataclasses.field(default_factory=dict)
    # disaggregated KV-handoff ledger {exported, imported, reclaimed,
    # failed} — empty (and absent from census/report) when no
    # prefill-role replica ever exported, so role-less replays keep
    # the role-less records byte-for-byte
    incidents: Optional[List] = None    # obs.slo.Incident list when
    # the router ran with slo=...; None otherwise. Deliberately NOT
    # folded into report()/census() — the obs_slo gate requires a
    # monitor-on replay's records byte-identical to monitor-off
    slo_log: Optional[object] = None    # the shared IncidentLog
    flight: Optional[object] = None     # the FlightRecorder, if any
    autoscale: Optional[dict] = None    # Autoscaler.summary() — the
    # byte-deterministic action log plus per-kind counts — when the
    # router ran with autoscale=...; None otherwise (and nothing in
    # the replay differs from a pre-autoscale router)
    replica_hours: Dict[str, dict] = dataclasses.field(
        default_factory=dict)           # name -> {joined, left, hours}
    # — the capacity-cost ledger elastic autoscaling is judged on
    # (replica-hours strictly below a static fleet at equal goodput)
    cost_rollup: Optional[dict] = None  # CostLedger.rollup() — the
    # request -> tenant -> feature attribution plus the cluster-wide
    # conservation audit — when the router ran with cost_ledger=...;
    # None otherwise (and nothing in the replay differs from a
    # pre-ledger router)
    cost_ledger: Optional[object] = None  # the shared CostLedger
    # itself (save_costs/publish live here); None when un-armed

    def save_costs(self, path: str) -> str:
        """Dump the shared cost ledger's attribution rows as JSONL
        (atomic; global conservation row LAST). Raises when the
        replay ran without ``cost_ledger=`` — there is nothing to
        save, and an empty file would read as a costless cluster."""
        if self.cost_ledger is None:
            raise ValueError("this replay ran without cost_ledger=; "
                             "no cost rows to save")
        return self.cost_ledger.save_costs(path)

    def replica_hours_total(self) -> float:
        """Summed live time across every replica that ever joined —
        the denominator of the autoscaling economics claim."""
        return round(sum(h["hours"]
                         for h in self.replica_hours.values()), 6)

    def save_actions(self, path: str) -> str:
        """Dump the autoscaler's action log as JSONL (atomic, the
        shared ``obs`` write discipline) — the artifact the
        determinism gate byte-compares across seeded replays. Raises
        when the router ran without autoscale=."""
        if self.autoscale is None:
            raise ValueError("this replay ran without an autoscaler "
                             "(ClusterRouter(autoscale=...)) — there "
                             "is no action log to save")
        import json as _json
        obs_slo._atomic_write(
            path, "".join(_json.dumps(a) + "\n"
                          for a in self.autoscale["actions"]))
        return path

    def save_incidents(self, path: str) -> str:
        """Dump the run's incident set as JSONL (atomic; loads back
        through ``obs.slo.load_incidents`` / the shared tolerant
        policy). Raises when the router ran without slo=."""
        if self.slo_log is None:
            raise ValueError("this replay ran without an SLO monitor "
                             "(ClusterRouter(slo=...)) — there is no "
                             "incident log to save")
        return self.slo_log.save(path)

    def outputs(self) -> Dict[str, List[int]]:
        """Every request's greedy stream, merged across replicas (rids
        are cluster-unique by the census invariant). A failed-over
        request's stream is its salvaged pre-crash tokens + what the
        survivor emitted after resuming — the full stream the client
        actually received, the one fault-free parity is judged on."""
        out: Dict[str, List[int]] = {}
        for name in self.results:
            out.update(self.results[name].outputs)
        for rid, pre in self.salvaged.items():
            if rid in out:
                out[rid] = list(pre) + list(out[rid])
        return out

    def census(self) -> dict:
        """The no-request-lost-or-duplicated invariant, per tenant:
        every routed rid finished, shed, OR exhausted its retry budget
        on EXACTLY one replica, and ``completed + shed + failed ==
        arrived`` for each tenant (``failed`` is nonzero only when
        the failover machinery engaged — a fault plan or a
        backend-raised DecodeError under a failover config — or when
        a disaggregated KV handoff found no decode-capable replica
        that could adopt it, the one placement failure a role-ful
        router accounts instead of crashing on). Also folds in each
        replica's pool census (``invariant_ok``) and, for retired or
        crashed replicas, the at-removal census the router recorded."""
        seen: Dict[str, str] = {}
        dup: List[str] = []
        per: Dict[str, dict] = {}

        def bump(tenant, key):
            t = tenant if tenant is not None else "_none"
            d = per.setdefault(t, {"arrived": 0, "completed": 0,
                                   "shed": 0})
            d[key] = d.get(key, 0) + 1

        for rid, led in self.ledger.items():
            bump(led["tenant"], "arrived")
        for name, res in self.results.items():
            for rid in res.outputs:
                if rid in seen:
                    dup.append(rid)
                seen[rid] = name
                bump(self.ledger[rid]["tenant"], "completed")
            for rid in res.shed:
                if rid in seen:
                    dup.append(rid)
                seen[rid] = name
                bump(self.ledger[rid]["tenant"], "shed")
        for rid in self.failed:
            if rid in seen:
                dup.append(rid)
            seen[rid] = "_failed"
            bump(self.ledger[rid]["tenant"], "failed")
        lost = sorted(set(self.ledger) - set(seen))
        conserved = all(v["completed"] + v["shed"]
                        + v.get("failed", 0) == v["arrived"]
                        for v in per.values())
        pools_ok = all(res.cache_stats.get("invariant_ok") is True
                       for res in self.results.values())
        removal_ok = all(e.get("census_ok", True) for e in self.events)
        out = {"tenants": per,
               "duplicated": sorted(set(dup)), "lost": lost,
               "conserved": bool(conserved and not dup and not lost),
               "pool_census_ok": bool(pools_ok),
               "removal_census_ok": bool(removal_ok),
               "requeued": sum(1 for led in self.ledger.values()
                               if led["requeues"])}
        if self.faulted:
            out["retried"] = sum(1 for led in self.ledger.values()
                                 if led.get("retries"))
            out["failed"] = len(self.failed)
        if self.handoffs.get("exported"):
            # the exactly-once KV-handoff balance: every exported
            # chain was imported by a decode worker, reclaimed (its
            # destination drained/crashed before adopting it — the
            # request re-placed and re-prefilled), or accounted
            # FAILED; nothing vanished in flight
            ho = dict(self.handoffs)
            ho["balanced"] = (ho["exported"] == ho["imported"]
                              + ho["reclaimed"] + ho["failed"])
            out["handoffs"] = ho
            out["conserved"] = bool(out["conserved"]
                                    and ho["balanced"])
        return out

    def report(self, tenant_weights: Optional[Dict[str, float]] = None) \
            -> dict:
        """The cluster rollup: per-replica ``report()`` blocks reduced
        to cluster goodput, TTFT/TPOT percentiles, per-tenant Jain
        fairness (the SAME ``jain_fairness``/``goodput_tokens``
        helpers the per-run QoS block uses) and per-replica prefix hit
        rates."""
        rows: List[dict] = []
        for name in self.results:
            for v in self.results[name].metrics.request_rows():
                v["replica"] = name
                rows.append(v)
        done = [v for v in rows if v["finish"] is not None]
        shed = [v for v in rows if v["shed"]]
        ttfts = [v["ttft"] for v in done if v["ttft"] is not None]
        tpots = [v["tpot"] for v in done if v["tpot"] is not None]
        arrivals = [v["arrival"] for v in rows]
        finishes = [v["finish"] for v in done]
        makespan = (max(finishes) - min(arrivals)) \
            if finishes and arrivals else 0.0
        tokens = sum(v["n_tokens"] for v in done)
        good = goodput_tokens(done)
        rec: dict = {
            "placement": self.placement,
            "replicas": len(self.results),
            "arrived": len(rows),
            "completed": len(done),
            "shed": len(shed),
            "shed_rate": round(len(shed) / len(rows), 4) if rows
            else 0.0,
            "generated_tokens": tokens,
            "makespan": round(makespan, 6),
            "tokens_per_sec": round(tokens / makespan, 4)
            if makespan > 0 else None,
            "goodput_tokens": good,
            "goodput_tokens_per_sec": round(good / makespan, 4)
            if makespan > 0 else None,
            "ttft_p50": _pct(ttfts, 50), "ttft_p95": _pct(ttfts, 95),
            "tpot_p50": _pct(tpots, 50), "tpot_p95": _pct(tpots, 95),
        }
        with_dl = [v for v in done if v["deadline_ms"] is not None]
        if with_dl:
            rec["slo_deadline_attained"] = round(
                sum(1 for v in with_dl if v["deadline_met"])
                / len(with_dl), 4)
        tenants = sorted({v["tenant"] for v in rows
                          if v["tenant"] is not None})
        if tenants:
            w = tenant_weights or {}
            per: Dict[str, dict] = {}
            xs = []
            for t in tenants:
                tv = [v for v in rows if v["tenant"] == t]
                gtok = goodput_tokens([v for v in tv
                                       if v["finish"] is not None])
                per[t] = {"arrived": len(tv),
                          "shed": sum(1 for v in tv if v["shed"]),
                          "completed": sum(1 for v in tv
                                           if v["finish"] is not None),
                          "goodput_tokens": gtok}
                xs.append(gtok / float(w.get(t, 1.0)))
            rec["tenants"] = per
            rec["fairness_jain"] = jain_fairness(xs)
        per_rep: Dict[str, dict] = {}
        saved_total = 0
        prefill_total = 0
        for name in sorted(self.results):
            res = self.results[name]
            rrep = res.report()
            saved = int(rrep.get("prefill_tokens_saved", 0))
            saved_total += saved
            prefill_total += res.prefill_tokens
            per_rep[name] = {
                "completed": rrep["completed"],
                "shed": len(res.shed),
                "prefill_tokens": res.prefill_tokens,
                "prefill_tokens_saved": saved,
                "prefix_hit_tokens": sum(res.prefix_cached.values()),
                "prefix_hit_rate": res.cache_stats.get("hit_rate"),
                "census_ok": res.cache_stats.get("invariant_ok"),
                "drained": any(e.get("replica") == name
                               and e.get("event") == "drain"
                               for e in self.events),
            }
        rec["prefill_tokens"] = prefill_total
        rec["prefill_tokens_saved"] = saved_total
        rec["per_replica"] = per_rep
        rec["lifecycle_events"] = len(self.events)
        if self.faulted:
            # the chaos block appears ONLY when a fault plan ran — a
            # fault-free replay keeps the fault-free record byte-for-byte
            ev = [e["event"] for e in self.events]
            rec["crashes"] = ev.count("crash")
            rec["stalls"] = ev.count("stall")
            rec["decode_errors"] = ev.count("decode_error")
            rec["failovers"] = ev.count("dead")
            rec["retried_requests"] = sum(
                1 for led in self.ledger.values()
                if led.get("retries"))
            rec["resumed_with_salvage"] = len(self.salvaged)
            rec["failed_requests"] = len(self.failed)
        if self.handoffs.get("exported"):
            # only disaggregated (role-ful) replays grow this block
            rec["kv_handoffs"] = dict(self.handoffs)
            rec["handed_off_requests"] = sum(
                1 for led in self.ledger.values()
                if led.get("handoffs"))
        rec["replica_hours"] = self.replica_hours_total()
        if self.autoscale is not None:
            # only autoscaled replays grow this block
            rec["autoscale"] = {k: self.autoscale[k]
                                for k in ("joins", "drains",
                                          "drain_noops",
                                          "role_changes", "degrades")}
        return rec


class ClusterRouter:
    """N engine replicas, one placement seam, one shared virtual
    timeline.

    ``spawn(name) -> ServingEngine`` builds one replica's engine (its
    OWN serving factory — factories share live pool buffers, so two
    replicas over one factory would corrupt each other's K/V; the sim
    factory makes this cheap at any scale). ``run(trace, events)``
    replays one arrival-ordered trace, advancing every replica's lane
    to each arrival/lifecycle time before acting, so placement probes
    (load, prefix match) are causally honest. A router runs ONCE —
    build a fresh one per replay (determinism: same trace + events +
    policy -> byte-identical ClusterResult).

    ``events`` schedules lifecycle transitions deterministically:
    ``[(t, "drain", name), (t, "join", name)]``; joins sort before
    drains at equal ``t`` so a drain's requeued backlog can land on
    the replica that just joined.

    ``faults`` (a ``faults.FaultPlan``) schedules crash / stall /
    decode-error injection on the same timeline; ``failover`` (a
    ``faults.FailoverConfig``, defaulted when a plan is given) sets
    the heartbeat detector and retry/backoff policy. With
    ``faults=None`` the fault machinery is entirely inert — no probe
    ticks, no detection pass — and the replay is byte-identical to a
    fault-unaware router.
    """

    def __init__(self, spawn, n_replicas: int = 2, *,
                 placement="prefix_aware",
                 prefix_threshold: Optional[int] = None,
                 trace=None, faults: Optional[FaultPlan] = None,
                 failover: Optional[FailoverConfig] = None,
                 roles: Optional[Dict[str, str]] = None,
                 kv_transfer_unit: float = 0.0,
                 slo=None, flight=None, slo_on_incident=(),
                 autoscale: Optional[Autoscaler] = None,
                 cost_ledger=None):
        if not callable(spawn):
            raise ValueError("spawn must be callable: name -> "
                             "ServingEngine (one engine+factory per "
                             "replica)")
        if n_replicas < 1:
            raise ValueError("need >= 1 replica")
        self._spawn = spawn
        self.n_replicas = n_replicas
        self.placement = make_placement(placement, prefix_threshold)
        self._trace_spec = trace
        self._tracer: Optional[obs_trace.Tracer] = None
        self.replicas: List[_Replica] = []
        self.results: Dict[str, ServeResult] = {}
        self.ledger: Dict[str, dict] = {}
        self.events_log: List[dict] = []
        self._next_index = 0
        self._expect_churn = False
        self._ran = False
        self._g_load = obs_metrics.REGISTRY.gauge
        if faults is not None and not isinstance(faults, FaultPlan):
            faults = FaultPlan(list(faults))
        self._faults = faults
        # failover defaults alongside a fault plan; it may also be
        # passed ALONE — the retry policy for rows a backend-raised
        # DecodeError aborts without any scheduled fault
        self.failover = failover if failover is not None \
            else (FailoverConfig() if faults is not None else None)
        self._salvage: Dict[str, List[int]] = {}
        self.failed: Dict[str, str] = {}
        self._heap: List[tuple] = []
        self._seq = 0
        self._ctr_failovers = obs_metrics.REGISTRY.counter(
            "cluster_failovers_total",
            "replicas declared dead and failed over")
        # --- disaggregation (inert without roles) -------------------
        # roles: replica name -> "prefill" | "decode" | "both"
        # (unnamed replicas default to "both"). A prefill-role
        # session exports every finished prefill as a KVHandoff; the
        # router prices its delivery at kv_transfer_unit PER PAGE on
        # the shared timeline and places it on a decode worker
        # (placement.place_decode when the policy has one, most open
        # slots otherwise). With roles=None no session ever exports
        # and the replay is byte-identical to a role-unaware router.
        if roles:
            bad = {n: v for n, v in roles.items()
                   if v not in ("prefill", "decode", "both")}
            if bad:
                raise ValueError(f"roles {bad}: use 'prefill', "
                                 "'decode' or 'both'")
        self._roles = dict(roles or {})
        if kv_transfer_unit < 0:
            raise ValueError("kv_transfer_unit must be >= 0")
        self.kv_transfer_unit = float(kv_transfer_unit)
        self._handoff = {"exported": 0, "imported": 0,
                         "reclaimed": 0, "failed": 0}
        # per-axis count of handoffs TRANSFORMED on import (tp /
        # page / codec); stays empty — and absent from results — on
        # homogeneous fleets
        self._resharded: Dict[str, int] = {}
        # --- SLO watchdog (inert without slo=) ----------------------
        # slo: a sequence of obs.slo rules (may be EMPTY — fault
        # events and heartbeats still auto-open/feed incidents). The
        # router builds ONE SLOMonitor per replica over ONE shared
        # IncidentLog, so ids stay cluster-unique and open-order
        # deterministic; drain/join changes the watched membership
        # (a joiner gets a monitor at join time, a removed replica's
        # monitor retires — its silence is no longer an alert).
        # flight: a FlightRecorder, or a bundle-directory path string
        # (a recorder is built over it) — incidents then freeze
        # postmortem bundles; requires slo=. slo_on_incident:
        # callbacks delivered every incident as it opens (the QoS
        # degradation seam — e.g. a scheduler's note_incident).
        if slo is not None and isinstance(slo, obs_slo.SLOMonitor):
            raise ValueError("cluster slo= takes a RULES sequence, "
                             "not a monitor — the router builds one "
                             "monitor per replica over a shared "
                             "IncidentLog")
        self._slo_rules = None if slo is None else list(slo)
        self._slo_cbs = list(slo_on_incident)
        # --- elastic autoscaling (inert without autoscale=) ---------
        # autoscale: an autoscale.Autoscaler — the control plane that
        # ACTS on the incident stream: joins standby replicas on
        # sustained burn, drains idle ones when the budget recovers,
        # re-assigns prefill<->decode roles as the mix shifts, and
        # fans page incidents into every live QoSScheduler (tier
        # actuation). Decisions run at fixed ticks on the shared
        # timeline (plus the incident-open callback), so seeded
        # replays produce a byte-identical action log. Requires slo=
        # (the detect half of the loop); with autoscale=None nothing
        # here runs and the replay is byte-identical to a
        # pre-autoscale router.
        if autoscale is not None \
                and not isinstance(autoscale, Autoscaler):
            raise ValueError("autoscale= takes an autoscale.Autoscaler")
        if autoscale is not None and slo is None:
            raise ValueError("autoscale= needs slo= (pass a rules "
                             "sequence — even [] — so the autoscaler "
                             "has an incident stream to subscribe to)")
        self._autoscaler = autoscale
        if autoscale is not None:
            autoscale.attach()
            # subscription BEFORE the monitors copy the callback list
            self._slo_cbs.append(self._autoscale_on_incident)
        # --- cost ledger (inert without cost_ledger=) ---------------
        # cost_ledger: True builds ONE shared obs.ledger.CostLedger
        # (or pass an instance) that every spawned replica's engine
        # books against — one book per replica plus a "cluster" book
        # for router-priced kv_transfer units. A request's account is
        # SHARED across replicas, so handoff/failover/preempt move
        # its open account exactly once (accounts are keyed by rid,
        # not replica). None keeps every replay byte-identical to a
        # pre-ledger router. (Distinct from self.ledger — the
        # placement bookkeeping dict that predates cost accounting.)
        if cost_ledger is True:
            cost_ledger = obs_ledger.CostLedger()
        if cost_ledger is not None \
                and not isinstance(cost_ledger, obs_ledger.CostLedger):
            raise ValueError("cost_ledger= takes True or an "
                             "obs.ledger.CostLedger instance")
        self._cost_ledger = cost_ledger
        self._hours: Dict[str, dict] = {}
        if flight is not None and slo is None:
            raise ValueError("flight= needs slo= (bundles are written "
                             "when an SLO incident fires)")
        if isinstance(flight, str):
            flight = obs_flight.FlightRecorder(bundle_dir=flight)
        self.flight = flight
        self.slo_log: Optional[obs_slo.IncidentLog] = None
        self._mon_cluster: Optional[obs_slo.SLOMonitor] = None
        if self._slo_rules is not None:
            self.slo_log = obs_slo.IncidentLog()
            # router-scope events (a retry budget exhausting, an
            # unadoptable KV handoff) have no single replica to blame
            self._mon_cluster = obs_slo.SLOMonitor(
                [], source="cluster", log=self.slo_log,
                flight=self.flight, on_incident=self._slo_cbs)

    # --- lifecycle --------------------------------------------------------
    def _add_replica(self, name: str, t: float) -> _Replica:
        if any(rep.name == name for rep in self.replicas):
            raise ValueError(f"replica {name!r} already live")
        if name in self.results:
            # a retired name's ServeResult is already banked; reusing
            # it would overwrite that history and read as lost
            # requests in census() — force a fresh name instead
            raise ValueError(f"replica {name!r} already served and "
                             "retired this run — join under a fresh "
                             "name")
        eng = self._spawn(name)
        if not isinstance(eng, ServingEngine):
            raise ValueError(f"spawn({name!r}) returned "
                             f"{type(eng).__name__}, not a "
                             "ServingEngine")
        tr = _ReplicaTracer(self._tracer, name) \
            if self._tracer is not None else None
        if self._cost_ledger is not None:
            # every replica books on the ONE shared ledger (accounts
            # are rid-keyed, so a handed-off request keeps its single
            # open account across replicas); injected before session
            # creation so the session clock is ledger-armed from birth
            eng._ledger = self._cost_ledger
        role = self._roles.get(name, "both")
        mon = None
        if self._slo_rules is not None:
            mon = obs_slo.SLOMonitor(self._slo_rules, source=name,
                                     t0=t, log=self.slo_log,
                                     flight=self.flight,
                                     on_incident=self._slo_cbs)
        sess = eng.session(tracer=tr, replica=name,
                           expect_churn=self._expect_churn, role=role,
                           slo=mon)
        sess.clock.advance_to(t)   # a joiner starts life at NOW
        rep = _Replica(name, self._next_index, sess, joined_at=t,
                       role=role)
        rep.monitor = mon
        self._next_index += 1
        self.replicas.append(rep)
        self._hours[name] = {"joined": round(t, 6), "left": None,
                             "hours": 0.0}
        if self._autoscaler is not None and sess.sched is not None \
                and hasattr(sess.sched, "note_incident"):
            # a joiner enters mid-incident degraded like its peers:
            # page incidents that are still open reach its scheduler
            # now, not at the next incident (custom schedulers
            # without the seam are skipped, same as at incident-open)
            for inc in self._autoscaler.open_page_incidents():
                sess.sched.note_incident(inc)
        self._g_load("cluster_replica_load",
                     "queued + in-flight requests on a replica",
                     replica=name).set(0.0)
        if role != "both" and self._tracer is not None:
            self._tracer.instant("role", t=t, track="cluster",
                                 replica=name, role=role)
        return rep

    def _rep(self, name: str) -> _Replica:
        rep = self._find(name)
        if rep is None:
            raise ValueError(f"no live replica {name!r}")
        return rep

    def _join(self, name: str, t: float):
        self._add_replica(name, t)
        self.events_log.append({"t": round(t, 6), "event": "join",
                                "replica": name})
        if self._tracer is not None:
            self._tracer.instant("join", t=t, track="cluster",
                                 replica=name)

    def _drain(self, name: str, t: float):
        rep = self._rep(name)
        if rep.session.crashed:
            # the operator drained a replica that is already dead but
            # not yet detected: a graceful drain is impossible (the
            # in-flight rows died at the crash) — resolve as an
            # immediate failover so the crash salvage is NOT dropped
            self.events_log.append({"t": round(t, 6),
                                    "event": "drain_found_dead",
                                    "replica": name})
            self._declare_dead(rep, t)
            return
        if not rep.admitting:
            raise ValueError(f"replica {name!r} is already draining")
        rep.admitting = False
        rep.drained_at = t
        rep.session.more_expected = False
        pulled = rep.session.pull_unadmitted()
        self.events_log.append({"t": round(t, 6), "event": "drain",
                                "replica": name,
                                "requeued": [r.rid for r in pulled],
                                "in_flight": len(rep.session.active)})
        if self._tracer is not None:
            self._tracer.instant("drain", t=t, track="cluster",
                                 replica=name, requeued=len(pulled))
        for r in pulled:
            self.ledger[r.rid]["requeues"] += 1
            # a drained queue may hold a resumed (salvage-grown)
            # request in a heterogeneous cluster: route it through the
            # same fit-aware placement the retry path uses, so it can
            # never be submitted to a replica it cannot fit
            self._place_or_fail(r, t)
        self._maybe_retire(rep)

    def _maybe_retire(self, rep: _Replica):
        """A draining replica whose in-flight rows have all finished
        leaves the cluster; its pool census must balance with ZERO
        resident pages (every sequence freed) at removal. A replica
        that CRASHED while draining is never retired here — its crash
        salvage must leave through ``_declare_dead``'s failover, not
        be banked away with the corpse. A prefill-role replica with
        uncollected handoffs is not done either: banking it away
        would bury exported KV the router still owes a decode
        worker."""
        if rep.admitting or rep.session.in_flight() \
                or rep.session.queued() or rep.session.handoff_ready:
            return
        if rep.session.crashed:
            return
        self._bank_removal(rep, rep.session.clock.now())

    def _bank_removal(self, rep: _Replica, t: float, **extra) -> bool:
        """The one replica-removal block (drain retirement AND crash
        failover share it): finish the session, check the at-removal
        pool census (zero resident pages), bank the result, drop the
        replica and zero its load gauge, log the ``remove`` event
        (``extra`` tags crash removals with ``crashed``/``pool_epoch``)."""
        res = rep.session.finish()
        self._fold_handoff_stats(rep.session)
        if rep.monitor is not None:
            # membership change: the departing replica's monitor
            # retires — open incidents close (crash ones were already
            # resolved "failover" by _declare_dead) and its silence
            # stops being evaluated
            rep.monitor.retire(t, resolution="failover"
                               if extra.get("crashed")
                               else "replica_removed")
        cs = res.cache_stats
        ok = bool(cs.get("invariant_ok")
                  and cs.get("resident_pages") == 0)
        self.results[rep.name] = res
        self._close_hours(rep.name, t)
        self.replicas.remove(rep)
        self._g_load("cluster_replica_load",
                     "queued + in-flight requests on a replica",
                     replica=rep.name).set(0.0)
        self.events_log.append({
            "t": round(t, 6), "event": "remove",
            "replica": rep.name, "census_ok": ok,
            "resident_pages": cs.get("resident_pages"), **extra})
        if self._tracer is not None:
            attrs = {"crashed": True} if extra.get("crashed") else {}
            self._tracer.instant("remove", t=t, track="cluster",
                                 replica=rep.name, census_ok=ok,
                                 **attrs)
        return ok

    # --- placement --------------------------------------------------------
    def _place(self, r: Request, requeue: bool = False, only=None):
        """``only`` (predicate over replicas) narrows the candidate
        set — the retry path restricts a resumed request to survivors
        whose engine footprint actually admits it."""
        cands = [rep for rep in self.replicas if rep.admitting]
        if only is not None:
            cands = [rep for rep in cands if only(rep)]
        if not cands:
            raise RuntimeError(
                f"no admitting replica for {r.rid} — drained the whole "
                "cluster with work still arriving")
        rep = self.placement.place(r, cands)
        rep.session.submit(r)
        led = self.ledger.get(r.rid)
        if led is None:
            self.ledger[r.rid] = {"tenant": r.tenant,
                                  "replica": rep.name, "requeues": 0,
                                  "retries": 0, "path": [rep.name]}
        else:
            led["replica"] = rep.name
            led["path"].append(rep.name)
        # refresh EVERY admitting replica's gauge, not just the chosen
        # one — a replica that drains its backlog between placements
        # must not export its stale last-placement load
        for rep2 in cands:
            self._g_load("cluster_replica_load",
                         "queued + in-flight requests on a replica",
                         replica=rep2.name).set(
                float(rep2.session.load()))

    # --- KV handoff routing (the disaggregated decode stage) --------------
    def _fold_handoff_stats(self, sess: EngineSession):
        """Accumulate a session's import/reclaim counts into the
        router's handoff ledger exactly once — at removal (crash or
        retirement) or at the end-of-run bank."""
        self._handoff["imported"] += sess.handoff_stats["imported"]
        self._handoff["reclaimed"] += sess.handoff_stats["reclaimed"]
        sess.handoff_stats = {"imported": 0, "reclaimed": 0}
        for axis, n in sess.handoff_resharded.items():
            self._resharded[axis] = self._resharded.get(axis, 0) + n
        sess.handoff_resharded = {}

    def _collect_handoffs(self):
        """Drain every session's handoff bank and place each exported
        KV chain on a decode worker: delivery is priced at
        ``kv_transfer_unit`` per page on the shared timeline
        (``t_arrive = t_ready + pages * unit``), the ledger moves the
        request to its decode replica (counted once — the source
        forgot it at export), and a timeline tick lands at the
        delivery time so lanes advance to meet it. Candidates are no
        longer FILTERED on tp degree / page geometry / codec — each
        admitting, footprint-fitting replica is SCORED by the priced
        cost of the reshard/repage/transcode steps its import would
        run (``handoff_steps`` verdict + ``handoff_price``), and the
        placement policy breaks ties among prices; a twin prices 0.0
        so homogeneous fleets place identically to the old filters.
        Only a genuinely untransformable pairing (quantized source
        under a different codec, pressure across page geometries) or
        a footprint miss drops a candidate. An UNSTAMPED handoff
        (page_size/tp never filled in by the exporter) refuses loudly
        — scoring garbage geometry would mis-price every candidate. A
        handoff no admitting decode-capable replica can take is
        recorded FAILED — accounted, never silently dropped."""
        for rep in list(self.replicas):
            if not rep.session.handoff_ready:
                continue
            ready = rep.session.handoff_ready
            rep.session.handoff_ready = []
            for h in ready:
                self._handoff["exported"] += 1
                rid = h.req.rid
                led = self.ledger[rid]
                led["handoffs"] = led.get("handoffs", 0) + 1
                if h.page_size <= 0 or h.tp <= 0:
                    raise UnstampedHandoffError(h)
                cands, prices, axes = [], {}, {}
                for x in self.replicas:
                    if not (x.admitting and self._rep_fits(
                            x, len(h.req.prompt),
                            h.req.max_new_tokens)):
                        continue
                    steps = x.session.eng.handoff_steps(h)
                    if steps is None:
                        continue
                    cands.append(x)
                    prices[x.name] = x.session.eng.handoff_price(
                        h, steps)
                    axes[x.name] = steps
                pd = getattr(self.placement, "place_decode", None)
                if pd is None:
                    dest = _place_decode(h, cands, prices)
                else:
                    try:
                        dest = pd(h, cands, prices)
                    except TypeError:
                        # a pre-hetero custom policy takes (h, cands)
                        dest = pd(h, cands)
                if dest is None:
                    self._handoff["failed"] += 1
                    self.failed[rid] = (
                        "no admitting decode-capable replica can "
                        "adopt the handed-off KV chain (every "
                        "candidate is full, untransformable from "
                        "the chain's codec, or too small for its "
                        "footprint)")
                    self.events_log.append(
                        {"t": round(h.t_ready, 6),
                         "event": "handoff_failed", "rid": rid})
                    if self._tracer is not None:
                        self._tracer.instant("handoff_failed",
                                             t=h.t_ready,
                                             track="cluster", rid=rid)
                    if self._mon_cluster is not None:
                        self._mon_cluster.event(
                            "handoff_failed", h.t_ready,
                            severity=FAULT_SEVERITY["handoff_failed"],
                            close_t=h.t_ready, rids=[rid],
                            evidence={"pages": h.n_pages,
                                      "from": h.replica_from})
                    continue
                h.t_arrive = h.t_ready \
                    + self.kv_transfer_unit * h.n_pages
                if self._cost_ledger is not None:
                    # the transfer is router-priced (no engine clock
                    # ever times it), so it books on the router's own
                    # "cluster" book — elapsed grows by the same
                    # charge, keeping that book's conservation exact
                    self._cost_ledger.charge(
                        "cluster", "kv_transfer",
                        self.kv_transfer_unit * h.n_pages, rid=rid)
                dest.session.submit_handoff(h)
                led["replica"] = dest.name
                led["path"].append(dest.name)
                ev = {"t": round(h.t_ready, 6), "event": "handoff",
                      "rid": rid, "from": h.replica_from,
                      "to": dest.name, "pages": h.n_pages,
                      "arrive": round(h.t_arrive, 6)}
                # transform/price keys appear ONLY when the chosen
                # destination will actually run steps — twin-fleet
                # event streams stay byte-identical to pre-hetero
                steps = axes.get(dest.name) or ()
                if steps:
                    ev["transform"] = list(steps)
                    ev["price"] = round(prices[dest.name], 6)
                self.events_log.append(ev)
                if self._tracer is not None:
                    extra = ({"transform": ",".join(steps),
                              "price": round(prices[dest.name], 6)}
                             if steps else {})
                    self._tracer.instant(
                        "handoff", t=h.t_ready, track="cluster",
                        rid=rid, pages=h.n_pages, to=dest.name,
                        **{"from": h.replica_from}, **extra)
                self._push(h.t_arrive, 4, ("ht",))
                self._g_load("cluster_replica_load",
                             "queued + in-flight requests on a "
                             "replica", replica=dest.name).set(
                    float(dest.session.load()))

    # --- failure detection + failover -------------------------------------
    def _push(self, t: float, pri: int, item):
        heapq.heappush(self._heap, (float(t), pri, self._seq, item))
        self._seq += 1

    def _find(self, name: str) -> Optional[_Replica]:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        return None

    def _fault(self, ev: FaultEvent, t: float):
        rep = self._find(ev.replica)
        if rep is None:
            if ev.replica in self.results:
                # the target retired/died before the fault landed — a
                # seeded plan may legitimately outlive a replica; noop
                # loudly in the event log rather than crashing the
                # replay
                self.events_log.append({"t": round(t, 6),
                                        "event": f"{ev.kind}_noop",
                                        "replica": ev.replica,
                                        "reason": "already removed"})
                return
            # never joined (or joins later): the plan is unsatisfiable
            # as scheduled — silently swallowing the fault would make
            # the chaos evidence claim an injection that never
            # happened, so refuse loudly
            raise ValueError(
                f"fault plan targets replica {ev.replica!r} at "
                f"t={ev.t}, which has not joined the cluster — "
                "schedule faults inside the target's lifetime")
        if ev.kind == "crash":
            sess = rep.session
            n_inflight = len(sess.active)
            sess.crash()
            self.events_log.append({
                "t": round(t, 6), "event": "crash",
                "replica": rep.name, "in_flight": n_inflight,
                "queued": sess.queued()})
            if self._tracer is not None:
                self._tracer.instant("crash", t=t, track="cluster",
                                     replica=rep.name,
                                     in_flight=n_inflight)
            if rep.monitor is not None:
                # auto-open: the replica process died — ONE incident
                # per crash, open until the failover resolves it
                rep.monitor.event(
                    "crash", t, severity=FAULT_SEVERITY["crash"],
                    evidence={"in_flight": n_inflight,
                              "queued": sess.queued()})
        elif ev.kind == "stall":
            if rep.session.crashed:
                return
            # overlapping stalls extend, never shorten: the replica is
            # paused until the LATEST scheduled resume time
            rep.session.stall_until = max(
                rep.session.stall_until or 0.0, t + float(ev.duration))
            self.events_log.append({
                "t": round(t, 6), "event": "stall",
                "replica": rep.name, "duration": ev.duration})
            if self._tracer is not None:
                self._tracer.instant("stall", t=t, track="cluster",
                                     replica=rep.name,
                                     duration=ev.duration)
            if rep.monitor is not None:
                # one incident per injected stall, self-closing when
                # the pause ends (slow, not dead — "warn")
                rep.monitor.event(
                    "stall", t, severity=FAULT_SEVERITY["stall"],
                    close_t=t + float(ev.duration),
                    evidence={"duration": ev.duration,
                              "resume_at": round(
                                  rep.session.stall_until, 6)})
        else:  # decode_error
            sess = rep.session
            if sess.crashed or not sess.active:
                self.events_log.append({"t": round(t, 6),
                                        "event": "decode_error_noop",
                                        "replica": rep.name})
                return
            # deterministic victim: the OLDEST in-flight row (admit
            # time, rid tie-break) — a seeded plan needs no rid names
            rid = min(sess.active,
                      key=lambda r: (sess.active[r].t0, r))
            req, out = sess.abort_row(rid, reason="decode_error")
            self.events_log.append({
                "t": round(t, 6), "event": "decode_error",
                "replica": rep.name, "rid": rid, "salvaged": len(out)})
            if self._tracer is not None:
                self._tracer.instant("decode_error", t=t,
                                     track="cluster", replica=rep.name,
                                     rid=rid)
            if rep.monitor is not None:
                # a point incident: one slot failed, the row fails
                # over — service continues
                rep.monitor.event(
                    "decode_error", t,
                    severity=FAULT_SEVERITY["decode_error"],
                    close_t=t, rids=[rid],
                    evidence={"salvaged_tokens": len(out)})
            self._schedule_retry(req, out, t, reason="decode_error")

    def _collect_aborted(self, t: float) -> bool:
        """Drain every session's ``aborted`` bank (rows a DecodeError
        raised from inside a decode turn tore down — the backend-
        exception path, as opposed to the plan's decode_error events
        which abort through the router directly) and fail them over.
        Without a failover config there is no retry policy to apply,
        so losing the row silently is forbidden: raise instead."""
        got = False
        for rep in list(self.replicas):
            if not rep.session.aborted:
                continue
            aborted, rep.session.aborted = rep.session.aborted, []
            for req, out in aborted:
                got = True
                if self.failover is None:
                    raise RuntimeError(
                        f"{rep.name}: row {req.rid!r} aborted by a "
                        "decode fault but the router has no failover "
                        "config — pass failover=FailoverConfig() (or "
                        "a fault plan) so aborted work can be "
                        "re-placed instead of lost")
                if rep.monitor is not None:
                    # backend-raised DecodeError (no scheduled fault
                    # behind it): just as incident-worthy as a
                    # planned one
                    rep.monitor.event(
                        "decode_error", t,
                        severity=FAULT_SEVERITY["decode_error"],
                        close_t=t, rids=[req.rid],
                        evidence={"salvaged_tokens": len(out),
                                  "backend_raised": True})
                self._schedule_retry(req, out, t,
                                     reason="decode_error")
        return got

    def _probe(self, t: float):
        """One health-probe pass: live sessions answer (stalled ones
        included — slow is not dead), crashed ones stay silent; any
        replica silent past the heartbeat timeout is declared dead and
        failed over. Runs at every timeline step plus the standing
        probe ticks, so detection latency is bounded by
        ``timeout + interval`` even in an arrival gap."""
        cfg = self.failover
        for rep in list(self.replicas):
            if not rep.session.crashed:
                rep.last_seen = max(rep.last_seen, t)
            elif t - rep.last_seen >= cfg.heartbeat_timeout - 1e-9:
                self._declare_dead(rep, t)

    def _declare_dead(self, rep: _Replica, t: float):
        """Failover: the dead replica leaves the cluster NOW. Its
        queued-but-never-admitted backlog and its crash-salvaged
        in-flight rows are re-placed on survivors (with backoff and a
        retry budget); every moved request carries its metrics record
        and trace root with it, so the cluster counts it exactly once.
        The corpse's result banks only pre-crash completions, and its
        purged pool must census to zero resident pages at removal."""
        cfg = self.failover
        sess = rep.session
        silence = t - rep.last_seen
        missed = max(1, int(silence / cfg.heartbeat_interval))
        self._ctr_failovers.inc()
        queued = sess.pull_unadmitted(outcome="failover")
        salvage = sess.crash_salvage
        self.events_log.append({
            "t": round(t, 6), "event": "dead", "replica": rep.name,
            "silent_for": round(silence, 6),
            "missed_heartbeats": missed,
            "requeued": [r.rid for r in queued],
            "in_flight_lost": [r.rid for r, _ in salvage]})
        if self._tracer is not None:
            self._tracer.instant("dead", t=t, track="cluster",
                                 replica=rep.name,
                                 missed_heartbeats=missed,
                                 requeued=len(queued),
                                 in_flight_lost=len(salvage))
        if rep.monitor is not None:
            # the detector's conclusion: silence exceeded the timeout,
            # work is moving — pages; the crash incident it resolves
            # closes with resolution "failover"
            rep.monitor.event(
                "failover", t, severity=FAULT_SEVERITY["failover"],
                close_t=t,
                evidence={"silent_for": round(silence, 6),
                          "missed_heartbeats": missed,
                          "requeued": len(queued),
                          "in_flight_lost": len(salvage)},
                rids=[r.rid for r, _ in salvage])
            rep.monitor.close_kind("crash", t, resolution="failover")
        self._bank_removal(rep, t, crashed=True,
                           pool_epoch=sess.book.epoch)
        # queued work first (it never ran — plain re-place), then the
        # in-flight rows in admit order with their salvage
        for r in queued:
            self._schedule_retry(r, [], t, reason="failover_queued")
        for r, out in salvage:
            self._schedule_retry(r, out, t, reason="failover_inflight")

    def _place_or_fail(self, r: Request, t: float) -> bool:
        """Placement with the footprint guard for every re-placement
        path (drain requeues and failover retries): with the failover
        machinery active, candidates are filtered to replicas whose
        engine admits the request, and a request NO admitting replica
        can fit is recorded FAILED — accounted exactly once — instead
        of crashing the replay inside ``submit``'s validation. Without
        a failover config this is exactly ``_place`` (the plain drain
        path, byte-identical)."""
        if self.failover is None:
            self._place(r, requeue=True)
            return True
        if not self._retry_fits(len(r.prompt), r.max_new_tokens):
            self.failed[r.rid] = (
                "no admitting replica can fit the request (none "
                "left, or its footprint exceeds every survivor's "
                "max_len)")
            self._ctr_retry("unplaceable")
            self.events_log.append({"t": round(t, 6),
                                    "event": "retry_unplaceable",
                                    "rid": r.rid})
            if self._tracer is not None:
                self._tracer.instant("retry_exhausted", t=t,
                                     track="cluster", rid=r.rid,
                                     reason="unplaceable")
            if self._mon_cluster is not None:
                self._mon_cluster.event(
                    "retry_exhausted", t,
                    severity=FAULT_SEVERITY["retry_exhausted"],
                    close_t=t, rids=[r.rid],
                    evidence={"reason": "unplaceable"})
            return False
        self._place(r, requeue=True,
                    only=lambda rep: self._rep_fits(
                        rep, len(r.prompt), r.max_new_tokens))
        return True

    # --- elastic autoscaling (the detect -> act loop) ----------------------
    def _close_hours(self, name: str, t: float):
        h = self._hours.get(name)
        if h is not None and h["left"] is None:
            h["left"] = round(t, 6)
            h["hours"] = round(max(0.0, h["left"] - h["joined"]), 6)

    def _standby_name(self, base: str) -> str:
        """The generation-suffix allocator: a standby base name that
        already served (and retired) this run rejoins as ``base#2``,
        ``base#3``, ... — the recycled replica gets a fresh
        ServeResult slot, so the exactly-once census (which is keyed
        by REQUEST, not replica) conserves and no retired history is
        overwritten. Direct (event-scheduled) joins of a retired name
        still refuse — only the autoscaler recycles."""
        if self._find(base) is None and base not in self.results:
            return base
        g = 2
        while self._find(f"{base}#{g}") is not None \
                or f"{base}#{g}" in self.results:
            g += 1
        return f"{base}#{g}"

    def _autoscale_on_incident(self, inc):
        """The autoscaler's incident subscription (rides the same
        ``on_incident`` list as any other subscriber): scale-worthy
        incidents arm the next tick's join; page-severity incidents
        flip QoS degradation tiers in EVERY live scheduler the moment
        they open — before any shed the overload would otherwise
        force — via the scheduler's ``note_incident`` seam."""
        if self._autoscaler.note_incident(inc) != "degrade":
            return
        n = 0
        for rep in self.replicas:
            sch = rep.session.sched
            if sch is not None and hasattr(sch, "note_incident"):
                sch.note_incident(inc)
                n += 1
        if n:
            self._autoscaler.log_degrade(inc)
            self.events_log.append({"t": round(inc.t_open, 6),
                                    "event": "autoscale",
                                    "action": "degrade",
                                    "incident": inc.id,
                                    "schedulers": n})
            if self._tracer is not None:
                self._tracer.instant("autoscale", t=inc.t_open,
                                     track="cluster", action="degrade",
                                     incident=inc.id)

    def _autoscale_tick(self, t: float):
        """One control-plane evaluation on the shared timeline: the
        autoscaler decides (cooldowns/hysteresis inside), the router
        executes — joins spawn through the standard ``_join`` path,
        drains through ``_drain`` (requeue + retirement semantics
        unchanged), role flips retag the replica and its session (the
        per-turn export sink and the placement policy both read the
        CURRENT role, so in-flight work finishes under the old stage
        and new work enters under the new one)."""
        # cluster-wide cumulative sheds (live sessions + banked
        # results): the loss signal that carries an armed scale-up
        # episode past its single triggering incident
        sheds = sum(len(rep.session.shed_log) for rep in self.replicas) \
            + sum(len(res.shed) for res in self.results.values())
        acts = self._autoscaler.decide(t, self.replicas,
                                       self._standby_name,
                                       sheds_total=sheds)
        for act in acts:
            kind = act["action"]
            self.events_log.append(
                {"t": round(t, 6), "event": "autoscale",
                 **{k: v for k, v in act.items() if k != "t"}})
            if self._tracer is not None:
                self._tracer.instant(
                    "autoscale", t=t, track="cluster", action=kind,
                    replica=act.get("replica"),
                    reason=act.get("reason"))
            if kind == "join":
                self._join(act["replica"], t)
            elif kind == "drain":
                self._drain(act["replica"], t)
            elif kind == "role":
                rep = self._rep(act["replica"])
                rep.role = act["to"]
                rep.session.role = act["to"]
                self._roles[act["replica"]] = act["to"]
                if self._tracer is not None:
                    self._tracer.instant("role", t=t, track="cluster",
                                         replica=rep.name,
                                         role=act["to"])
            # "drain_noop_crashed" and "degrade" execute nothing here:
            # the noop IS the action (logged loudly, the failover owns
            # the removal), and degrades actuate at incident-open time

    @staticmethod
    def _ctr_retry(reason: str):
        obs_metrics.REGISTRY.counter(
            "cluster_retries_total",
            "request re-placements after failures",
            reason=reason).inc()

    def _schedule_retry(self, r: Request, salvage: List[int],
                        t: float, reason: str):
        led = self.ledger[r.rid]
        led["retries"] += 1
        attempt = led["retries"]
        cfg = self.failover
        if attempt > cfg.retry_budget:
            self.failed[r.rid] = (f"retry budget exhausted "
                                  f"({cfg.retry_budget}) after "
                                  f"{reason}")
            self._ctr_retry("exhausted")
            self.events_log.append({
                "t": round(t, 6), "event": "retry_exhausted",
                "rid": r.rid, "attempts": attempt - 1})
            if self._tracer is not None:
                self._tracer.instant("retry_exhausted", t=t,
                                     track="cluster", rid=r.rid)
            if self._mon_cluster is not None:
                self._mon_cluster.event(
                    "retry_exhausted", t,
                    severity=FAULT_SEVERITY["retry_exhausted"],
                    close_t=t, rids=[r.rid],
                    evidence={"attempts": attempt - 1,
                              "after": reason})
            return
        self._ctr_retry(reason)
        delay = cfg.backoff(attempt)
        if self._tracer is not None:
            self._tracer.instant("retry", t=t, track="cluster",
                                 rid=r.rid, attempt=attempt,
                                 reason=reason, backoff=round(delay, 6),
                                 salvaged=len(salvage))
        # the resumed request is BUILT at pop time, not here: the
        # backoff window may see membership change (a joiner with a
        # smaller max_len, another crash), and the salvage trim must
        # size against the replicas that can actually receive it
        self._push(t + delay, 5, ("retry", r, salvage))

    def _resume_request(self, r: Request, salvage: List[int]):
        """Resume-from-prefix: the retried request re-enters with its
        already-emitted tokens appended to the prompt, so the survivor
        re-prefills (cheaply, where the prefix cache holds the shared
        prompt) instead of re-decoding, and the completed stream —
        salvage + what the retry emits — is token-identical to an
        uninterrupted run (prefill and decode agree on greedy
        argmax/hash; the sim backend is built resume-consistent for
        exactly this). Budgets shrink by what was already delivered:
        ``max_new_tokens`` and any ``cancel_after`` both count TOTAL
        stream tokens. Salvage is trimmed (newest tokens re-decoded
        instead) only if appending it would overflow every fitting
        survivor's max_len footprint. Returns ``(resumed_request,
        kept_salvage)`` — the caller banks ``kept_salvage`` into
        ``self._salvage`` ONLY after placement succeeds, so a request
        that ends up unplaceable never reports as resumed."""
        if not salvage:
            return r, []
        keep = len(salvage)
        while keep > 0:
            budget = r.max_new_tokens - keep
            if budget >= 1 and self._retry_fits(
                    len(r.prompt) + keep, budget):
                break
            keep -= 1
        if keep <= 0:
            return r, []
        kept = list(salvage[:keep])
        cancel = r.cancel_after
        if cancel is not None:
            cancel = max(1, cancel - keep)
        return dataclasses.replace(
            r, prompt=tuple(r.prompt) + tuple(kept),
            max_new_tokens=r.max_new_tokens - keep,
            cancel_after=cancel), kept

    @staticmethod
    def _rep_fits(rep: _Replica, prompt_len: int, budget: int) -> bool:
        # the engine's own footprint rule — _validate applies exactly
        # this arithmetic at submit
        e = rep.session.eng
        return e._footprint_len(prompt_len, budget) <= e.max_len

    def _retry_fits(self, prompt_len: int, budget: int) -> bool:
        """True when SOME admitting replica's engine footprint admits
        a resumed request of this size (pad-to-chunk + budget + decode
        chunk <= max_len) — retry placement is filtered to the fitting
        survivors, so one small joiner in a heterogeneous cluster must
        not doom a request a capable replica could serve. With NO
        admitting replica left (the last survivor drained inside the
        backoff window), or every survivor too small, nothing fits:
        the caller records the request FAILED instead of crashing the
        replay in _place."""
        return any(self._rep_fits(rep, prompt_len, budget)
                   for rep in self.replicas if rep.admitting)

    # --- the replay -------------------------------------------------------
    def run(self, trace: List[Request], events=()) -> ClusterResult:
        if self._ran:
            raise RuntimeError("a ClusterRouter runs once — build a "
                               "fresh router per replay")
        self._ran = True
        self._expect_churn = any(r.cancel_after is not None
                                 for r in trace)
        spec = self._trace_spec
        if spec is not None and spec is not False:
            if isinstance(spec, obs_trace.Tracer):
                self._tracer = spec
                self._tracer.clear()
            else:
                self._tracer = obs_trace.Tracer()
        if self.flight is not None and self._tracer is not None:
            # the flight recorder rides the tracer's mirror sink: the
            # most recent spans stay in its bounded ring for bundles
            self.flight.attach(self._tracer)
        for ev in events:
            t, op, name = ev
            if op not in ("drain", "join"):
                raise ValueError(f"lifecycle event {op!r}: use 'drain' "
                                 "or 'join'")
            self._push(float(t), 0 if op == "join" else 1, (op, name))
        t_last = 0.0
        for r in sorted(trace, key=lambda r: (r.arrival, r.rid)):
            self._push(r.arrival, 2, r)
            t_last = max(t_last, r.arrival)
        if self._faults is not None:
            for fev in self._faults:
                self._push(fev.t, 3, fev)
                t_last = max(t_last, fev.t)
            # standing health-probe ticks bound detection latency even
            # across arrival gaps; they run past the last scheduled
            # event far enough for the slowest detection + backoff
            cfg = self.failover
            horizon = t_last + cfg.heartbeat_timeout \
                + 2 * cfg.heartbeat_interval \
                + cfg.backoff(cfg.retry_budget)
            k = 1
            while k * cfg.heartbeat_interval <= horizon:
                self._push(k * cfg.heartbeat_interval, 4, ("hb",))
                k += 1
        if self._autoscaler is not None:
            # standing control-plane ticks: decisions evaluate at a
            # fixed cadence on the shared timeline (priority AFTER
            # arrivals/faults/probes at the same instant, so a tick
            # reads the state those events left), which is what makes
            # the action log byte-deterministic across replays. Ticks
            # are scheduled statically up to the last arrival/fault;
            # past it the loop below CHAINS further ticks while any
            # live replica still owes work, so a spike at the end of
            # the span keeps the control plane awake through its
            # backlog drain (late joins answered, recovered capacity
            # drained) without charging replica-hours for ticks over
            # a fully idle fleet
            iv = self._autoscaler.cfg.interval
            k = 1
            while k * iv <= t_last:
                self._push(k * iv, 6, ("as",))
                k += 1

        prev_tr = obs_trace.active()
        if self._tracer is not None:
            obs_trace.activate(self._tracer)
        try:
            for i in range(self.n_replicas):
                self._add_replica(f"r{i}", 0.0)
            has_roles = any(v != "both" for v in self._roles.values())
            t = 0.0
            while self._heap:
                t, _, _, item = heapq.heappop(self._heap)
                for rep in list(self.replicas):
                    rep.session.advance_until(t)
                    if not rep.admitting:
                        self._maybe_retire(rep)
                if self._slo_rules is not None:
                    # liveness feed, BEFORE any rule evaluation at t:
                    # a live session (stalled included — slow is not
                    # dead) answers the probe, so its monitor's
                    # silence reads zero across arrival gaps; a
                    # crashed session stays silent and only its clock
                    # advances — exactly what a heartbeat-silence
                    # rule is allowed to see
                    for rep in list(self.replicas):
                        if rep.monitor is None:
                            continue
                        if not rep.session.crashed:
                            rep.monitor.heartbeat(t)
                        else:
                            rep.monitor.advance(t)
                if has_roles:
                    # exports that completed during this advance move
                    # to decode workers before anything else acts on
                    # the new time
                    self._collect_handoffs()
                if self._faults is not None:
                    self._probe(t)
                if isinstance(item, FaultEvent):
                    self._fault(item, t)
                elif isinstance(item, Request):
                    self._place(item)
                elif item[0] == "retry":
                    r2, kept = self._resume_request(item[1], item[2])
                    if self._place_or_fail(r2, t) and kept:
                        self._salvage.setdefault(
                            r2.rid, []).extend(kept)
                elif item[0] == "as":
                    self._autoscale_tick(t)
                    iv = self._autoscaler.cfg.interval
                    if t + iv > t_last and any(
                            not rep.session.crashed
                            and rep.session.load() > 0
                            for rep in self.replicas):
                        # the tail extension: arrivals/faults are
                        # exhausted but some live replica still owes
                        # work, so the control plane stays awake one
                        # more tick (deterministic — chained off the
                        # same virtual state every replay sees).
                        # Crashed corpses are excluded: their frozen
                        # load never drains, and the heap must empty
                        # for the end-of-run failover rescue to fire.
                        self._push(t + iv, 6, ("as",))
                elif item[0] not in ("hb", "ht"):
                    op, name = item
                    if op == "drain" and self._faults is not None \
                            and self._find(name) is None:
                        # the drain's target was already removed by
                        # crash failover — a scheduled lifecycle event
                        # colliding with the fault plan noops loudly
                        # (same policy as _fault on a gone replica)
                        # instead of killing the replay
                        self.events_log.append(
                            {"t": round(t, 6), "event": "drain_noop",
                             "replica": name})
                    else:
                        (self._join if op == "join" else self._drain)(
                            name, t)
                self._collect_aborted(t)
                if not self._heap and self._faults is not None:
                    # a crash whose detection window outran the probe
                    # horizon (or whose failover pushed retries) must
                    # still be failed over before the run closes
                    for rep in list(self.replicas):
                        if rep.session.crashed:
                            self._declare_dead(
                                rep, max(t, rep.last_seen
                                         + self.failover
                                         .heartbeat_timeout))
            for rep in list(self.replicas):
                rep.session.more_expected = False
            if has_roles:
                # the disaggregation pipeline drains in stage order:
                # prefill-role lanes run dry first, their exports land
                # on decode workers, THEN everyone else finishes (a
                # decode worker finishing before its last handoffs
                # were submitted would bank an incomplete stream set)
                for rep in list(self.replicas):
                    if rep.session.role == "prefill":
                        rep.session.finish()
                self._collect_handoffs()
            for rep in list(self.replicas):
                self.results[rep.name] = rep.session.finish()
                self._fold_handoff_stats(rep.session)
                if rep.session.aborted:
                    # a decode fault fired inside the final backlog
                    # drain, after the last survivor-placement window
                    # closed — refusing loudly beats losing the row
                    raise RuntimeError(
                        f"{rep.name}: {len(rep.session.aborted)} "
                        "row(s) aborted after the replay closed — "
                        "nothing left to fail over to")
                if not rep.admitting:
                    # retire bookkeeping for replicas that were still
                    # streaming when the trace ran out
                    cs = self.results[rep.name].cache_stats
                    self.events_log.append({
                        "t": round(rep.session.clock.now(), 6),
                        "event": "remove", "replica": rep.name,
                        "census_ok": bool(
                            cs.get("invariant_ok")
                            and cs.get("resident_pages") == 0),
                        "resident_pages": cs.get("resident_pages")})
                self._close_hours(rep.name, rep.session.clock.now())
                self.replicas.remove(rep)
        finally:
            if self._tracer is not None:
                if prev_tr is not None:
                    obs_trace.activate(prev_tr)
                else:
                    obs_trace.deactivate()
        if self._tracer is not None and isinstance(spec, str):
            self._tracer.export(spec)
        ho = dict(self._handoff) if self._handoff["exported"] else {}
        if ho and self._resharded:
            # per-axis transform counts ride the handoff block only
            # when an import actually resharded — twin results carry
            # the same keys they always did
            ho["resharded"] = dict(self._resharded)
        return ClusterResult(placement=self.placement.name,
                             results=self.results, ledger=self.ledger,
                             events=self.events_log,
                             trace=self._tracer,
                             salvaged=self._salvage,
                             failed=self.failed,
                             faulted=(self._faults is not None
                                      or bool(self.failed)
                                      or any(led.get("retries")
                                             for led in
                                             self.ledger.values())),
                             handoffs=ho,
                             incidents=(list(self.slo_log.incidents)
                                        if self.slo_log is not None
                                        else None),
                             slo_log=self.slo_log,
                             flight=self.flight,
                             autoscale=(self._autoscaler.summary()
                                        if self._autoscaler is not None
                                        else None),
                             replica_hours=dict(self._hours),
                             cost_rollup=(
                                 self._cost_ledger.rollup()
                                 if self._cost_ledger is not None
                                 else None),
                             cost_ledger=self._cost_ledger)
