"""Serving metrics: per-request latency decomposition + stream rates.

The numbers a serving system is judged by, none of which a per-shape
microbench can produce:

- **TTFT** (time to first token): arrival -> first generated token.
  Queueing + admission + prefill; the interactive-feel metric.
- **TPOT** (time per output token): mean inter-token gap after the
  first token. The streaming-rate metric; stalls (e.g. a dense wave
  hogging the chip) show up here, not in TTFT.
- **p50/p95** over requests, not tokens — tail latency is what SLOs
  bind on.
- **SLO attainment**: fraction of completed requests whose TTFT/TPOT
  beat the target.

``MetricsCollector`` ingests engine events with the engine's (virtual)
clock timestamps and exports one PERF-style JSON record per run.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class _Req:
    __slots__ = ("arrival", "admit", "backend", "token_times", "n_tokens",
                 "finish", "evicted", "tenant", "priority", "deadline_ms",
                 "shed", "shed_reason", "budget0", "budget",
                 "finish_reason")

    def __init__(self, arrival: float, tenant=None, priority=0,
                 deadline_ms=None):
        self.arrival = arrival
        self.admit: Optional[float] = None
        self.backend: Optional[str] = None
        self.token_times: List[float] = []  # one stamp per token
        self.n_tokens = 0
        self.finish: Optional[float] = None
        self.evicted = False
        self.tenant: Optional[str] = tenant
        self.priority = priority
        self.deadline_ms: Optional[float] = deadline_ms
        self.shed = False
        self.shed_reason: Optional[str] = None
        self.budget0: Optional[int] = None  # pre-degradation budget
        self.budget: Optional[int] = None   # admitted (clamped) budget
        self.finish_reason: Optional[str] = None


def percentile(xs, q) -> Optional[float]:
    """THE percentile used by every serving report path (request
    latencies in ``MetricsCollector.report``, the cluster rollup, the
    bench rows) — one implementation so two reports can never disagree
    on the arithmetic. Linear interpolation between closest ranks
    (numpy's default), rounded to 6 places. Small-n semantics are
    DEFINED, not accidental:

    - ``n == 0``: ``None`` (a percentile of nothing is not 0.0);
    - ``n == 1``: the value itself, for every ``q``;
    - ``n == 2``: linear interpolation — ``q=50`` is the midpoint,
      ``q=95`` sits 90% of the way to the larger value.
    """
    if xs is None or len(xs) == 0:
        return None
    return round(float(np.percentile(np.asarray(xs), q)), 6)


# internal alias predating the public name; kept so call sites read
# compactly in report-building code
_pct = percentile


def jain_fairness(xs) -> Optional[float]:
    """Jain's fairness index over per-tenant allocations (typically
    weight-normalized goodput): ``(sum x)^2 / (n * sum x^2)``. 1.0 is
    perfectly fair, ``1/n`` is one tenant taking everything. Returns
    None when every allocation is zero (the index is undefined, not
    unfair). ONE implementation shared by the per-run QoS block and the
    cluster rollup — the two can never disagree on the arithmetic."""
    xs = [float(x) for x in xs]
    sq = sum(x * x for x in xs)
    if sq <= 0 or not xs:
        return None
    return round((sum(xs) ** 2) / (len(xs) * sq), 4)


def goodput_tokens(views) -> int:
    """Goodput over request views (``MetricsCollector.request`` dicts):
    tokens from SLO-met requests ONLY — a shed, late, or evicted
    request contributes nothing. Shared by the per-run QoS block and
    the cluster rollup."""
    return sum(int(v["n_tokens"]) for v in views if v["deadline_met"])


class MetricsCollector:
    """Event sink for one engine run; all timestamps come from the
    engine clock (wall-measured or fixed-cost — the collector does not
    care which)."""

    def __init__(self, monitor=None):
        self._req: Dict[str, _Req] = {}
        self._queue: List[tuple] = []  # (t, depth)
        # prefix-cache totals over paged admits (engine-fed); the
        # report grows its prefix block only when a hit happened, so
        # plain no-hit traces stay byte-identical
        self._prefix = {"cached": 0, "saved": 0, "prompt": 0}
        # per-device pool bytes (tensor-parallel runs only): kept so
        # publish() can export the sharded-only gauge; None = never
        # sharded, nothing exported (the clean-registry convention)
        self._pool_dev_bytes: Optional[int] = None
        # adapter-cache totals over multi-model admits (engine-fed);
        # the report grows its adapter block ONLY when an adapter
        # request was actually served, so single-model traces stay
        # byte-identical (the hits>0 convention)
        self._adapter = {"requests": 0, "hits": 0, "uploads": 0}
        self._adapter_names: set = set()
        self._adapter_resident: Optional[int] = None
        # speculative-route totals (engine-fed per spec turn); the
        # report grows its spec block ONLY when a spec round actually
        # ran, so plain traces — and spec=None replays — keep their
        # records byte-identical (the presence convention)
        self._spec = {"rounds": 0, "proposed": 0, "accepted": 0}
        # per-tenant cost-ledger snapshot (engine-fed at run end via
        # ``note_costs`` ONLY when a ledger is armed); the per-tenant
        # report block grows its cost columns only then, so ledger-off
        # reports stay byte-identical (the presence convention)
        self._tenant_costs: Optional[Dict[str, dict]] = None
        # quantized-page-tier totals (engine-fed); the report grows
        # its kv_quant block ONLY when a quantized mode is armed, so
        # kv_quant=None runs keep their records byte-identical (the
        # presence convention)
        self._kv_quant = {"mode": None, "flips": 0, "compactions": 0,
                          "pages": 0}
        # host-arena tier totals (engine-fed); the report grows its
        # hostmem block ONLY when a page actually crossed the tier
        # boundary or a preemption fired, so hostmem=None runs keep
        # their records byte-identical (the presence convention)
        self._hostmem = {"pageouts": 0, "pageins": 0,
                         "preempts": 0, "restores": 0}
        # constrained-decoding totals (engine-fed); the report grows
        # its grammar block ONLY when a constrained row actually ran,
        # so grammar=None runs keep their records byte-identical (the
        # presence convention)
        self._grammar = {"streams": 0, "hits": 0, "compiles": 0,
                        "tokens": 0, "masked_sum": 0.0, "accepts": 0}
        self._grammar_names: set = set()
        # ``monitor`` (obs.slo.SLOMonitor, optional) receives each
        # request's FINAL record at finish/shed plus queue/lane depth
        # samples — the one seam through which the streaming SLO layer
        # sees everything the collector sees. It only READS: with a
        # monitor attached or not, every record/report/output byte is
        # identical (the obs_slo gate measures exactly this).
        self._mon = monitor

    # --- events ----------------------------------------------------------
    def on_arrival(self, rid: str, t: float, tenant: Optional[str] = None,
                   priority: int = 0,
                   deadline_ms: Optional[float] = None):
        self._req[rid] = _Req(t, tenant=tenant, priority=priority,
                              deadline_ms=deadline_ms)

    def on_admit(self, rid: str, t: float, backend: str):
        r = self._req[rid]
        r.admit = t
        r.backend = backend

    def on_shed(self, rid: str, t: float, reason: str):
        """The scheduler rejected ``rid`` (queue bound or deadline
        infeasibility) — it never runs, never finishes, and can never
        count as an SLO hit."""
        r = self._req[rid]
        r.shed = True
        r.shed_reason = reason
        r.finish_reason = "shed"
        if self._mon is not None:
            self._mon.observe_request(dict(self.request(rid), rid=rid),
                                      t)

    def on_degrade(self, rid: str, budget: int, orig_budget: int):
        """Graceful-degradation tier fired: ``rid`` was admitted with
        ``max_new_tokens`` clamped from ``orig_budget`` to ``budget``."""
        r = self._req[rid]
        r.budget = budget
        r.budget0 = orig_budget

    def on_prefix(self, rid: str, cached: int, saved: int, prompt: int):
        """``rid`` admitted to the paged backend with ``cached`` of its
        ``prompt`` tokens found in the prefix cache, of which ``saved``
        (chunk-aligned) actually skipped prefill compute."""
        self._prefix["cached"] += cached
        self._prefix["saved"] += saved
        self._prefix["prompt"] += prompt

    def on_tokens(self, rid: str, t: float, n: int):
        """``n`` tokens materialized at time ``t`` (a decode chunk's
        tokens share one stamp — TPOT is chunk-granular by design)."""
        r = self._req[rid]
        r.token_times.extend([t] * n)
        r.n_tokens += n

    def on_finish(self, rid: str, t: float, evicted: bool = False,
                  reason: Optional[str] = None):
        r = self._req[rid]
        r.finish = t
        r.evicted = evicted
        if reason is not None:
            r.finish_reason = reason
        if self._mon is not None:
            self._mon.observe_request(dict(self.request(rid), rid=rid),
                                      t)

    def on_queue_depth(self, t: float, depth: int):
        self._queue.append((t, depth))
        if self._mon is not None:
            self._mon.observe_value("queue_depth", depth, t)

    def on_lane_depth(self, t: float, depth: int):
        """Async-prefill-lane depth sample. Stored nowhere (the lane
        gauge already exports it live); exists purely to stream the
        signal to an attached SLO monitor — a no-op without one, so
        pre-SLO replays are untouched."""
        if self._mon is not None:
            self._mon.observe_value("prefill_lane_depth", depth, t)

    def on_busy_frac(self, t: float, frac: float):
        """Decode-slot utilization sample (busy slots / capacity,
        engine-fed once per turn). Stored nowhere (the
        ``serving_replica_busy_frac`` gauge exports it live); exists
        to stream the signal to an attached SLO monitor — the drain-
        decision input, watchable via ``ThresholdRule(signal=
        "replica_busy_frac", op="<=", ...)`` like any gauge sample.
        A no-op without a monitor, so pre-SLO replays are
        untouched."""
        if self._mon is not None:
            self._mon.observe_value("replica_busy_frac", frac, t)

    def on_adapter(self, rid: str, adapter: str, hit: bool):
        """``rid`` admitted decoding with LoRA ``adapter``; ``hit``
        means the delta set was already resident in the device bank
        (a miss paid one paced host->device upload)."""
        self._adapter["requests"] += 1
        self._adapter["hits" if hit else "uploads"] += 1
        self._adapter_names.add(adapter)

    def on_adapter_resident(self, t: float, count: int):
        """Resident-adapter census sample (pinned + retained slots,
        engine-fed on every acquire/release). Kept for publish()'s
        gauge and streamed to an attached SLO monitor so a
        ``ThresholdRule(signal="adapter_resident")`` can watch bank
        pressure; a no-op single-model."""
        self._adapter_resident = int(count)
        if self._mon is not None:
            self._mon.observe_value("adapter_resident", count, t)

    def on_spec(self, rows: int, proposed: int, accepted: int):
        """One speculative decode turn: ``rows`` rows each ran one
        draft/verify round, ``proposed`` draft tokens went to target
        verification, ``accepted`` survived it. Wasted draft compute
        is the difference — the number the adaptive fallback exists
        to bound."""
        self._spec["rounds"] += rows
        self._spec["proposed"] += proposed
        self._spec["accepted"] += accepted

    def note_costs(self, per_tenant: Dict[str, dict]):
        """Engine-fed at run end, ONLY when a cost ledger is armed:
        ``CostLedger.tenant_costs()`` — tenant -> {cost_units,
        page_turns}. The per-tenant report block grows its two cost
        columns only for tenants present here; un-armed runs never
        call this and their reports stay byte-identical."""
        self._tenant_costs = dict(per_tenant)

    def on_pool_bytes(self, t: float, per_device_bytes: int):
        """Per-device KV-pool residency sample (tensor-parallel
        engines only — unsharded runs never call this). Stored
        nowhere (the serving_pool_bytes_per_device gauge exports it
        live); exists to stream the signal to an attached SLO monitor
        so a ``ThresholdRule(signal="pool_bytes_per_device", ...)``
        can watch per-device HBM pressure."""
        self._pool_dev_bytes = int(per_device_bytes)
        if self._mon is not None:
            self._mon.observe_value("pool_bytes_per_device",
                                    per_device_bytes, t)

    def on_kv_quant(self, mode: str):
        """A quantized page tier is armed for this run (``"int8"`` or
        ``"pressure"``): the report grows its kv_quant block. Called
        once by the engine at run setup."""
        self._kv_quant["mode"] = mode

    def on_kv_quant_flip(self, enabled: bool):
        """The pressure tier flipped (on or off) — one deterministic
        actuation of the pool-byte incident."""
        self._kv_quant["flips"] += 1

    def on_compaction(self, t: float, pages: int):
        """One compaction batch: ``pages`` parked pages quantized to
        int8 (their prefix keys intact — nothing was forgotten)."""
        self._kv_quant["compactions"] += 1
        self._kv_quant["pages"] += int(pages)

    def on_pageout(self, t: float, pages: int):
        """``pages`` device pages spilled to the host arena (eviction
        spill or a preemption swap-out) — each paid one priced
        ``kv_pageout`` transfer on the engine clock."""
        self._hostmem["pageouts"] += int(pages)

    def on_pagein(self, t: float, pages: int):
        """``pages`` arena pages restored into the device pool at
        admission (a prefix hit on a spilled chain, or a preempted
        request swapping back in) — each paid one priced
        ``kv_pagein`` transfer."""
        self._hostmem["pageins"] += int(pages)

    def on_preempt(self, rid: str, t: float, emitted: int):
        """The QoS preempt rung fired: running row ``rid`` (with
        ``emitted`` tokens already streamed) swapped its chain out to
        the host arena and requeued — capacity surrendered to a
        higher class WITHOUT discarding the work."""
        self._hostmem["preempts"] += 1

    def on_restore(self, rid: str, t: float):
        """A preempted request re-admitted: its swapped chain paged
        back in (or re-prefilled where the arena had let go) and its
        stream resumes exactly where it stopped."""
        self._hostmem["restores"] += 1

    def on_grammar(self, rid: str, schema: str, hit: bool):
        """``rid`` admitted as a CONSTRAINED stream under ``schema``;
        ``hit`` means the compiled automaton was already resident in
        the device mask bank (a miss paid one priced
        ``grammar_compile`` on the engine clock)."""
        self._grammar["streams"] += 1
        self._grammar["hits" if hit else "compiles"] += 1
        self._grammar_names.add(schema)

    def on_grammar_tokens(self, n: int, masked_frac_sum: float):
        """``n`` constrained tokens emitted under grammar masks whose
        per-token forbidden-vocab fractions sum to
        ``masked_frac_sum`` — the report's ``tokens_masked_frac`` is
        the mean, how much of the vocabulary the automaton actually
        pruned per step."""
        self._grammar["tokens"] += int(n)
        self._grammar["masked_sum"] += float(masked_frac_sum)

    def on_grammar_accept(self, rid: str, t: float):
        """``rid``'s automaton reached an accepting state and the
        stream self-terminated — structurally complete output, before
        (or at) its token budget."""
        self._grammar["accepts"] += 1

    def forget(self, rid: str):
        """Erase every trace of ``rid`` from this collector — the
        cluster router's requeue/failover path: a request moving off a
        drained replica's queue, or off a CRASHED replica (queued or
        torn down mid-flight), is re-recorded in full wherever it
        finally runs, sheds, or exhausts its retry budget; keeping the
        arrival here would count the request twice in any cluster-wide
        rollup. This is one half of the exactly-once contract the
        cluster census gates (``completed + shed + failed ==
        arrived``)."""
        self._req.pop(rid, None)

    # --- views -----------------------------------------------------------
    def request_rows(self) -> List[dict]:
        """Every request's view (``request()`` dict plus its ``rid``),
        arrival-ordered — the public surface a cluster rollup
        aggregates across replicas."""
        return [dict(self.request(rid), rid=rid)
                for rid in sorted(self._req,
                                  key=lambda r: (self._req[r].arrival,
                                                 r))]

    def request(self, rid: str) -> dict:
        r = self._req[rid]
        ttft = (r.token_times[0] - r.arrival) if r.token_times else None
        tpot = None
        if len(r.token_times) > 1:
            tpot = ((r.token_times[-1] - r.token_times[0])
                    / (len(r.token_times) - 1))
        # the end-to-end decomposition disaggregation is judged on:
        # queue_wait (arrival -> admit), prefill_stall (admit -> first
        # token: the prefill itself plus any async-lane wait), and
        # decode_time (first token -> finish). decode_stall is the
        # worst inter-token gap IN EXCESS of the stream's own best
        # steady rate (worst positive gap minus best positive gap): an
        # uninterrupted stream scores 0.0, and what a co-scheduled
        # long prefill does to a live stream in an interleaved loop
        # shows up here as exactly the turns it stole
        queue_wait = (r.admit - r.arrival) if r.admit is not None \
            else None
        prefill_stall = (r.token_times[0] - r.admit) \
            if r.token_times and r.admit is not None else None
        decode_time = (r.finish - r.token_times[0]) \
            if r.finish is not None and r.token_times else None
        gaps = [b - a for a, b in zip(r.token_times, r.token_times[1:])
                if b - a > 1e-12]
        stall = (max(gaps) - min(gaps)) if gaps else \
            (0.0 if len(r.token_times) > 1 else None)
        d = {"arrival": r.arrival, "admit": r.admit,
             "backend": r.backend, "n_tokens": r.n_tokens,
             "finish": r.finish, "evicted": r.evicted,
             "ttft": ttft, "tpot": tpot,
             "e2e": (r.finish - r.arrival)
             if r.finish is not None else None,
             "queue_wait": queue_wait,
             "prefill_stall": prefill_stall,
             "decode_time": decode_time,
             "decode_stall": stall,
             "tenant": r.tenant, "priority": r.priority,
             "deadline_ms": r.deadline_ms, "shed": r.shed,
             "shed_reason": r.shed_reason,
             "finish_reason": r.finish_reason,
             "degraded_from": r.budget0}
        # SLO verdict: a shed request is NEVER met; without a deadline,
        # finishing UN-EVICTED counts as met (a canceled/timed-out
        # stream delivered partial work, not an SLO-met answer)
        if r.shed:
            d["deadline_met"] = False
        elif r.finish is None:
            d["deadline_met"] = None
        elif r.deadline_ms is None:
            d["deadline_met"] = not r.evicted
        else:
            d["deadline_met"] = bool(
                (r.finish - r.arrival) * 1000.0
                <= r.deadline_ms + 1e-6)
        return d

    def report(self, slo_ttft: Optional[float] = None,
               slo_tpot: Optional[float] = None,
               tenant_weights: Optional[Dict[str, float]] = None) -> dict:
        """Aggregate over FINISHED requests (evictions included: a
        canceled request still had a TTFT and a streaming rate while it
        lived). When the run carried QoS traffic (tenants, deadlines,
        or sheds), the record grows the QoS block — shed rate, deadline
        attainment, goodput (tokens from SLO-met requests ONLY; a shed
        or late request contributes nothing), per-tenant rows and the
        Jain fairness index over weight-normalized tenant goodput.
        Plain traces keep the record byte-for-byte."""
        done = [self.request(rid) for rid in self._req
                if self._req[rid].finish is not None]
        ttfts = [d["ttft"] for d in done if d["ttft"] is not None]
        tpots = [d["tpot"] for d in done if d["tpot"] is not None]
        e2es = [d["e2e"] for d in done]
        tokens = sum(d["n_tokens"] for d in done)
        arrivals = [r.arrival for r in self._req.values()]
        finishes = [r.finish for r in self._req.values()
                    if r.finish is not None]
        makespan = (max(finishes) - min(arrivals)) \
            if finishes and arrivals else 0.0
        depths = [d for _, d in self._queue]
        rec = {
            "completed": len(done),
            "evicted": sum(1 for d in done if d["evicted"]),
            "generated_tokens": tokens,
            "makespan": round(makespan, 6),
            "tokens_per_sec": round(tokens / makespan, 4)
            if makespan > 0 else None,
            "ttft_p50": _pct(ttfts, 50), "ttft_p95": _pct(ttfts, 95),
            "tpot_p50": _pct(tpots, 50), "tpot_p95": _pct(tpots, 95),
            "e2e_p50": _pct(e2es, 50), "e2e_p95": _pct(e2es, 95),
            "queue_depth_max": max(depths) if depths else 0,
            "queue_depth_mean": round(float(np.mean(depths)), 3)
            if depths else 0.0,
        }
        # per-request latency DECOMPOSED: where did the e2e go —
        # queueing (arrival->admit), prefill stall (admit->first
        # token, async-lane wait included) or decode (first
        # token->finish)? The disaggregation claims are judged on
        # exactly this split.
        for key, field in (("queue_wait", "queue_wait"),
                           ("prefill_stall", "prefill_stall"),
                           ("decode_time", "decode_time")):
            xs = [d[field] for d in done if d[field] is not None]
            rec[f"{key}_p50"] = _pct(xs, 50)
            rec[f"{key}_p95"] = _pct(xs, 95)
        if self._prefix["cached"] > 0:
            # the prefix block appears ONLY when the cache actually hit
            # — a plain no-hit trace keeps the record byte-for-byte
            rec["prefix_cache_hit_tokens"] = self._prefix["cached"]
            rec["prefix_cache_hit_rate"] = round(
                self._prefix["cached"] / max(1, self._prefix["prompt"]),
                4)
            rec["prefill_tokens_saved"] = self._prefix["saved"]
        if self._adapter["requests"] > 0:
            # the adapter block appears ONLY when the trace actually
            # carried adapters (the same convention): single-model
            # records stay byte-identical to the plain engine
            rec["adapter_requests"] = self._adapter["requests"]
            rec["adapters_served"] = len(self._adapter_names)
            rec["adapter_cache_hits"] = self._adapter["hits"]
            rec["adapter_uploads"] = self._adapter["uploads"]
            rec["adapter_cache_hit_rate"] = round(
                self._adapter["hits"] / self._adapter["requests"], 4)
            if self._adapter_resident is not None:
                rec["adapters_resident_end"] = self._adapter_resident
        if self._spec["rounds"] > 0:
            # the spec block appears ONLY when a spec route actually
            # ran (the same convention): plain records — and any
            # spec=None replay — stay byte-identical to the plain engine
            rec["spec_rounds"] = self._spec["rounds"]
            rec["spec_acceptance_rate"] = round(
                self._spec["accepted"] / max(1, self._spec["proposed"]),
                4)
            rec["draft_tokens_proposed"] = self._spec["proposed"]
            rec["draft_tokens_wasted"] = (self._spec["proposed"]
                                          - self._spec["accepted"])
        if self._kv_quant["mode"] is not None:
            # quantized-page-tier block, present only when a kv_quant
            # mode is armed (same convention): kv_quant=None replays
            # stay byte-identical to the plain engine
            rec["kv_quant"] = self._kv_quant["mode"]
            rec["kv_quant_flips"] = self._kv_quant["flips"]
            rec["kv_compactions"] = self._kv_quant["compactions"]
            rec["kv_pages_compacted"] = self._kv_quant["pages"]
            if self._pool_dev_bytes is not None:
                # the dynamic stored-bytes census the pressure rule
                # watches (actual stored: quantized pages priced at
                # int8+scale size)
                rec["pool_bytes_per_device"] = self._pool_dev_bytes
        if any(self._hostmem.values()):
            # host-arena tier block, present only when a page actually
            # crossed the tier boundary or a preemption fired (same
            # convention): hostmem=None replays stay byte-identical
            rec["kv_pageouts"] = self._hostmem["pageouts"]
            rec["kv_pageins"] = self._hostmem["pageins"]
            rec["preemptions"] = self._hostmem["preempts"]
            rec["preempt_restores"] = self._hostmem["restores"]
        if self._grammar["streams"] > 0:
            # constrained-decoding block, present only when a
            # constrained row actually ran (same convention):
            # grammar=None replays stay byte-identical
            rec["constrained_streams"] = self._grammar["streams"]
            rec["schemas_served"] = len(self._grammar_names)
            rec["grammar_cache_hits"] = self._grammar["hits"]
            rec["grammar_compiles"] = self._grammar["compiles"]
            rec["grammar_cache_hit_rate"] = round(
                self._grammar["hits"] / self._grammar["streams"], 4)
            rec["grammar_accepts"] = self._grammar["accepts"]
            if self._grammar["tokens"] > 0:
                rec["tokens_masked_frac"] = round(
                    self._grammar["masked_sum"]
                    / self._grammar["tokens"], 4)
        if slo_ttft is not None and ttfts:
            rec["slo_ttft"] = slo_ttft
            rec["slo_ttft_attained"] = round(
                sum(1 for x in ttfts if x <= slo_ttft) / len(ttfts), 4)
        if slo_tpot is not None and tpots:
            rec["slo_tpot"] = slo_tpot
            rec["slo_tpot_attained"] = round(
                sum(1 for x in tpots if x <= slo_tpot) / len(tpots), 4)
        qos_run = any(r.tenant is not None or r.deadline_ms is not None
                      or r.shed for r in self._req.values())
        if qos_run:
            rec.update(self._qos_block(done, makespan, tenant_weights))
        return rec

    def _qos_block(self, done: List[dict], makespan: float,
                   tenant_weights: Optional[Dict[str, float]]) -> dict:
        arrived = len(self._req)
        shed = sum(1 for r in self._req.values() if r.shed)
        qb: dict = {
            "arrived": arrived,
            "shed": shed,
            "shed_rate": round(shed / arrived, 4) if arrived else 0.0,
        }
        with_dl = [d for d in done if d["deadline_ms"] is not None]
        if with_dl:
            dl_hits = sum(1 for d in with_dl if d["deadline_met"])
            qb["deadline_requests"] = len(with_dl)
            qb["deadline_hits"] = dl_hits
            qb["slo_deadline_attained"] = round(
                dl_hits / len(with_dl), 4)
        good = goodput_tokens(done)
        qb["goodput_tokens"] = good
        qb["goodput_tokens_per_sec"] = round(good / makespan, 4) \
            if makespan > 0 else None
        qb["degraded"] = sum(1 for d in done
                             if d["degraded_from"] is not None)
        qb["timeout_evicted"] = sum(
            1 for d in done if d["finish_reason"] == "timeout")
        tenants = sorted({r.tenant for r in self._req.values()
                          if r.tenant is not None})
        if tenants:
            w = tenant_weights or {}
            per: dict = {}
            xs = []
            for t in tenants:
                rids = [rid for rid, r in self._req.items()
                        if r.tenant == t]
                views = [self.request(rid) for rid in rids]
                gtok = goodput_tokens(views)
                n_shed = sum(1 for v in views if v["shed"])
                n_dl = [v for v in views
                        if v["deadline_ms"] is not None
                        and v["finish"] is not None]
                per[t] = {
                    "arrived": len(views),
                    "shed": n_shed,
                    "completed": sum(1 for v in views
                                     if v["finish"] is not None),
                    "goodput_tokens": gtok,
                }
                if n_dl:
                    per[t]["slo_deadline_attained"] = round(
                        sum(1 for v in n_dl if v["deadline_met"])
                        / len(n_dl), 4)
                if self._tenant_costs is not None \
                        and t in self._tenant_costs:
                    c = self._tenant_costs[t]
                    per[t]["cost_units"] = c.get("cost_units", 0.0)
                    per[t]["page_turns"] = c.get("page_turns", 0.0)
                xs.append(gtok / float(w.get(t, 1.0)))
            qb["tenants"] = per
            # Jain index over weight-normalized per-tenant goodput:
            # 1.0 = perfectly weighted-fair, 1/n = one tenant took all
            qb["fairness_jain"] = jain_fairness(xs)
        return qb

    def publish(self, registry=None, prefix: str = "serving_run",
                **slo) -> dict:
        """Derived view into the obs metrics registry: the aggregate
        ``report()`` (which itself stays byte-identical to plain runs' —
        the registry is fed FROM it, never the other way) lands as
        ``<prefix>_*`` gauges, one per scalar field, so a Prometheus
        scrape or JSONL snapshot sees the last run's TTFT/TPOT/goodput
        next to the engine's live counters. Returns the record it
        published."""
        from ..obs import metrics as _obs
        reg = registry if registry is not None else _obs.REGISTRY
        rec = self.report(**slo)
        for k, v in rec.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue  # nested tenant dicts / None stay trace-only
            reg.gauge(f"{prefix}_{k}").set(float(v))
        # decode-stall histogram (milliseconds, 1 clock unit = 1000
        # ms — the Request.deadline_ms convention): one observation
        # per finished request whose stream actually stalled. Created
        # ONLY when a nonzero stall exists, so a run whose streams
        # never hiccuped (and every pre-disagg replay of one) leaves
        # the registry byte-identical (the clean-registry convention).
        stalls = [v * 1000.0 for v in
                  (self.request(rid)["decode_stall"]
                   for rid in self._req
                   if self._req[rid].finish is not None)
                  if v is not None and v > 0]
        if stalls:
            h = reg.histogram(
                f"{prefix}_decode_stall_ms",
                "worst per-request inter-token gap beyond the "
                "stream's own steady rate",
                buckets=(10.0, 50.0, 100.0, 500.0, 1000.0, 2500.0,
                         5000.0, 10000.0, 25000.0, 100000.0))
            for s in stalls:
                h.observe(s)
        # resident-adapter gauge: ONLY when the run served adapters
        # (the engine streamed the census through on_adapter_resident)
        # — single-model replays leave the registry byte-identical
        if self._adapter_resident is not None:
            reg.gauge("serving_adapter_resident",
                      "LoRA adapters resident in the device bank "
                      "(pinned + retained)").set(
                float(self._adapter_resident))
        # constrained-decoding gauges: ONLY when a constrained row
        # actually ran — grammar=None replays leave the registry
        # byte-identical (the clean-registry convention)
        if self._grammar["streams"] > 0:
            reg.gauge("serving_constrained_streams",
                      "requests decoded under a grammar mask").set(
                float(self._grammar["streams"]))
            reg.gauge("serving_grammar_cache_hit_rate",
                      "fraction of constrained admissions whose "
                      "automaton was already resident").set(
                round(self._grammar["hits"]
                      / self._grammar["streams"], 4))
            if self._grammar["tokens"] > 0:
                reg.gauge("serving_tokens_masked_frac",
                          "mean fraction of the vocabulary the "
                          "grammar mask forbade per constrained "
                          "token").set(
                    round(self._grammar["masked_sum"]
                          / self._grammar["tokens"], 4))
        # per-device KV-pool residency: ONLY when the run was sharded
        # (the engine streamed it through on_pool_bytes) — unsharded
        # replays leave the registry byte-identical (the clean-registry
        # convention)
        if self._pool_dev_bytes is not None:
            reg.gauge("serving_pool_bytes_per_device",
                      "KV pool bytes resident on one device of the "
                      "TP mesh").set(float(self._pool_dev_bytes))
        return rec

    def to_record(self, policy: str, **extra) -> dict:
        """The canonical ``serving_workload`` row
        (tools/serving_workload_bench.py emits one per policy;
        tools/bench_gate.py serving mode gates routed vs best fixed)."""
        rec = {"bench": "serving_workload", "policy": policy}
        rec.update(self.report(**{k: extra.pop(k) for k in
                                  ("slo_ttft", "slo_tpot",
                                   "tenant_weights")
                                  if k in extra}))
        rec.update(extra)
        return rec
