"""Trace-driven serving workloads: seeded, replayable request streams.

The serving engine is only as honest as its load. A static-batch
microbench answers "how fast is one shape"; a server answers "how fast
is a STREAM" — requests arriving over time (Poisson singles, bursts),
ragged prompt/output lengths, shared system prompts, and mid-run churn
(clients disconnecting). ``synthesize_trace`` generates exactly that
mix from one seed, so the same workload replays bit-identically across
policies, runs, and machines; ``save_trace``/``load_trace`` round-trip
it as JSONL for pinned regression traces.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request as the trace records it.

    ``arrival`` is in the engine clock's units (seconds for a measured
    replay; abstract units under a fixed-cost clock). ``prefix_group``
    marks shared-system-prompt cohorts: every request in a group opens
    with the same token prefix, the prefix-cache case.
    ``cancel_after`` models churn — the client disconnects after that
    many generated tokens and the engine must evict mid-stream.

    QoS fields (read by ``scheduler.QoSScheduler``; the default FIFO
    engine ignores them, so plain traces replay unchanged):
    ``tenant`` names the traffic source for weighted fair queueing;
    ``priority`` is a strict class (higher preempts lower at admission,
    never mid-flight); ``deadline_ms`` is the end-to-end SLO relative
    to arrival, in milliseconds of clock time (1 clock unit = 1000 ms,
    so a fixed-cost replay can reason about deadlines too).

    ``adapter`` names the LoRA adapter this request decodes with
    (multi-model serving; ``None`` — the default, and what every
    legacy trace loads as — is the base model, whose replay is
    byte-identical to pre-adapter engines). The JSONL record carries
    the key only when set, so adapter-less traces round-trip
    byte-identically.

    ``session``/``turn`` mark multi-turn conversation membership
    (``synthesize_session_trace``): every turn of a session carries
    the session id and its 1-based turn index, and each turn's prompt
    EXTENDS the previous turn's — the shape whose round-2 prefixes
    the KV memory hierarchy serves from swapped-in pages. Both
    default None (one-shot requests, every legacy trace), and the
    JSONL record carries the keys only when set — the
    ``Request.adapter`` convention, so session-less traces round-trip
    byte-identically.

    ``schema`` names the grammar/JSON-schema this request's output
    must satisfy (constrained decoding; ``synthesize_schema_trace``).
    ``None`` — the default, and what every legacy trace loads as —
    is a free-running stream. The JSONL record carries the key only
    when set, so schema-less traces round-trip byte-identically.
    """

    rid: str
    arrival: float
    prompt: Tuple[int, ...]
    max_new_tokens: int
    prefix_group: Optional[int] = None
    cancel_after: Optional[int] = None
    tenant: Optional[str] = None
    priority: int = 0
    deadline_ms: Optional[float] = None
    adapter: Optional[str] = None
    session: Optional[str] = None
    turn: Optional[int] = None
    schema: Optional[str] = None

    def to_json(self) -> dict:
        d = {"rid": self.rid, "arrival": self.arrival,
             "prompt": list(self.prompt),
             "max_new_tokens": self.max_new_tokens}
        if self.prefix_group is not None:
            d["prefix_group"] = self.prefix_group
        if self.cancel_after is not None:
            d["cancel_after"] = self.cancel_after
        if self.tenant is not None:
            d["tenant"] = self.tenant
        if self.priority:
            d["priority"] = self.priority
        if self.deadline_ms is not None:
            d["deadline_ms"] = self.deadline_ms
        if self.adapter is not None:
            d["adapter"] = self.adapter
        if self.session is not None:
            d["session"] = self.session
        if self.turn is not None:
            d["turn"] = self.turn
        if self.schema is not None:
            d["schema"] = self.schema
        return d

    @staticmethod
    def from_json(d: dict) -> "Request":
        return Request(rid=str(d["rid"]), arrival=float(d["arrival"]),
                       prompt=tuple(int(t) for t in d["prompt"]),
                       max_new_tokens=int(d["max_new_tokens"]),
                       prefix_group=d.get("prefix_group"),
                       cancel_after=d.get("cancel_after"),
                       tenant=d.get("tenant"),
                       priority=int(d.get("priority", 0)),
                       deadline_ms=d.get("deadline_ms"),
                       adapter=d.get("adapter"),
                       session=d.get("session"),
                       turn=(int(d["turn"]) if "turn" in d else None),
                       schema=d.get("schema"))

    def deadline_time(self) -> Optional[float]:
        """Absolute deadline in clock units (None when unbounded)."""
        if self.deadline_ms is None:
            return None
        return self.arrival + self.deadline_ms / 1000.0


def synthesize_trace(seed: int = 0, n_requests: int = 24, *,
                     arrival: str = "poisson",
                     mean_interarrival: float = 1.0,
                     burst_size: int = 4,
                     prompt_len: Tuple[int, int] = (4, 32),
                     output_len: Tuple[int, int] = (4, 16),
                     vocab_size: int = 128,
                     shared_prefix_frac: float = 0.0,
                     prefix_len: int = 8,
                     n_prefix_groups: int = 2,
                     churn_frac: float = 0.0,
                     rid_prefix: str = "req",
                     start: float = 0.0) -> List[Request]:
    """One seeded request stream. Deterministic in every field: the
    same (seed, knobs) always yields the identical trace.

    ``arrival``:
      - "poisson": exponential interarrival singles — steady mixed
        traffic (ragged lengths dominate the batch structure).
      - "bursty": Poisson-timed BURSTS of ``burst_size`` requests that
        arrive simultaneously with one shared prompt length per burst —
        the uniform-wave shape the dense compiled cache wins.

    ``shared_prefix_frac`` of requests join one of ``n_prefix_groups``
    cohorts whose prompts open with the group's fixed ``prefix_len``
    tokens (pass a page multiple to make whole prefix pages sharable).
    ``churn_frac`` of requests carry a ``cancel_after`` below their
    budget.
    """
    if arrival not in ("poisson", "bursty"):
        raise ValueError(f"arrival {arrival!r}: use 'poisson' or "
                         "'bursty'")
    if arrival == "bursty" and shared_prefix_frac > 0:
        # a per-request prefix bump would break the one-shared-length-
        # per-burst invariant (the dense-wave shape bursts exist for);
        # compose instead: merge_traces(bursty, poisson-with-prefixes)
        raise ValueError("bursty traces keep one prompt length per "
                         "burst; generate shared prefixes in a poisson "
                         "stream and merge_traces the two")
    rng = np.random.default_rng(seed)
    prefixes = [tuple(int(t) for t in rng.integers(
        1, vocab_size, prefix_len)) for _ in range(n_prefix_groups)]

    # arrival times first, so length/prefix draws can't perturb timing
    times: List[float] = []
    t = start
    if arrival == "poisson":
        for _ in range(n_requests):
            t += float(rng.exponential(mean_interarrival))
            times.append(t)
        burst_len = None
    else:
        burst_lens = []
        while len(times) < n_requests:
            t += float(rng.exponential(mean_interarrival * burst_size))
            n = min(burst_size, n_requests - len(times))
            times.extend([t] * n)
            burst_lens.extend(
                [int(rng.integers(prompt_len[0], prompt_len[1] + 1))] * n)
        burst_len = burst_lens

    reqs: List[Request] = []
    for i in range(n_requests):
        if burst_len is not None:
            plen = burst_len[i]
        else:
            plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        group = None
        if shared_prefix_frac > 0 and rng.random() < shared_prefix_frac:
            group = int(rng.integers(0, n_prefix_groups))
            plen = max(plen, prefix_len + 1)  # prefix + own tail
        tail = tuple(int(x) for x in rng.integers(
            1, vocab_size, plen - (prefix_len if group is not None
                                   else 0)))
        prompt = (prefixes[group] + tail) if group is not None else tail
        budget = int(rng.integers(output_len[0], output_len[1] + 1))
        cancel = None
        if churn_frac > 0 and budget > 1 and rng.random() < churn_frac:
            cancel = int(rng.integers(1, budget))
        reqs.append(Request(rid=f"{rid_prefix}{i}", arrival=times[i],
                            prompt=prompt, max_new_tokens=budget,
                            prefix_group=group, cancel_after=cancel))
    return reqs


DEFAULT_TENANTS = {
    # the three-tenant overload cast: an interactive tenant with tight
    # deadlines and a priority class above the rest, a standard tenant
    # with mixed deadlines, and one AGGRESSIVE bulk tenant that issues
    # bursts at twice everyone's share with loose deadlines — the
    # tenant fair queueing exists to contain.
    "intl": {"share": 0.30, "priority": 1, "burst": 1,
             "deadline": "tight"},
    "std": {"share": 0.30, "priority": 0, "burst": 1,
            "deadline": "mix"},
    "bulk": {"share": 0.40, "priority": 0, "burst": 4,
             "deadline": "loose"},
}


def synthesize_overload_trace(seed: int = 0, n_requests: int = 48, *,
                              service_tokens_per_unit: float = 4.0,
                              overload: float = 2.0,
                              tenants: Optional[dict] = None,
                              prompt_len: Tuple[int, int] = (4, 12),
                              output_len: Tuple[int, int] = (4, 12),
                              vocab_size: int = 128,
                              unit_ms: float = 1000.0,
                              tight_slack: float = 2.5,
                              loose_slack: float = 10.0,
                              rid_prefix: str = "q",
                              start: float = 0.0) -> List[Request]:
    """A seeded multi-tenant OVERLOAD trace: total demanded decode
    tokens arrive at ``overload`` x the engine's service rate, so a
    FIFO queue must grow without bound and only a scheduler that sheds
    or reorders can protect anyone's SLO.

    ``service_tokens_per_unit`` is the engine's decode capacity in
    tokens per clock unit (``slots * decode_chunk / decode_cost`` for a
    fixed-cost clock); arrival times are scaled so the trace's total
    output budget divided by its span equals ``overload`` x that rate.

    ``tenants`` maps name -> {share, priority, burst, deadline} (see
    ``DEFAULT_TENANTS``). ``burst > 1`` makes that tenant aggressive:
    its requests land in simultaneous bursts of that size. ``deadline``
    is "tight" / "loose" / "mix"; per-request ``deadline_ms`` is
    ``(1 + budget) * unit_ms * slack`` — the ideal lone-request service
    time (one prefill unit + one decode unit per token) times the
    cohort's slack. rids end in ".tight" / ".loose" so benches can
    split cohorts without a side channel.

    Deterministic in every field: same (seed, knobs) -> same trace.
    """
    spec = tenants if tenants is not None else DEFAULT_TENANTS
    if not spec:
        raise ValueError("need at least one tenant")
    rng = np.random.default_rng(seed)
    names = sorted(spec)
    # integer request counts per tenant, largest-share tenants absorb
    # the rounding remainder (deterministic)
    shares = np.asarray([float(spec[n].get("share", 1.0))
                         for n in names])
    shares = shares / shares.sum()
    counts = np.floor(shares * n_requests).astype(int)
    order = np.argsort(-shares)
    k = 0
    while counts.sum() < n_requests:
        counts[order[k % len(names)]] += 1
        k += 1

    # draw budgets first so the span can be sized to the demanded work
    budgets = {n: [int(rng.integers(output_len[0], output_len[1] + 1))
                   for _ in range(counts[i])]
               for i, n in enumerate(names)}
    total_tokens = sum(sum(b) for b in budgets.values())
    span = total_tokens / (overload * service_tokens_per_unit)

    reqs: List[Request] = []
    for i, name in enumerate(names):
        cfg = spec[name]
        n_t = int(counts[i])
        if n_t == 0:
            continue
        burst = max(1, int(cfg.get("burst", 1)))
        # a Poisson process conditioned on N arrivals in [0, span] IS
        # N sorted uniforms; bursty tenants share one draw per burst
        n_bursts = -(-n_t // burst)
        burst_times = np.sort(rng.uniform(0.0, span, n_bursts))
        times = np.repeat(burst_times, burst)[:n_t]
        mode = cfg.get("deadline", "mix")
        for j in range(n_t):
            plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
            prompt = tuple(int(t) for t in rng.integers(
                1, vocab_size, plen))
            budget = budgets[name][j]
            tight = {"tight": True, "loose": False}.get(
                mode, None)
            if tight is None:
                tight = bool(rng.random() < 0.5)
            slack = tight_slack if tight else loose_slack
            cohort = "tight" if tight else "loose"
            reqs.append(Request(
                rid=f"{rid_prefix}-{name}{j}.{cohort}",
                arrival=start + float(times[j]), prompt=prompt,
                max_new_tokens=budget, tenant=name,
                priority=int(cfg.get("priority", 0)),
                deadline_ms=round((1 + budget) * unit_ms * slack, 3)))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def synthesize_recurring_prefix_trace(seed: int = 0, *,
                                      n_cohorts: int = 2,
                                      cohort_size: int = 4,
                                      rounds: int = 3,
                                      prefix_len: int = 24,
                                      tail_len: Tuple[int, int] = (2, 8),
                                      output_len: Tuple[int, int]
                                      = (4, 8),
                                      vocab_size: int = 128,
                                      round_gap: float = 60.0,
                                      intra_gap: float = 0.5,
                                      rid_prefix: str = "p",
                                      start: float = 0.0,
                                      tag_groups: bool = False) \
        -> List[Request]:
    """The recurring-system-prompt workload — the dominant production
    shape automatic prefix caching exists for. ``n_cohorts`` system
    prompts (fixed ``prefix_len`` tokens each; pass a page multiple so
    whole pages are sharable) are each re-queried by ``cohort_size``
    requests per round, for ``rounds`` rounds.

    Rounds are separated by ``round_gap`` clock units — sized far past
    a round's service time — so LIVENESS-only sharing (prefix pages
    alive only while a sharer still holds them, the behavior)
    gets ZERO cross-round hits: only RETENTION (evictable LRU pages
    surviving refcount 0) can serve round >= 2 from cache. Within a
    round, requests arrive ``intra_gap`` apart, interleaved across
    cohorts.

    rids are ``{rid_prefix}-r<round>c<cohort>.<i>`` (rounds 1-based)
    so benches can split rounds without a side channel.
    ``prefix_group`` stays None unless ``tag_groups`` — automatic
    caching needs no tag; the tag only feeds the router's
    shared_prefix signal. Deterministic in every field."""
    if prefix_len < 1 or rounds < 1 or n_cohorts < 1 or cohort_size < 1:
        raise ValueError("need >= 1 cohort, round, member and prefix "
                         "token")
    rng = np.random.default_rng(seed)
    prefixes = [tuple(int(t) for t in rng.integers(
        1, vocab_size, prefix_len)) for _ in range(n_cohorts)]
    reqs: List[Request] = []
    for rnd in range(1, rounds + 1):
        t0 = start + (rnd - 1) * round_gap
        for i in range(cohort_size):
            for c in range(n_cohorts):
                tail = tuple(int(x) for x in rng.integers(
                    1, vocab_size,
                    int(rng.integers(tail_len[0], tail_len[1] + 1))))
                budget = int(rng.integers(output_len[0],
                                          output_len[1] + 1))
                reqs.append(Request(
                    rid=f"{rid_prefix}-r{rnd}c{c}.{i}",
                    arrival=t0 + (i * n_cohorts + c) * intra_gap,
                    prompt=prefixes[c] + tail,
                    max_new_tokens=budget,
                    prefix_group=c if tag_groups else None))
    return reqs


def synthesize_cluster_trace(seed: int = 0,
                             n_requests: int = 100_000, *,
                             service_tokens_per_unit: float = 7.5,
                             overload: float = 1.7,
                             tenants: Optional[dict] = None,
                             n_cohorts: int = 24,
                             prefix_len: int = 32,
                             cohort_frac: float = 0.8,
                             cohort_skew: float = 1.1,
                             tail_len: Tuple[int, int] = (2, 8),
                             output_len: Tuple[int, int] = (4, 12),
                             vocab_size: int = 509,
                             unit_ms: float = 1000.0,
                             chunk_tokens: int = 8,
                             tight_slack: float = 2.0,
                             loose_slack: float = 6.0,
                             rid_prefix: str = "c",
                             start: float = 0.0) -> List[Request]:
    """The cluster-scale workload: ~10^5 requests of multi-tenant
    OVERLOAD traffic whose prompts are dominated by shared-prefix
    cohorts — the shape where prefix-aware placement earns its keep.

    ``service_tokens_per_unit`` is the CLUSTER's decode capacity
    (``n_replicas * slots * decode_chunk / decode_cost`` on a fixed
    clock); arrivals are scaled so demanded output tokens land at
    ``overload`` x that rate — enough pressure that placement quality
    converts into goodput, not just latency.

    ``cohort_frac`` of requests open with one of ``n_cohorts`` fixed
    ``prefix_len``-token system prompts; cohort choice is SKEWED by a
    Zipf-like law (weight ``1/(rank+1)^cohort_skew``) so hot cohorts
    dominate, exactly like production system prompts. Sized right
    (total cohort prefix pages >> one replica's retention slack,
    per-replica share of cohorts <= that slack), round-robin placement
    makes every replica serve every cohort and thrash its retention
    LRU, while prefix-aware placement partitions cohorts across
    replicas and hits. Solo prompts draw a random prefix-length body
    plus the same tail distribution, so cohort and solo requests load
    the engine identically.

    Tenants follow ``DEFAULT_TENANTS`` semantics (share / priority /
    burst / deadline mode); per-request ``deadline_ms`` is
    ``(ceil(prompt/chunk_tokens) + budget + 1) * unit_ms * slack`` —
    the lone-request service estimate under per-chunk prefill pricing
    times the cohort's slack. rids are
    ``{rid_prefix}-{tenant}{i}.k{cohort|solo}.{tight|loose}`` so
    benches can split cohorts and SLO classes without a side channel.
    Deterministic in every field: same (seed, knobs) -> same trace.
    """
    spec = tenants if tenants is not None else DEFAULT_TENANTS
    if not spec:
        raise ValueError("need at least one tenant")
    if not 0.0 <= cohort_frac <= 1.0:
        raise ValueError("cohort_frac must be in [0, 1]")
    if n_cohorts < 1 or prefix_len < 1:
        raise ValueError("need >= 1 cohort and >= 1 prefix token")
    rng = np.random.default_rng(seed)
    prefixes = [tuple(int(t) for t in rng.integers(
        1, vocab_size, prefix_len)) for _ in range(n_cohorts)]
    cw = np.asarray([1.0 / (c + 1) ** cohort_skew
                     for c in range(n_cohorts)])
    cw = cw / cw.sum()

    names = sorted(spec)
    shares = np.asarray([float(spec[n].get("share", 1.0))
                         for n in names])
    shares = shares / shares.sum()
    counts = np.floor(shares * n_requests).astype(int)
    order = np.argsort(-shares)
    k = 0
    while counts.sum() < n_requests:
        counts[order[k % len(names)]] += 1
        k += 1

    budgets = {n: [int(rng.integers(output_len[0], output_len[1] + 1))
                   for _ in range(counts[i])]
               for i, n in enumerate(names)}
    total_tokens = sum(sum(b) for b in budgets.values())
    span = total_tokens / (overload * service_tokens_per_unit)

    reqs: List[Request] = []
    for i, name in enumerate(names):
        cfg = spec[name]
        n_t = int(counts[i])
        if n_t == 0:
            continue
        burst = max(1, int(cfg.get("burst", 1)))
        n_bursts = -(-n_t // burst)
        burst_times = np.sort(rng.uniform(0.0, span, n_bursts))
        times = np.repeat(burst_times, burst)[:n_t]
        mode = cfg.get("deadline", "mix")
        for j in range(n_t):
            tlen = int(rng.integers(tail_len[0], tail_len[1] + 1))
            tail = tuple(int(t) for t in rng.integers(
                1, vocab_size, tlen))
            if cohort_frac > 0 and rng.random() < cohort_frac:
                c = int(rng.choice(n_cohorts, p=cw))
                prompt = prefixes[c] + tail
                ctag = f"k{c}"
            else:
                body = tuple(int(t) for t in rng.integers(
                    1, vocab_size, prefix_len))
                prompt = body + tail
                ctag = "solo"
            budget = budgets[name][j]
            tight = {"tight": True, "loose": False}.get(mode, None)
            if tight is None:
                tight = bool(rng.random() < 0.5)
            slack = tight_slack if tight else loose_slack
            cohort = "tight" if tight else "loose"
            chunks = -(-len(prompt) // chunk_tokens)
            reqs.append(Request(
                rid=f"{rid_prefix}-{name}{j}.{ctag}.{cohort}",
                arrival=start + float(times[j]), prompt=prompt,
                max_new_tokens=budget, tenant=name,
                priority=int(cfg.get("priority", 0)),
                deadline_ms=round((chunks + budget + 1) * unit_ms
                                  * slack, 3)))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def synthesize_prefill_heavy_trace(seed: int = 0, *,
                                   n_short: int = 48,
                                   n_long: int = 12,
                                   short_gap: float = 5.0,
                                   short_prompt: Tuple[int, int]
                                   = (5, 8),
                                   short_output: Tuple[int, int]
                                   = (24, 32),
                                   long_prompt: Tuple[int, int]
                                   = (48, 64),
                                   long_output: Tuple[int, int]
                                   = (4, 8),
                                   burst_size: int = 4,
                                   burst_gap: float = 60.0,
                                   first_burst: float = 10.0,
                                   vocab_size: int = 128,
                                   rid_prefix: str = "h",
                                   start: float = 0.0) \
        -> List[Request]:
    """The ADVERSARIAL shape for an interleaved prefill/decode loop:
    a steady stream of short-prompt, long-budget requests (they fill
    the decode slots and stay mid-decode) punctuated by BURSTS of
    long, mostly-uncached prompts (every prompt body is an
    independent draw — nothing for the prefix cache to serve). Each
    burst's prefill chunks are what stall every active decode slot
    when prefill monopolizes the turn; the async prefill lane (and
    cluster-level disaggregation) exists to make TPOT independent of
    exactly this queue.

    rids end in ``.short`` / ``.long`` so benches can split the
    mid-decode cohort (whose TPOT the burst torches) from the burst
    cohort (whose prefill does the torching) without a side channel.
    Defaults are sized for a slots=8 / decode_chunk=4 engine on the
    unit-cost fixed clock at ~80%% utilization — loaded enough that
    bursts land while every slot decodes, slack enough that queueing
    does not drown the phase split. Deterministic in every field;
    JSONL round-trips through ``save_trace``/``load_trace`` like
    every other synthesizer."""
    if n_short < 1 or n_long < 0 or burst_size < 1:
        raise ValueError("need >= 1 short request and a >= 1 burst "
                         "size")
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t = start
    for i in range(n_short):
        t += short_gap
        plen = int(rng.integers(short_prompt[0], short_prompt[1] + 1))
        reqs.append(Request(
            rid=f"{rid_prefix}-s{i:03d}.short", arrival=t,
            prompt=tuple(int(x) for x in rng.integers(
                1, vocab_size, plen)),
            max_new_tokens=int(rng.integers(short_output[0],
                                            short_output[1] + 1))))
    k = 0
    b = 0
    while k < n_long:
        tb = start + first_burst + b * burst_gap
        for j in range(burst_size):
            if k >= n_long:
                break
            plen = int(rng.integers(long_prompt[0],
                                    long_prompt[1] + 1))
            reqs.append(Request(
                rid=f"{rid_prefix}-l{b}.{j}.long", arrival=tb,
                prompt=tuple(int(x) for x in rng.integers(
                    1, vocab_size, plen)),
                max_new_tokens=int(rng.integers(long_output[0],
                                                long_output[1] + 1))))
            k += 1
        b += 1
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def synthesize_admission_burst_trace(seed: int = 0, *,
                                     n_bursts: int = 3,
                                     burst_size: int = 8,
                                     burst_gap: float = 80.0,
                                     first_burst: float = 16.0,
                                     burst_prompt: Tuple[int, int]
                                     = (28, 32),
                                     burst_output: Tuple[int, int]
                                     = (2, 4),
                                     n_background: int = 12,
                                     background_gap: float = 4.0,
                                     background_prompt: Tuple[int, int]
                                     = (3, 6),
                                     background_output: Tuple[int, int]
                                     = (48, 64),
                                     vocab_size: int = 128,
                                     rid_prefix: str = "ab",
                                     start: float = 0.0) \
        -> List[Request]:
    """SYNCHRONIZED arrival spikes: every request of a burst arrives
    at the SAME instant, so a per-chunk prefill lane must serialize
    ``burst_size`` independent long prompts one bounded call at a
    time — the shape whose TTFT a ragged batched prefill divides by
    the batching factor (all lane rows ride ONE fused program per
    turn). A background cohort of short-prompt, long-budget requests
    keeps the decode slots busy so each serialized chunk turn also
    pays for a decode batch, exactly the contention the fused lane
    amortizes.

    The burst factor is named in the rids — burst rows end in
    ``.x{burst_size}`` (e.g. ``ab-b0.03.x8``) and background rows in
    ``.bg`` — so benches split the spike cohort (the TTFT claim) from
    the steady cohort without a side channel. Deterministic in every
    field; JSONL round-trips through ``save_trace``/``load_trace``
    like every other synthesizer."""
    if n_bursts < 1 or burst_size < 1 or n_background < 0:
        raise ValueError("need >= 1 burst of >= 1 request")
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t = start
    for i in range(n_background):
        t += background_gap
        plen = int(rng.integers(background_prompt[0],
                                background_prompt[1] + 1))
        reqs.append(Request(
            rid=f"{rid_prefix}-g{i:03d}.bg", arrival=t,
            prompt=tuple(int(x) for x in rng.integers(
                1, vocab_size, plen)),
            max_new_tokens=int(rng.integers(background_output[0],
                                            background_output[1]
                                            + 1))))
    for b in range(n_bursts):
        tb = start + first_burst + b * burst_gap
        for j in range(burst_size):
            plen = int(rng.integers(burst_prompt[0],
                                    burst_prompt[1] + 1))
            reqs.append(Request(
                rid=f"{rid_prefix}-b{b}.{j:02d}.x{burst_size}",
                arrival=tb,
                prompt=tuple(int(x) for x in rng.integers(
                    1, vocab_size, plen)),
                max_new_tokens=int(rng.integers(burst_output[0],
                                                burst_output[1]
                                                + 1))))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def synthesize_zipf_adapter_trace(seed: int = 0,
                                  n_requests: int = 2000, *,
                                  n_adapters: int = 4,
                                  adapter_skew: float = 1.1,
                                  base_frac: float = 0.0,
                                  service_tokens_per_unit: float = 8.0,
                                  overload: float = 1.4,
                                  prompt_len: Tuple[int, int] = (4, 12),
                                  output_len: Tuple[int, int] = (4, 12),
                                  churn_frac: float = 0.05,
                                  vocab_size: int = 509,
                                  unit_ms: float = 1000.0,
                                  slack: float = 6.0,
                                  chunk_tokens: int = 8,
                                  rid_prefix: str = "L",
                                  start: float = 0.0) -> List[Request]:
    """The MULTI-MODEL workload: mixed-churn traffic whose requests
    each name one of ``n_adapters`` LoRA adapters, popularity SKEWED
    by a Zipf-like law (weight ``1/(rank+1)^adapter_skew``) — exactly
    how production fine-tune traffic concentrates on a few hot
    variants while a long tail stays warm. ``base_frac`` of requests
    carry ``adapter=None`` (base-model traffic riding the same
    batches through the identity slot).

    Arrivals are sorted uniforms over a span sized so demanded output
    tokens land at ``overload`` x ``service_tokens_per_unit`` (the
    multiplexed engine's capacity): hot-adapter demand alone then
    exceeds any single dedicated replica's share, which is the gap
    the one-engine-per-adapter split loses goodput to and adapter
    multiplexing recovers. ``churn_frac`` of requests carry a
    ``cancel_after`` below budget (the mixed-churn shape — adapter
    pins must survive mid-stream eviction). Every request gets a
    loose ``deadline_ms`` (lone-request per-chunk service estimate x
    ``slack``) so goodput is deadline-honest.

    Adapter ids are BAKED INTO rids — ``{rid_prefix}-00042.a3`` /
    ``...base`` — so a gate can audit per-adapter routing and parity
    without a side channel; the adapter NAME is ``a<k>``.
    Deterministic in every field; JSONL round-trips via
    ``save_trace``/``load_trace``."""
    if n_adapters < 1:
        raise ValueError("need >= 1 adapter")
    if not 0.0 <= base_frac <= 1.0:
        raise ValueError("base_frac must be in [0, 1]")
    if adapter_skew < 0:
        raise ValueError("adapter_skew must be >= 0")
    rng = np.random.default_rng(seed)
    w = np.asarray([1.0 / (k + 1) ** adapter_skew
                    for k in range(n_adapters)])
    w = w / w.sum()
    budgets = [int(rng.integers(output_len[0], output_len[1] + 1))
               for _ in range(n_requests)]
    span = sum(budgets) / (overload * service_tokens_per_unit)
    times = np.sort(rng.uniform(0.0, span, n_requests))
    reqs: List[Request] = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = tuple(int(t) for t in rng.integers(1, vocab_size,
                                                    plen))
        budget = budgets[i]
        if base_frac > 0 and rng.random() < base_frac:
            adapter, tag = None, "base"
        else:
            k = int(rng.choice(n_adapters, p=w))
            adapter, tag = f"a{k}", f"a{k}"
        cancel = None
        if churn_frac > 0 and budget > 1 \
                and rng.random() < churn_frac:
            cancel = int(rng.integers(1, budget))
        chunks = -(-plen // chunk_tokens)
        reqs.append(Request(
            rid=f"{rid_prefix}-{i:05d}.{tag}",
            arrival=start + float(times[i]), prompt=prompt,
            max_new_tokens=budget, cancel_after=cancel,
            deadline_ms=round((chunks + budget + 1) * unit_ms
                              * slack, 3),
            adapter=adapter))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def synthesize_schema_trace(seed: int = 0, n_requests: int = 2000, *,
                            n_schemas: int = 4,
                            schema_skew: float = 1.1,
                            free_frac: float = 0.25,
                            service_tokens_per_unit: float = 8.0,
                            overload: float = 1.4,
                            prompt_len: Tuple[int, int] = (4, 12),
                            output_len: Tuple[int, int] = (24, 48),
                            vocab_size: int = 509,
                            unit_ms: float = 1000.0,
                            slack: float = 6.0,
                            chunk_tokens: int = 8,
                            rid_prefix: str = "G",
                            start: float = 0.0) -> List[Request]:
    """The STRUCTURED-OUTPUT workload: traffic whose requests each
    name one of ``n_schemas`` grammars (constrained decoding),
    popularity SKEWED by a Zipf-like law (weight
    ``1/(rank+1)^schema_skew``) — production tool-call traffic
    concentrates on a few hot schemas while a long tail stays warm,
    which is exactly the shape the budgeted ``GrammarCache`` serves
    with one compile per schema. ``free_frac`` of requests carry
    ``schema=None`` (free-running streams riding the same batches
    through the all-allow state).

    Arrivals are sorted uniforms over a span sized so demanded output
    tokens land at ``overload`` x ``service_tokens_per_unit``; output
    budgets are generous (``output_len`` high) because a constrained
    stream self-terminates when its automaton accepts — the budget is
    a ceiling, not the expected length. Every request gets a loose
    ``deadline_ms`` so goodput stays deadline-honest.

    Schema ids are BAKED INTO rids — ``{rid_prefix}-00042.s3`` /
    ``...free`` — so a gate can audit per-schema routing and free-row
    parity without a side channel; the schema NAME is ``s<k>``.
    Deterministic in every field; JSONL round-trips via
    ``save_trace``/``load_trace``."""
    if n_schemas < 1:
        raise ValueError("need >= 1 schema")
    if not 0.0 <= free_frac <= 1.0:
        raise ValueError("free_frac must be in [0, 1]")
    if schema_skew < 0:
        raise ValueError("schema_skew must be >= 0")
    rng = np.random.default_rng(seed)
    w = np.asarray([1.0 / (k + 1) ** schema_skew
                    for k in range(n_schemas)])
    w = w / w.sum()
    budgets = [int(rng.integers(output_len[0], output_len[1] + 1))
               for _ in range(n_requests)]
    span = sum(budgets) / (overload * service_tokens_per_unit)
    times = np.sort(rng.uniform(0.0, span, n_requests))
    reqs: List[Request] = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = tuple(int(t) for t in rng.integers(1, vocab_size,
                                                    plen))
        budget = budgets[i]
        if free_frac > 0 and rng.random() < free_frac:
            schema, tag = None, "free"
        else:
            k = int(rng.choice(n_schemas, p=w))
            schema, tag = f"s{k}", f"s{k}"
        chunks = -(-plen // chunk_tokens)
        reqs.append(Request(
            rid=f"{rid_prefix}-{i:05d}.{tag}",
            arrival=start + float(times[i]), prompt=prompt,
            max_new_tokens=budget,
            deadline_ms=round((chunks + budget + 1) * unit_ms
                              * slack, 3),
            schema=schema))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def synthesize_session_trace(seed: int = 0, n_sessions: int = 8, *,
                             turns: int = 3,
                             think_time: float = 40.0,
                             first_prompt_len: Tuple[int, int]
                             = (16, 32),
                             turn_prompt_len: Tuple[int, int] = (4, 8),
                             output_len: Tuple[int, int] = (4, 8),
                             vocab_size: int = 128,
                             mean_interarrival: float = 2.0,
                             rid_prefix: str = "s",
                             start: float = 0.0) -> List[Request]:
    """The MULTI-TURN workload — the real shape of million-user chat
    traffic, and what the KV memory hierarchy is gated on. Each of
    ``n_sessions`` conversations opens with a ``first_prompt_len``
    prompt, then issues ``turns - 1`` follow-ups: turn ``k``'s prompt
    is turn ``k-1``'s prompt EXTENDED by fresh ``turn_prompt_len``
    tokens, arriving an exponential ``think_time`` gap after the
    previous turn — long enough (size it far past a turn's service
    time) that the session's prefix pages have left the running set
    and only the retention LRU or the host arena can serve round 2
    from cache instead of recomputing.

    Session openers arrive ``mean_interarrival`` apart (exponential),
    so sessions overlap and the resident pool must juggle many cold
    prefixes at once — the pressure that makes spill-to-host pay.
    rids are ``{rid_prefix}{j}.t{k}`` (turns 1-based) and every
    request carries ``session={rid_prefix}{j}``/``turn=k``, so
    benches split turn cohorts without a side channel. Deterministic
    in every field; JSONL round-trips via ``save_trace``/
    ``load_trace`` (legacy session-less traces stay byte-identical —
    the keys are emitted only when set)."""
    if n_sessions < 1 or turns < 1:
        raise ValueError("need >= 1 session of >= 1 turn")
    if think_time <= 0 or mean_interarrival <= 0:
        raise ValueError("think_time and mean_interarrival must be "
                         "> 0")
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t0 = start
    for j in range(n_sessions):
        t0 += float(rng.exponential(mean_interarrival))
        sid = f"{rid_prefix}{j}"
        plen = int(rng.integers(first_prompt_len[0],
                                first_prompt_len[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(1, vocab_size,
                                                    plen))
        t = t0
        for k in range(1, turns + 1):
            if k > 1:
                t += float(rng.exponential(think_time))
                ext = int(rng.integers(turn_prompt_len[0],
                                       turn_prompt_len[1] + 1))
                prompt = prompt + tuple(
                    int(x) for x in rng.integers(1, vocab_size, ext))
            budget = int(rng.integers(output_len[0],
                                      output_len[1] + 1))
            reqs.append(Request(
                rid=f"{sid}.t{k}", arrival=t, prompt=prompt,
                max_new_tokens=budget, session=sid, turn=k))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def _profile_times(rng, n: int, span: float, shape) -> np.ndarray:
    """``n`` sorted arrival times over ``[0, span]`` drawn from an
    inhomogeneous Poisson process with relative rate ``shape`` (an
    array sampled on a uniform grid over the span): the standard
    time-rescaling construction — N arrivals conditioned on the span
    are N sorted uniforms over the CUMULATIVE intensity, mapped back
    through its inverse (piecewise-linear interpolation over the
    grid). Deterministic in (rng state, shape)."""
    shape = np.asarray(shape, float)
    if shape.ndim != 1 or len(shape) < 2 or (shape <= 0).any():
        raise ValueError("shape must be >= 2 strictly positive "
                         "relative-rate samples")
    grid = np.linspace(0.0, span, len(shape))
    cum = np.concatenate([[0.0], np.cumsum(
        (shape[1:] + shape[:-1]) * 0.5 * np.diff(grid))])
    u = np.sort(rng.uniform(0.0, cum[-1], n))
    return np.interp(u, cum, grid)


def _profiled_tenant_trace(rng, shape, span: float, *,
                           tenants: dict,
                           prompt_len: Tuple[int, int],
                           budgets: dict, counts, names,
                           vocab_size: int, unit_ms: float,
                           chunk_tokens: int, tight_slack: float,
                           loose_slack: float, rid_prefix: str,
                           start: float) -> List[Request]:
    """The shared tenant/deadline body of the rate-profiled traces:
    identical request semantics to ``synthesize_cluster_trace`` (per-
    chunk deadline pricing, tight/loose cohort rid tags, bursty
    tenants sharing one arrival draw per burst) with arrival times
    drawn from ``shape`` via ``_profile_times`` instead of a flat
    uniform — so a diurnal day and a flash crowd load the engine with
    the SAME request mix the overload gates are calibrated on, just
    on a different clock."""
    reqs: List[Request] = []
    for i, name in enumerate(names):
        cfg = tenants[name]
        n_t = int(counts[i])
        if n_t == 0:
            continue
        burst = max(1, int(cfg.get("burst", 1)))
        n_bursts = -(-n_t // burst)
        burst_times = _profile_times(rng, n_bursts, span, shape)
        times = np.repeat(burst_times, burst)[:n_t]
        mode = cfg.get("deadline", "mix")
        for j in range(n_t):
            plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
            prompt = tuple(int(t) for t in rng.integers(
                1, vocab_size, plen))
            budget = budgets[name][j]
            tight = {"tight": True, "loose": False}.get(mode, None)
            if tight is None:
                tight = bool(rng.random() < 0.5)
            slack = tight_slack if tight else loose_slack
            cohort = "tight" if tight else "loose"
            chunks = -(-len(prompt) // chunk_tokens)
            reqs.append(Request(
                rid=f"{rid_prefix}-{name}{j}.{cohort}",
                arrival=start + float(times[j]), prompt=prompt,
                max_new_tokens=budget, tenant=name,
                priority=int(cfg.get("priority", 0)),
                deadline_ms=round((chunks + budget + 1) * unit_ms
                                  * slack, 3)))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def _tenant_counts_budgets(rng, spec, n_requests, output_len):
    """The deterministic per-tenant request-count and budget draws
    every overload-family synthesizer shares (largest-share tenants
    absorb the rounding remainder; budgets drawn FIRST so the span
    can be sized to the demanded work)."""
    names = sorted(spec)
    shares = np.asarray([float(spec[n].get("share", 1.0))
                         for n in names])
    shares = shares / shares.sum()
    counts = np.floor(shares * n_requests).astype(int)
    order = np.argsort(-shares)
    k = 0
    while counts.sum() < n_requests:
        counts[order[k % len(names)]] += 1
        k += 1
    budgets = {n: [int(rng.integers(output_len[0], output_len[1] + 1))
                   for _ in range(counts[i])]
               for i, n in enumerate(names)}
    return names, counts, budgets


def synthesize_diurnal_trace(seed: int = 0,
                             n_requests: int = 100_000, *,
                             service_tokens_per_unit: float = 25.0,
                             peak_overload: float = 1.05,
                             trough: float = 0.2,
                             days: float = 1.0,
                             tenants: Optional[dict] = None,
                             prompt_len: Tuple[int, int] = (4, 12),
                             output_len: Tuple[int, int] = (4, 12),
                             vocab_size: int = 509,
                             unit_ms: float = 1000.0,
                             chunk_tokens: int = 8,
                             tight_slack: float = 2.0,
                             loose_slack: float = 6.0,
                             rid_prefix: str = "d",
                             start: float = 0.0,
                             grid: int = 2048) -> List[Request]:
    """The DIURNAL workload: arrival rate follows a day cycle —
    ``rate(x) = trough + (1 - trough) * sin(pi * days * x)^2`` over
    the span (``days`` full trough->peak->trough cycles; peak 1.0 at
    mid-cycle, ``trough`` at the edges). The span is sized so the
    PEAK instantaneous token demand equals ``peak_overload`` x
    ``service_tokens_per_unit`` (the fleet capacity the trace is
    aimed at): a fleet sized to the peak idles most of the day, a
    fleet sized to the mean burns its error budget every peak — the
    exact gap elastic autoscaling exists to close, and the virtual
    clock makes a 10^5-request "day" cheap.

    Tenants/deadlines/rids follow ``synthesize_cluster_trace``'s
    semantics (per-chunk deadline pricing, ``.tight``/``.loose``
    cohort tags). Deterministic in every field; JSONL round-trips via
    ``save_trace``/``load_trace``."""
    if not 0.0 < trough <= 1.0:
        raise ValueError("trough is a relative rate in (0, 1]")
    if peak_overload <= 0 or days <= 0:
        raise ValueError("peak_overload and days must be > 0")
    spec = tenants if tenants is not None else DEFAULT_TENANTS
    if not spec:
        raise ValueError("need at least one tenant")
    rng = np.random.default_rng(seed)
    names, counts, budgets = _tenant_counts_budgets(
        rng, spec, n_requests, output_len)
    total_tokens = sum(sum(b) for b in budgets.values())
    xs = np.linspace(0.0, 1.0, grid)
    shape = trough + (1.0 - trough) * np.sin(np.pi * days * xs) ** 2
    mean_f, peak_f = float(shape.mean()), float(shape.max())
    # peak token rate = (T / (mean_f * span)) * peak_f == po * cap
    span = total_tokens * peak_f \
        / (mean_f * peak_overload * service_tokens_per_unit)
    return _profiled_tenant_trace(
        rng, shape, span, tenants=spec,
        prompt_len=prompt_len, budgets=budgets,
        counts=counts, names=names, vocab_size=vocab_size,
        unit_ms=unit_ms, chunk_tokens=chunk_tokens,
        tight_slack=tight_slack, loose_slack=loose_slack,
        rid_prefix=rid_prefix, start=start)


def synthesize_flash_crowd_trace(seed: int = 0,
                                 n_requests: int = 100_000, *,
                                 service_tokens_per_unit: float = 25.0,
                                 base_overload: float = 0.55,
                                 spikes: Tuple[Tuple[float, float,
                                                     float], ...]
                                 = ((0.55, 0.06, 3.5),),
                                 tenants: Optional[dict] = None,
                                 prompt_len: Tuple[int, int] = (4, 12),
                                 output_len: Tuple[int, int] = (4, 12),
                                 vocab_size: int = 509,
                                 unit_ms: float = 1000.0,
                                 chunk_tokens: int = 8,
                                 tight_slack: float = 2.0,
                                 loose_slack: float = 6.0,
                                 rid_prefix: str = "f",
                                 start: float = 0.0,
                                 grid: int = 2048) -> List[Request]:
    """The FLASH-CROWD workload: a steady base rate (sized so base
    token demand = ``base_overload`` x ``service_tokens_per_unit`` —
    comfortably under capacity) punctuated by sudden rate spikes.
    Each spike is ``(t0_frac, dur_frac, magnitude)``: from ``t0_frac``
    of the span, for ``dur_frac`` of it, the rate multiplies by
    ``magnitude`` — the viral-moment shape no static fleet sized to
    NORMAL traffic survives, and the detect->act loop's reaction-time
    test (a burn-rate incident opens inside the spike; the join must
    land before the budget is gone).

    Same tenant/deadline semantics as the diurnal trace.
    Deterministic in every field; JSONL round-trips."""
    if base_overload <= 0:
        raise ValueError("base_overload must be > 0")
    for t0, dur, mag in spikes:
        if not (0.0 <= t0 < 1.0 and 0.0 < dur <= 1.0 and mag >= 1.0):
            raise ValueError("each spike is (t0_frac in [0,1), "
                             "dur_frac in (0,1], magnitude >= 1)")
    spec = tenants if tenants is not None else DEFAULT_TENANTS
    if not spec:
        raise ValueError("need at least one tenant")
    rng = np.random.default_rng(seed)
    names, counts, budgets = _tenant_counts_budgets(
        rng, spec, n_requests, output_len)
    total_tokens = sum(sum(b) for b in budgets.values())
    xs = np.linspace(0.0, 1.0, grid)
    shape = np.ones_like(xs)
    for t0, dur, mag in spikes:
        # multiplicative, as documented: overlapping spikes compound
        # (a single spike from the base rate is identical either way)
        shape = np.where((xs >= t0) & (xs < t0 + dur),
                         shape * mag, shape)
    mean_f = float(shape.mean())
    # BASE token rate (relative rate 1.0) == base_overload * cap
    span = total_tokens \
        / (mean_f * base_overload * service_tokens_per_unit)
    return _profiled_tenant_trace(
        rng, shape, span, tenants=spec,
        prompt_len=prompt_len, budgets=budgets,
        counts=counts, names=names, vocab_size=vocab_size,
        unit_ms=unit_ms, chunk_tokens=chunk_tokens,
        tight_slack=tight_slack, loose_slack=loose_slack,
        rid_prefix=rid_prefix, start=start)


def synthesize_deadline_mix_trace(seed: int = 0,
                                  n_requests: int = 160, *,
                                  service_tokens_per_unit: float = 8.0,
                                  base_load: float = 0.6,
                                  surge: Tuple[float, float, float]
                                  = (0.5, 0.18, 4.0),
                                  loose_frac: float = 0.75,
                                  prompt_len: Tuple[int, int] = (4, 12),
                                  output_len: Tuple[int, int] = (4, 12),
                                  vocab_size: int = 509,
                                  unit_ms: float = 1000.0,
                                  chunk_tokens: int = 8,
                                  loose_slack: float = 6.0,
                                  tight_slack: float = 2.0,
                                  rid_prefix: str = "sx",
                                  start: float = 0.0,
                                  grid: int = 1024) -> List[Request]:
    """The SPECULATIVE-serving workload: a deadline/priority COHORT
    mix on a calm-then-surge arrival profile, sized so the adaptive
    spec rule exercises BOTH of its paths.

    - ``loose_frac`` of requests form the **loose** cohort (priority
      0, ``deadline_ms = (chunks + budget + 1) * unit_ms *
      loose_slack`` — comfortably above the default
      ``SpecConfig.loose_deadline_ms``): the traffic the per-request
      rule routes SPECULATIVE. The rest form the **tight** cohort
      (priority 1, ``tight_slack``): latency-critical rows the rule
      keeps on plain decode. The cohort is baked into the rid
      (``{rid_prefix}-0042.loose`` / ``.tight``) so benches and gates
      split them without a side channel.
    - The base arrival rate is sized to ``base_load`` x
      ``service_tokens_per_unit`` (comfortably under capacity — spec
      pays off and nothing burns); ``surge = (t0_frac, dur_frac,
      magnitude)`` multiplies the rate over that window of the span,
      pushing demand past capacity so deadlines miss, a
      ``BurnRateRule`` fires, and the overload fallback delivered
      through ``QoSScheduler.note_incident`` parks the spec route
      until the burn recovers.

    Deterministic in every field; JSONL round-trips via
    ``save_trace``/``load_trace`` like every other synthesizer."""
    if not 0.0 < base_load:
        raise ValueError("base_load must be > 0")
    if not 0.0 <= loose_frac <= 1.0:
        raise ValueError("loose_frac must be in [0, 1]")
    t0f, durf, mag = surge
    if not (0.0 <= t0f < 1.0 and 0.0 < durf <= 1.0 and mag >= 1.0):
        raise ValueError("surge is (t0_frac in [0,1), dur_frac in "
                         "(0,1], magnitude >= 1)")
    rng = np.random.default_rng(seed)
    budgets = [int(rng.integers(output_len[0], output_len[1] + 1))
               for _ in range(n_requests)]
    xs = np.linspace(0.0, 1.0, grid)
    shape = np.where((xs >= t0f) & (xs < t0f + durf),
                     float(mag), 1.0)
    mean_f = float(shape.mean())
    # BASE token rate (relative rate 1.0) == base_load * capacity
    span = sum(budgets) \
        / (mean_f * base_load * service_tokens_per_unit)
    times = _profile_times(rng, n_requests, span, shape)
    reqs: List[Request] = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = tuple(int(t) for t in rng.integers(1, vocab_size,
                                                    plen))
        budget = budgets[i]
        loose = bool(rng.random() < loose_frac)
        cohort = "loose" if loose else "tight"
        slack = loose_slack if loose else tight_slack
        chunks = -(-plen // chunk_tokens)
        reqs.append(Request(
            rid=f"{rid_prefix}-{i:04d}.{cohort}",
            arrival=start + float(times[i]), prompt=prompt,
            max_new_tokens=budget,
            priority=0 if loose else 1,
            deadline_ms=round((chunks + budget + 1) * unit_ms
                              * slack, 3)))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def merge_traces(*traces: Sequence[Request]) -> List[Request]:
    """Interleave traces by arrival time (rids must already be unique —
    give each source a distinct ``rid_prefix``)."""
    out = [r for tr in traces for r in tr]
    rids = [r.rid for r in out]
    if len(set(rids)) != len(rids):
        raise ValueError("merge_traces: duplicate rids across traces "
                         "(use distinct rid_prefix per source)")
    return sorted(out, key=lambda r: (r.arrival, r.rid))


def save_trace(path: str, trace: Sequence[Request]) -> None:
    with open(path, "w") as f:
        for r in trace:
            f.write(json.dumps(r.to_json()) + "\n")


def iter_jsonl_tolerant(path: str):
    """Stream a JSONL file's records, tolerating exactly the artifact
    a crashing writer leaves behind: a torn FINAL line warns and ends
    the stream at the valid prefix; a malformed line anywhere EARLIER
    — or a file with NO valid record at all — raises, because those
    mean the file is not what it claims, not that a writer died.
    One-record lookahead, so a 10^5-line incident log never
    materializes in memory. Shared by ``load_trace``,
    ``engine.load_engine_log`` and any future crash-tolerant loader."""
    import warnings
    prev = None  # (line number, text) not yet parsed
    n_ok = 0
    with open(path) as f:
        for i, raw in enumerate(f, 1):
            ln = raw.strip()
            if not ln:
                continue
            if prev is not None:
                try:
                    d = json.loads(prev[1])
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{path}: malformed JSONL at line {prev[0]} "
                        f"(not just a torn tail): {e}") from e
                n_ok += 1
                yield d
            prev = (i, ln)
    if prev is not None:
        try:
            d = json.loads(prev[1])
        except json.JSONDecodeError as e:
            if n_ok == 0:
                # nothing valid precedes the bad line: that is not a
                # torn tail, it is the wrong file — an empty "prefix"
                # has no evidentiary value and returning it silently
                # would let a mispointed path replay as an empty log
                raise ValueError(
                    f"{path}: no valid JSONL record (first line is "
                    f"malformed): {e}") from e
            warnings.warn(
                f"{path}: final JSONL line (line {prev[0]}) is "
                f"truncated — returning the {n_ok} valid records "
                f"before it (crash-written log?)")
            return
        yield d


def load_trace(path: str) -> List[Request]:
    """Load a ``save_trace`` JSONL. A torn FINAL line (the file a
    crashing writer leaves behind) loads with a warning and returns
    the valid prefix; a malformed line anywhere earlier still raises —
    that file is not a trace."""
    return [Request.from_json(d) for d in iter_jsonl_tolerant(path)]


def trace_stats(trace: Sequence[Request]) -> dict:
    """The shape summary a bench row carries next to its numbers."""
    if not trace:
        return {"n_requests": 0}
    plens = np.asarray([len(r.prompt) for r in trace])
    budgets = np.asarray([r.max_new_tokens for r in trace])
    arr = np.asarray([r.arrival for r in trace])
    out = {
        "n_requests": len(trace),
        "prompt_len_min": int(plens.min()),
        "prompt_len_max": int(plens.max()),
        "prompt_tokens": int(plens.sum()),
        "output_budget_tokens": int(budgets.sum()),
        "span": round(float(arr.max() - arr.min()), 4),
        "shared_prefix_requests": sum(
            1 for r in trace if r.prefix_group is not None),
        "churn_requests": sum(
            1 for r in trace if r.cancel_after is not None),
    }
    tenants = sorted({r.tenant for r in trace if r.tenant is not None})
    if tenants:
        out["tenants"] = tenants
    n_deadline = sum(1 for r in trace if r.deadline_ms is not None)
    if n_deadline:
        out["deadline_requests"] = n_deadline
    adapters = sorted({r.adapter for r in trace
                       if r.adapter is not None})
    if adapters:
        # only adapter-carrying traces grow these keys (adapter-less
        # stats stay byte-identical)
        out["adapters"] = adapters
        out["adapter_requests"] = sum(
            1 for r in trace if r.adapter is not None)
    sessions = sorted({r.session for r in trace
                       if r.session is not None})
    if sessions:
        # only session-carrying traces grow these keys (one-shot
        # trace stats stay byte-identical)
        out["sessions"] = len(sessions)
        out["session_turns"] = sum(
            1 for r in trace if r.session is not None)
    schemas = sorted({r.schema for r in trace
                      if r.schema is not None})
    if schemas:
        # only schema-carrying traces grow these keys (free-running
        # trace stats stay byte-identical)
        out["schemas"] = schemas
        out["schema_requests"] = sum(
            1 for r in trace if r.schema is not None)
    return out
