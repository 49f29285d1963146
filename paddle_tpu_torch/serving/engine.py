"""Continuous-batching serving engine over the dense/paged decode stack,
in the PyTorch port.

Counterpart of ``paddle_tpu/serving/engine.py``, carried over whole: the
layer between a request stream and the decode programs,

  arrive -> (admission window) -> route -> prefill -> decode slots
         -> complete / evict, pages freed for the next request.

One engine, two execution backends, one policy seam:

- **paged** (continuous batching): per-request chunked prefill into the
  paged KV pool, then ONE fixed-shape decode step (the paged-attention
  kernel on the card) for whatever mix of requests occupies the slots —
  tables and lengths are data. Shared prompt prefixes ride the pool's
  refcounted prefix cache (acquire before allocate, register after
  prefill) and skip their cached prefill chunks.
- **dense** (wave batching): a uniform admission wave runs on the dense
  cache as one batch — prefill + per-token decode steps.
- **policy**: ``RoutedPolicy`` (default) delegates to
  ``route_decode``/``_Serving.pick`` per admission wave and logs WHICH
  rule fired; ``FixedPolicy`` pins one backend. Policies are pluggable
  objects — a custom one needs only ``route(wave, ctx)``.

Admission takes ``inference.BatchingConfig`` (max_batch + max_delay).

Time is VIRTUAL: the clock advances by the measured wall duration of
each backend call up to its result on the card (``clock="measured"``) or
by fixed per-action costs (``clock="fixed"``, the deterministic test
mode: same trace -> same completion order, timestamps, slot occupancy).

The engine runs on its factory's device (``cuda`` unless the factory was
built with ``device="cpu"``). Not ported yet, and refused by name in the
constructor: ``tp``, ``adapters`` / ``lora``, ``spec`` / ``spec_draft``,
``grammar`` / ``grammar_config`` / ``adapter_schemas``,
``kv_quant="pressure"`` / ``kv_quant_budget``, ``hostmem``,
``ragged_prefill`` and ``dispatch_ahead`` (ROADMAP item 11), and the
handoff transforms ``reshard_kv_pages``, ``repage_kv_pages`` and
``transcode_kv_pages``. Their branches stay in the code.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..inference import BatchingConfig
from ..obs import ledger as obs_ledger
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..models.nlp.llama_decode import (_leaves, _tree_map,
                                       as_grammar_config,
                                       as_lora_config,
                                       as_spec_config, as_tp_config,
                                       llama_serving_decode_factory,
                                       repage_kv_data, route_decode,
                                       transcode_kv_data,
                                       tree_device_bytes)
from ..ops.paged_attention import PagedKVCache
from .adapters import AdapterCache, AdapterStore
from .grammar import GrammarCache, GrammarStore, TokenVocab
from .hostmem import HostArena, as_hostmem_config
from .metrics import MetricsCollector
from .scheduler import QoSScheduler, ServiceEstimator
from .workload import Request, iter_jsonl_tolerant


def _block_until_ready(out):
    """Wait for the card to finish what ``out`` depends on: one
    synchronize per CUDA device among its tensors; host data (numpy,
    CPU tensors) waits for nothing."""
    for dev in {a.device for a in _leaves(out)
                if isinstance(a, torch.Tensor) and a.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def _host(x):
    """A backend's output as a numpy array: tensors come to the host
    (bfloat16 as float32, which numpy lacks); host data passes
    through."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


class EngineClock:
    """Virtual time. ``measured``: each timed action adds its wall
    duration up to its result on the card (``_block_until_ready``).
    ``fixed``: each action adds ``costs[kind]`` (default 1.0) — fully
    deterministic."""

    def __init__(self, mode: str = "measured", costs: dict | None = None):
        if mode not in ("measured", "fixed"):
            raise ValueError(f"clock {mode!r}: use 'measured' or 'fixed'")
        self.mode = mode
        self.costs = costs or {}
        self.t = 0.0
        # measured mode: cumulative wall seconds spent inside timed
        # actions (the run's device-dispatch time, read by the engine's
        # host-overhead decomposition); fixed mode never touches it
        self.dev_wall = 0.0

    def now(self) -> float:
        return self.t

    def advance_to(self, t: float):
        self.t = max(self.t, t)

    def timed(self, kind: str, fn, units: Optional[int] = None,
              cost: Optional[float] = None):
        """``units`` (work items, e.g. prefill chunks computed) prices
        a fixed-clock action per unit WHEN the cost table carries a
        ``<kind>_unit`` entry — the honest clock for prefix caching,
        where a cache hit skips real work. ``units=0`` (a call that
        computes NOTHING — e.g. a fully-cached prefill) is free on the
        fixed clock even without a per-unit entry: zero work priced at
        the flat per-call cost would charge for compute that never
        ran. ``cost`` (fixed clock only) overrides the table outright
        — the async prefill lane uses it to split a flat per-call
        prefill cost evenly across a prompt's chunk calls, so running
        N bounded calls instead of one monolithic call charges the
        SAME total. A ragged-fused call passes a LIST of per-chunk
        costs (one flat split per row advanced) and is charged their
        SUM — k chunks fused into one program price identically to k
        sequential chunk calls, never re-multiplied or discounted.
        Without units/cost the flat per-call cost keeps legacy replays
        bit-identical; a measured clock always charges wall time."""
        if self.mode == "fixed":
            out = fn()
            if cost is not None:
                self.t += float(sum(cost)) \
                    if isinstance(cost, (list, tuple)) else float(cost)
            elif units is not None and (units == 0
                                        or f"{kind}_unit"
                                        in self.costs):
                self.t += float(self.costs.get(f"{kind}_unit", 0.0)) \
                    * units
            else:
                self.t += float(self.costs.get(kind, 1.0))
            return out
        t0 = time.perf_counter()
        out = fn()
        _block_until_ready(out)
        dt = time.perf_counter() - t0
        self.t += dt
        self.dev_wall += dt
        return out


class _LedgerClock(EngineClock):
    """An ``EngineClock`` that books every priced delta on a
    ``CostLedger``. Attribution is pushed onto the clock by ``_timed``
    immediately before the call (``push_attr``) and consumed by
    exactly one ``timed``; a priced call that reaches the clock with
    no attribution lands in the ledger's ``unattributed`` bucket,
    which the conservation audit requires to be zero. ``advance_to``
    books the idle jump, so per engine
    ``sum(attributed) + idle == elapsed`` exactly — the arithmetic of
    the wrapped clock is untouched (super() does all of it), so a
    ledger-armed replay's outputs stay byte-identical."""

    def __init__(self, mode, costs, ledger, label: str):
        super().__init__(mode, costs)
        self._ledger = ledger
        self.label = label
        self._attr = None

    def push_attr(self, rid=None, rids=None, weights=None):
        self._attr = (rid, rids, weights)

    def timed(self, kind, fn, units=None, cost=None):
        t0 = self.t
        out = super().timed(kind, fn, units, cost)
        attr, self._attr = self._attr, None
        dt = self.t - t0
        if attr is None:
            self._ledger.charge(self.label, kind, dt)
        else:
            rid, rids, weights = attr
            if rids:
                self._ledger.charge(self.label, kind, dt, rids=rids,
                                    weights=weights)
            else:
                self._ledger.charge(self.label, kind, dt,
                                    rid=rid if rid is not None
                                    else "engine")
        return out

    def advance_to(self, t):
        t0 = self.t
        super().advance_to(t)
        if self.t > t0:
            self._ledger.idle(self.label, self.t - t0)


class DecodeError(RuntimeError):
    """An exception raised from inside one decode slot's turn —
    ``rid`` names the row whose computation failed. The session's
    drive loop catches it, tears down exactly that row (pages freed,
    slot released, metrics record and trace root moved out — the
    request fails over, it is not lost) and leaves every other row's
    stream untouched. Anything raising from a decode turn that is NOT
    a DecodeError still propagates: an unattributable backend failure
    must stay loud."""

    def __init__(self, rid: str, msg: Optional[str] = None):
        super().__init__(msg or f"decode failed for row {rid!r}")
        self.rid = rid


class UnstampedHandoffError(ValueError):
    """A ``KVHandoff`` reached placement or import WITHOUT its source
    geometry stamped (``page_size``/``tp`` at their vacuous dataclass
    defaults). Every exporter stamps real geometry + codec
    (``_handoff_sink``); an unstamped handoff means hand-built plumbing
    skipped it, and silently matching it against candidates would
    either transform against garbage or — the pre-hetero failure —
    match nothing and quietly fail every request. Refuse loudly
    instead."""

    def __init__(self, h, msg: Optional[str] = None):
        rid = getattr(getattr(h, "req", None), "rid", None)
        super().__init__(msg or (
            f"handoff {rid!r} is unstamped (page_size="
            f"{getattr(h, 'page_size', None)!r}, "
            f"tp={getattr(h, 'tp', None)!r}) — the exporter must "
            "stamp real source geometry/tp/codec before a handoff "
            "can be placed or imported"))
        self.rid = rid


class Policy:
    """Routes one admission wave. ``ctx`` carries the wave statistics
    (lengths, capacity, shared_prefix, expect_churn) plus engine state
    (active_paged). Returns (backend, reason)."""

    name = "base"

    def route(self, wave: List[Request], ctx: dict):
        raise NotImplementedError

    def spec_route(self, r: Request, cfg) -> Tuple[bool, str]:
        """The PER-REQUEST adaptive speculative rule (``RoutedPolicy``
        applies it on a spec-configured engine; every policy shares
        this default, and a custom policy may override it): a request
        decodes speculatively only when its traffic can absorb a
        missed draft — low priority AND a loose (or absent) deadline.
        Tight/high-priority rows keep the plain fixed-latency decode
        path regardless of how well the draft is doing. Returns
        (eligible, rule) with the clause that fired, the same
        ``explain=`` discipline as ``route_decode``."""
        if r.priority > cfg.max_priority:
            return False, (f"priority {r.priority} > spec ceiling "
                           f"{cfg.max_priority} (latency-critical "
                           "traffic decodes plain)")
        if r.deadline_ms is not None \
                and r.deadline_ms < cfg.loose_deadline_ms:
            return False, (f"deadline {r.deadline_ms}ms < loose "
                           f"floor {cfg.loose_deadline_ms}ms (a "
                           "tight deadline cannot absorb a missed "
                           "draft window)")
        return True, "loose-deadline/low-priority (spec-eligible)"


class FixedPolicy(Policy):
    """Everything to one backend — the bench's ablation arms."""

    def __init__(self, backend: str):
        if backend not in ("dense", "paged"):
            raise ValueError(f"backend {backend!r}")
        self.backend = backend
        self.name = backend

    def route(self, wave, ctx):
        return self.backend, f"fixed policy ({self.backend}-only)"


class RoutedPolicy(Policy):
    """The default: delegate to ``route_decode`` (the chip-measured
    policy behind ``_Serving.pick``), with one engine-level rule layered
    on top — a wave arriving while paged requests are mid-flight joins
    the running batch rather than stalling it behind a dense wave (one
    chip serializes programs; parking N streaming requests to run a
    wave start-to-finish would torch their TPOT)."""

    name = "routed"

    def route(self, wave, ctx):
        if ctx.get("active_paged", 0) > 0:
            return "paged", ("join-active-batch (paged requests "
                             "mid-flight; a dense wave would stall "
                             "their token streams)")
        return route_decode([len(r.prompt) for r in wave],
                            ctx["capacity"],
                            shared_prefix=ctx["shared_prefix"],
                            expect_churn=ctx["expect_churn"],
                            explain=True)


def make_policy(spec) -> Policy:
    if isinstance(spec, Policy):
        return spec
    if spec == "routed":
        return RoutedPolicy()
    return FixedPolicy(spec)


def _coerce_paged_only(policy, what: str, why: str):
    """Paged-only feature coercion (tensor parallelism, adapter
    multiplexing): the routed policy — string OR instance — coerces
    to the paged fixed policy, and an explicitly dense one is a
    configuration error at construction, not a NotImplementedError
    mid-serve. A custom Policy object is the caller's responsibility
    to keep paged-only."""
    if policy == "routed" or isinstance(policy, RoutedPolicy):
        return "paged"
    if policy == "dense" or (isinstance(policy, FixedPolicy)
                             and policy.backend == "dense"):
        raise ValueError(f"policy='dense' {what}: {why}")
    return policy


@dataclasses.dataclass
class ServeResult:
    policy: str
    outputs: Dict[str, List[int]]   # rid -> generated tokens (in order)
    metrics: MetricsCollector
    decisions: List[dict]           # one per admission wave
    slot_log: List[tuple]           # (t, "acquire"|"release", rid, slot)
    prefix_cached: Dict[str, int]   # rid -> prompt tokens prefix-cache hit
    pages_total: int
    pages_free_end: int             # RECLAIMABLE pages at run end:
    # free list + evictable LRU (a retained prefix page is capacity,
    # not a leak — it frees itself under allocation pressure)
    scheduler: str = "fifo"         # admission discipline that ran
    shed: Dict[str, str] = dataclasses.field(default_factory=dict)
    # rid -> shed reason (QoS scheduler only; FIFO never sheds)
    trace: Optional[object] = None  # obs.Tracer when the run traced
    prefill_tokens: int = 0         # prompt tokens actually prefilled
    # (padded, minus the cache-resumed chunks) across paged admits
    cache_stats: Dict = dataclasses.field(default_factory=dict)
    # PagedKVCache.cache_stats() at run end + "invariant_ok": the
    # resident+evictable+free == pool-size census, sampled every
    # engine turn
    replica: Optional[str] = None   # cluster replica name (a lone
    # engine leaves it None and its logs stay byte-identical)
    incidents: Optional[List] = None  # obs.slo.Incident list when the
    # run carried an SLO monitor; None otherwise. Never serialized by
    # save_log — monitor-on logs stay byte-identical to monitor-off
    # (the obs_slo gate's identity clause); the incident JSONL is the
    # monitor's own IncidentLog.save
    adapter_stats: Optional[Dict] = None  # AdapterCache.cache_stats()
    # + "invariant_ok" (the ADAPTER slot census alone, sampled every
    # engine turn — independent of cache_stats' pool flag, so each
    # census names its own subsystem) when the run served adapters;
    # None single-model — the result shape every pre-adapter consumer
    # sees is unchanged
    spec_stats: Optional[Dict] = None  # the speculative route's
    # per-run evidence (rounds, draft tokens proposed/accepted,
    # acceptance EWMA, and the deterministic flip log with explain
    # rules) when the engine carried spec=; None otherwise — the
    # result shape every pre-spec consumer sees is unchanged
    kv_quant_stats: Optional[Dict] = None  # the quantized page
    # tier's per-run evidence (mode, quantized-page count, the
    # stored-byte census, and under 'pressure' the deterministic
    # actuation flip log + pages compacted) when the engine carried
    # kv_quant=; None otherwise — the result shape every pre-quant
    # consumer sees is unchanged
    overhead: Optional[Dict] = None  # measured-clock runs only: the
    # host-overhead decomposition {run_wall_s, device_wall_s,
    # engine_host_frac} — the fraction of run wall time NOT covered by
    # in-flight device work (dispatch-ahead shrinks it). None on fixed
    # clocks and sessions; never serialized by save_log, so logs stay
    # byte-identical either way
    hostmem_stats: Optional[Dict] = None  # the host-DRAM arena tier's
    # per-run evidence (arena census + transfer counts, preempt/restore
    # tallies, spilled-page census) when the engine carried hostmem=;
    # None otherwise — the result shape every pre-hostmem consumer
    # sees is unchanged
    pages_spilled: Optional[int] = None  # pages parked host-side at
    # run end — spilled pages are NOT device capacity (pages_free_end
    # never counts them; spill ≠ leak, the retention rule one
    # tier down), but an offline replay needs the census to balance.
    # None at hostmem=None keeps save_log byte-identical
    grammar_stats: Optional[Dict] = None  # GrammarCache.cache_stats()
    # + "invariant_ok" (the grammar slot census alone — resident +
    # evictable + free == n_slots-1, sampled every engine turn) when
    # the run served constrained streams; None at grammar=None — the
    # result shape every pre-grammar consumer sees is unchanged
    cost_stats: Optional[Dict] = None  # obs.ledger.CostLedger
    # cost_stats() for this engine's book (elapsed/idle/attributed
    # unit totals, per-kind breakdown, page-turn integral, and the
    # two conservation-audit flags) when the run carried ledger=;
    # None otherwise — never serialized by save_log, so ledger-on
    # logs stay byte-identical to ledger-off

    def report(self, **slo) -> dict:
        return self.metrics.report(**slo)

    def save_log(self, path: str) -> str:
        """Dump the engine's decision + slot + shed log as JSONL, so an
        overload incident can be replayed offline (``load_engine_log``
        round-trips it). One ``meta`` line, then one line per wave
        decision, slot acquire/release, and shed. A cluster replica's
        result stamps its ``replica`` name on EVERY record, so logs
        from N replicas can be concatenated into one cluster incident
        file without losing attribution; with ``replica`` unset
        (single-engine runs) the format is byte-identical to the plain engine.

        The write is ATOMIC (tmp + ``os.replace``, the same discipline
        as ``framework/io.py`` ``save``): a crash or serialization
        error mid-dump can never leave a truncated file where the
        previous incident log used to be."""
        tag = {} if self.replica is None else {"replica": self.replica}
        # spilled-page census joins the meta line ONLY on hostmem runs
        # (key absent otherwise — legacy logs stay byte-identical)
        spill = {} if self.pages_spilled is None \
            else {"pages_spilled": self.pages_spilled}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({
                    "kind": "meta", "policy": self.policy,
                    "scheduler": self.scheduler,
                    "pages_total": self.pages_total,
                    "pages_free_end": self.pages_free_end,
                    **spill, **tag})
                    + "\n")
                for d in self.decisions:
                    f.write(json.dumps({"kind": "decision", **d, **tag})
                            + "\n")
                for t, ev, rid, slot in self.slot_log:
                    f.write(json.dumps({"kind": "slot", "t": t,
                                        "event": ev, "rid": rid,
                                        "slot": slot, **tag}) + "\n")
                for rid, reason in self.shed.items():
                    f.write(json.dumps({"kind": "shed", "rid": rid,
                                        "reason": reason, **tag})
                            + "\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path


def load_engine_log(path: str) -> dict:
    """Parse a ``ServeResult.save_log`` JSONL back into
    ``{"meta", "decisions", "slot_log", "shed"}`` with the engine's
    in-memory types (slot entries as ``(t, event, rid, slot)``
    tuples), so offline analysis sees what the live run saw. Records
    carrying the optional ``replica`` field (cluster logs, possibly
    several replicas' files concatenated) keep it: decisions retain
    their ``replica`` key, slot entries become 5-tuples
    ``(t, event, rid, slot, replica)``, and sheds map
    ``rid -> (reason, replica)``; replica-less logs load exactly as
    before.

    A log whose FINAL line is torn mid-record — the file a crashing
    process leaves behind when the write was not atomic — loads with a
    warning and returns the valid prefix (the incident evidence that
    survived); a malformed line anywhere EARLIER is still a loud
    error, because a mid-file tear means the file is not an engine
    log (``workload.iter_jsonl_tolerant`` is the shared policy)."""
    out: dict = {"meta": None, "decisions": [], "slot_log": [],
                 "shed": {}}
    for d in iter_jsonl_tolerant(path):
        kind = d.pop("kind", None)
        rep = d.get("replica")
        if kind == "meta":
            out["meta"] = d
        elif kind == "decision":
            out["decisions"].append(d)
        elif kind == "slot":
            row = (d["t"], d["event"], d["rid"], d["slot"])
            out["slot_log"].append(row if rep is None
                                   else row + (rep,))
        elif kind == "shed":
            out["shed"][d["rid"]] = d["reason"] if rep is None \
                else (d["reason"], rep)
        else:
            raise ValueError(f"engine log line has unknown kind "
                             f"{kind!r}")
    return out


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item "
                               "11)")


def _jit_cache_size(fn) -> Optional[int]:
    """Entry count of a backend's program cache. The port compiles
    nothing (each call runs eagerly), so there is no cache to count:
    None turns recompile detection off, as it does in the reference for
    any callable that is not a jitted program."""
    return None


class _SpecState:
    """Per-run adaptive state of the speculative route: the measured
    acceptance EWMA, the enable/latch flags, and the deterministic
    flip log. One per ``run()``/session — two seeded replays flip at
    identical virtual times with identical rules."""

    __slots__ = ("cfg", "enabled", "latched", "ewma", "rounds",
                 "samples", "proposed", "accepted", "flips")

    def __init__(self, cfg):
        self.cfg = cfg
        self.enabled = True
        self.latched = False   # acceptance-floor kill: plain for the
        # rest of the run (no spec rounds run -> no new evidence
        # could ever clear it, so the latch is honest, not lazy)
        self.ewma: Optional[float] = None
        self.rounds = 0        # row-rounds (one per row per turn)
        self.samples = 0       # EWMA samples (one per spec TURN) —
        # the min_rounds guard counts THESE: a busy first turn is
        # still one sample, and one unlucky sample must not clear
        # the cold-start guard just because eight rows shared it
        self.proposed = 0
        self.accepted = 0
        self.flips: List[dict] = []

    def note(self, rows: int, proposed: int, accepted: int):
        """One spec TURN's evidence (``rows`` rows each ran one
        draft/verify round). The EWMA samples per turn — per-row
        sampling would weight busy turns quadratically."""
        self.rounds += rows
        self.proposed += proposed
        self.accepted += accepted
        if proposed > 0:
            self.samples += 1
            rate = accepted / proposed
            a = self.cfg.ewma_alpha
            self.ewma = rate if self.ewma is None \
                else (1 - a) * self.ewma + a * rate

    def stats(self) -> dict:
        return {
            "rounds": self.rounds,
            "turns": self.samples,
            "draft_tokens_proposed": self.proposed,
            "draft_tokens_accepted": self.accepted,
            "acceptance_rate": round(
                self.accepted / self.proposed, 4)
            if self.proposed else None,
            "acceptance_ewma": round(self.ewma, 4)
            if self.ewma is not None else None,
            "enabled_end": self.enabled,
            "latched": self.latched,
            "flips": list(self.flips),
        }


class _PagedRow:
    __slots__ = ("req", "slot", "tok", "out", "eff", "done", "t0",
                 "aslot", "spec", "prev", "sprop", "sacc",
                 "gslot", "gname", "gaut", "gstate", "gmasked")

    def __init__(self, req: Request, slot: int, first_tok: int,
                 t0: float = 0.0, aslot: int = 0, spec: bool = False,
                 prev: int = 0, gslot: int = 0,
                 gname: Optional[str] = None, gaut=None,
                 gstate: int = 0):
        self.req = req
        self.slot = slot
        self.tok = first_tok
        self.out = [first_tok]
        self.t0 = t0  # admit time (slot-occupancy span start)
        self.aslot = aslot  # adapter-bank slot (0 = identity)
        self.spec = spec    # spec-eligible (admission-time verdict)
        self.prev = prev    # token at position lengths-1 (the spec
        # draft's two-token feed re-consumes it; plain rows never
        # read it)
        self.sprop = 0      # draft tokens proposed for this row
        self.sacc = 0       # draft tokens accepted for this row
        self.gslot = gslot    # grammar-bank slot (0 = all-allow)
        self.gname = gname    # schema name (None = free-running)
        self.gaut = gaut      # CompiledGrammar (host transition table)
        self.gstate = gstate  # current DFA state (host-advanced per
        # emitted token; the decode batch carries flat_id(gslot,
        # gstate) as jit DATA)
        self.gmasked = 0.0    # sum of per-token masked-vocab fracs
        cancel = req.cancel_after if req.cancel_after is not None \
            else 10 ** 9
        self.eff = min(req.max_new_tokens, cancel)
        self.done = False


class _PrefillingRow:
    """One request in the ASYNC PREFILL LANE: admitted (pages + slot
    reserved, ``book.lengths`` set) but not yet decoding — its prefill
    runs one chunk per lane step, between the engine's decode turns,
    so pending prefill can never monopolize a turn. ``next_chunk`` is
    the absolute chunk index the next lane step computes (the cached
    resume already skipped); when it reaches ``n_chunks`` the request
    enters its decode slot (or exports as a KV handoff on a
    prefill-role session)."""

    __slots__ = ("req", "slot", "t_admit", "n_cached", "resume", "T",
                 "next_chunk", "n_chunks", "run_chunks", "toks", "pt",
                 "skipped", "aslot", "spec", "gslot", "gname", "gaut",
                 "gstate")

    def __init__(self, req: Request, slot: int, t_admit: float,
                 n_cached: int, resume: int, T: int, chunk: int,
                 toks, pt, aslot: int = 0, spec: bool = False,
                 gslot: int = 0, gname: Optional[str] = None,
                 gaut=None, gstate: int = 0):
        self.req = req
        self.slot = slot
        self.t_admit = t_admit
        self.n_cached = n_cached
        self.resume = resume          # chunk-aligned cached skip
        self.T = T                    # padded prompt length
        self.next_chunk = min(resume, T - chunk) // chunk
        self.n_chunks = T // chunk
        # chunks this request actually computes (cache skip excluded)
        # — the denominator for flat-cost-per-chunk pricing
        self.run_chunks = self.n_chunks - self.next_chunk
        self.toks = toks              # (1, T) padded prompt tokens
        self.pt = pt                  # (1, W) page table row
        self.skipped = 0              # times passed over by a shorter
        # entry — the anti-starvation aging counter
        self.aslot = aslot            # adapter-bank slot (0 = identity)
        self.spec = spec              # spec-eligible (admission-time)
        self.gslot = gslot            # grammar-bank slot (0=all-allow)
        self.gname = gname            # schema name (None = free)
        self.gaut = gaut              # CompiledGrammar
        self.gstate = gstate          # DFA state the FIRST emitted
        # token will be masked by (resume-walked for preempted rows)

    def remaining_chunks(self) -> int:
        return self.n_chunks - self.next_chunk


class _AheadState:
    """The dispatch-ahead turn's double buffer: the decode batch
    dispatched at the END of turn t (before turn t's host bookkeeping
    finished), plus the roster FINGERPRINT it was built from. Turn
    t+1 serves the stashed result only when its roster fingerprint
    still matches — any admission, finish, eviction or token change in
    between discards the stash and re-dispatches the identical work,
    so outputs can never diverge. The stash never holds pools: the
    pool buffers were donated through (and rebound at) dispatch time,
    exactly like a synchronous call."""

    __slots__ = ("emits", "fp", "wall0")

    def __init__(self):
        self.emits = None   # stashed decode_n emits (device handle)
        self.fp = None      # roster fingerprint the dispatch assumed
        self.wall0 = 0.0    # perf_counter at dispatch (overlap span)

    def clear(self):
        self.emits = None
        self.fp = None


@dataclasses.dataclass
class KVHandoff:
    """A finished prefill MOVING from a prefill-role worker to a
    decode worker: the prompt's KV page chain (exported from the
    source pool along the page axis), the greedy first token the
    prefill produced, and the timestamps the destination's metrics
    record needs to stay honest (``t_admit`` — the admission that
    actually happened, on the source; ``t_first`` — when the first
    token materialized; ``t_ready`` — when the chain left the source,
    the moment the per-page transfer cost starts ticking). The
    request's metrics record and trace root move WITH the handoff
    (the move-not-duplicate discipline): the source forgets it, the
    destination re-records it, and the cluster census counts it
    exactly once. ``t_arrive`` is stamped by the router:
    ``t_ready + n_pages * kv_transfer_unit`` on the shared timeline.

    ``page_size``/``tp``/``kv_quant`` describe the SOURCE layout of
    ``kv_data``. Since the hetero PR they are no longer placement
    FILTERS: a destination whose geometry/mesh/codec differ runs the
    priced ``kv_reshard``/``kv_repage``/``kv_transcode`` transform
    steps at import (``ServingEngine.handoff_steps`` names which, and
    which pairings still refuse), mutating these stamps to the
    destination's values as each step lands. An exporter that leaves
    them at the vacuous defaults gets an ``UnstampedHandoffError`` at
    placement/import — loudly, never a silent match-nothing."""

    req: Request
    first_tok: int
    n_pages: int                      # exported chain length (pages)
    kv_data: object                   # opaque per-factory page data
    n_cached: int                     # source-side prefix-cache hit
    t_admit: float
    t_first: float
    t_ready: float
    replica_from: Optional[str] = None
    t_arrive: float = 0.0             # router-stamped delivery time
    page_size: int = 0                # source page geometry; a
    # destination on a different geometry re-pages the chain at import
    # (priced kv_repage). 0 = unstamped -> UnstampedHandoffError.
    tp: int = 1                       # source tensor-parallel degree:
    # exported page content is head-sharded over the source mesh; a
    # destination on a different mesh width gathers the shards into
    # the canonical layout at import (priced kv_reshard) and its
    # scatter re-splits under its own pool sharding
    kv_quant: Optional[str] = None    # source kv-quant mode: the
    # exported page data is tier-shaped ('pressure' chains carry the
    # dual-arena slices + tier bits, 'int8' chains carry scales). A
    # full-precision chain transcodes to an int8/pressure destination
    # at import (priced kv_transcode, scales + tier bits stamped);
    # quantized sources only adopt same-codec (handoff_steps refuses
    # the lossy/unliftable pairings)
    layout: str = "head_major"        # canonical-layout descriptor of
    # kv_data: "head_major" — every leaf page-indexed on axis 2 with
    # the kv-head axis whole in the GLOBAL shape (the llama pools,
    # sharded or not: kv_reshard gathers the shards into one host
    # view of this same layout, so the descriptor survives every
    # transform step); "tokens" — the sim's (n_pages, page_size)
    # token rows. Transforms validate against it instead of guessing
    # from array ranks.
    quant_pages: Tuple[int, ...] = () # chain positions (indices into
    # the exported chain, NOT pool page ids) that sat in the int8
    # tier at export — the importer mirrors them into its own
    # bookkeeper so its byte census prices the adopted chain right


class ServingEngine:
    """Replay a trace (workload.Request list) through the serving stack.

    ``slots``: concurrent paged decode rows (the fixed compiled batch
    shape; empty slots ride along as length-0 page-0 rows) and the dense
    routing capacity. ``decode_chunk``: decode steps fused per scheduler
    turn via ``decode_n`` (dispatch amortization; tokens within a chunk
    share a timestamp). ``serving``: a prebuilt
    ``llama_serving_decode_factory(...)`` to share compiled programs
    across engines (its build config must carry ``chunked_prefill`` —
    the prefix-cache resume path needs chunked prefill).
    ``scheduler``: None (FIFO, byte-identical to plain runs), ``"qos"``, or
    a configured ``QoSScheduler`` — the SLO-aware front door (priority
    + weighted-fair admission, deadline feasibility, shedding and
    degradation, timeouts).
    ``trace``: None (tracing off — the default, zero spans recorded),
    an ``obs.Tracer`` (caller keeps the handle; cleared at each run's
    start), or a path string (a fresh tracer exports chrome://tracing
    JSON there after every run). Spans ride the run's VIRTUAL clock:
    request roots on one track per tenant, occupancy on one track per
    decode slot, prefill/decode work on the engine track, scheduler
    decisions + jit recompiles as instants. Outputs, metrics records
    and logs are byte-identical with tracing on or off.
    ``prefix_cache``: True (default) makes prefix reuse AUTOMATIC for
    every paged admit — acquire before allocate, register after
    prefill, no ``prefix_group`` tag needed (the tag stays a routing
    hint only); freed prompt pages are RETAINED in the pool's
    evictable LRU, so a recurring system prompt skips its cached
    prefill chunks even after every earlier sharer finished. False
    disables all acquisition/retention (the bench's cache-off arm).
    """

    # async-lane anti-starvation: the oldest lane entry runs its next
    # chunk after being passed over this many consecutive times by
    # shorter entries, so a long prefill's first token is bounded by
    # ~run_chunks * (limit+1) lane chunks REGARDLESS of how long a
    # sustained short-prompt stream lasts (pure
    # shortest-remaining-first would starve it for the stream's whole
    # lifetime, pinning its slot and pages). The default trades a
    # loose bound for zero short-prompt TTFT tax on the gated
    # prefill-heavy trace; subclasses may tighten it.
    _LANE_STARVE_LIMIT = 11

    def __init__(self, model=None, *, serving=None, slots: int = 4,
                 max_len: int = 64, page_size: int = 8,
                 n_pool_pages: Optional[int] = None, policy="routed",
                 admission: Optional[BatchingConfig] = None,
                 decode_chunk: int = 1, clock: str = "measured",
                 fixed_costs: Optional[dict] = None,
                 eos_token_id: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = None,
                 expect_churn: Optional[bool] = None,
                 scheduler=None, trace=None,
                 prefix_cache: bool = True,
                 prefill_chunk_budget: Optional[int] = None,
                 slo=None, tp=None, adapters=None, lora=None,
                 spec=None, spec_draft=None, kv_quant=None,
                 kv_quant_budget=None, ragged_prefill: bool = False,
                 dispatch_ahead: bool = False, hostmem=None,
                 grammar=None, grammar_config=None,
                 adapter_schemas=None, ledger=None, device=None):
        # Not ported yet: refused by name before anything is built.
        for name, value in (
                ("tp", tp), ("adapters", adapters), ("lora", lora),
                ("spec", as_spec_config(spec)), ("spec_draft", spec_draft),
                ("grammar", grammar), ("grammar_config", grammar_config),
                ("adapter_schemas", adapter_schemas or None),
                ("kv_quant_budget", kv_quant_budget),
                ("hostmem", as_hostmem_config(hostmem)),
                ("ragged_prefill", ragged_prefill or None),
                ("dispatch_ahead", dispatch_ahead or None)):
            if value is not None:
                raise _not_ported(f"ServingEngine({name}=...)")
        if kv_quant == "pressure":
            raise _not_ported("ServingEngine(kv_quant='pressure')")
        # ``device`` (model path only): where the factory puts the
        # weights and pools — ``cuda`` unless ``"cpu"`` is asked for. A
        # prebuilt factory's own device is authoritative.
        # ``tp``: None (byte-identical to the single-device engine —
        # outputs, slot logs, metrics records, registry contents), a
        # TPConfig, or an int degree. With a MODEL it is threaded into
        # the factory build (weights + pools placed once, sharded);
        # with a PREBUILT factory the factory's own tp_ is
        # authoritative — passing a conflicting tp here is an error,
        # because arrays cannot be re-sharded after the build.
        # ``adapters``: None (byte-identical to the single-model
        # engine) or an AdapterStore / {name: deltas} dict — the
        # multi-model LoRA registry. Needs a lora-enabled factory:
        # with a MODEL, pass ``lora=LoRAConfig(...)|(n_slots, rank)``
        # and it is threaded into the build; with a PREBUILT factory
        # the factory's own lora_ is authoritative (conflicts error,
        # like tp). Per-request ``Request.adapter`` names the delta
        # set; adapter weights page host->device through a budgeted
        # ``AdapterCache`` (LRU retention, pin-while-in-flight) and
        # every mix of adapters decodes through ONE fixed-shape
        # compiled batch.
        tp = as_tp_config(tp)
        lora = as_lora_config(lora)
        # ``spec``: None (byte-identical to the plain engine —
        # outputs, slot logs, decisions, metrics records, report
        # keys, registry contents), a SpecConfig, or an int draft
        # window. The SPECULATIVE route: eligible rows (see
        # ``Policy.spec_route``) decode through one batched
        # draft/verify round per turn instead of ``decode_n``, with
        # greedy acceptance keeping every emitted token EXACTLY the
        # target's greedy token; the route falls back to plain decode
        # when the measured acceptance EWMA sinks below the floor or
        # while an overload incident delivered through
        # ``QoSScheduler.note_incident`` stays open. Needs a
        # spec-capable factory: with a MODEL, pass the draft model as
        # ``spec_draft=``; with a PREBUILT factory, build it with
        # ``llama_serving_decode_factory(draft=...)`` (or
        # ``SimServing(spec_accept=...)``). Draft and target share
        # ONE PagedKVCache page-id space — draft K/V lands in its own
        # pool arrays at the target's page ids, so prefix caching and
        # eviction recycle both in lockstep.
        # ``kv_quant``: None (byte-identical to the plain engine —
        # outputs, logs, metrics records, report keys, registry
        # contents), 'int8' (EVERY page stored quantized with
        # per-slot scales — the pool is ~half the fp bytes, so the
        # same HBM budget holds ~2x the pages), or 'pressure' (pages
        # stay full-precision while hot; pages parked in the
        # evictable LRU compact to an int8 tier instead of being
        # freed — under ``kv_quant_budget=`` stored bytes at
        # allocation, and while a ``pool_bytes_per_device``
        # ThresholdRule incident delivered through
        # ``QoSScheduler.note_incident`` stays open). With a MODEL
        # the mode is threaded into the factory build; with a
        # PREBUILT factory the factory's own kv_quant_ is
        # authoritative (conflicts error, like tp/lora).
        # ``grammar``: None (byte-identical to the free-running
        # engine — outputs, slot logs, metrics records, report keys,
        # registry contents) or a GrammarStore / {name: schema-dict |
        # EBNF-str} registry — CONSTRAINED decoding. Needs a
        # grammar-enabled factory: with a MODEL, pass
        # ``grammar_config=GrammarConfig(...)|(n_slots, max_states)``
        # and it is threaded into the build; with a PREBUILT factory
        # the factory's own grammar_ is authoritative (conflicts
        # error, like tp/lora). Per-request ``Request.schema`` names
        # the grammar; compiled automata page into a device mask bank
        # through a budgeted ``GrammarCache`` (LRU retention,
        # pin-while-in-flight) and every mix of constrained and free
        # rows decodes through ONE fixed-shape compiled batch — the
        # per-row DFA state rides as jit data, never a recompile.
        # ``adapter_schemas``: {adapter_name: schema_name} — the
        # per-adapter DEFAULT schema; a request naming that adapter
        # (with Request.schema unset) decodes constrained under it.
        grammar_config = as_grammar_config(grammar_config)
        spec = as_spec_config(spec)
        if serving is None:
            if model is None:
                raise ValueError("pass a model or a prebuilt serving "
                                 "factory")
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} must be a multiple "
                                 f"of page_size {page_size}")
            if spec is not None and spec_draft is None:
                raise ValueError(
                    "spec= with a model needs the draft model too "
                    "(spec_draft=), or pass a prebuilt spec-capable "
                    "factory (llama_serving_decode_factory("
                    "draft=...))")
            if spec_draft is not None and spec is None:
                raise ValueError(
                    "spec_draft= without spec= would build the whole "
                    "draft decode stack (programs + a full-size "
                    "draft KV pool) that nothing ever uses — pass "
                    "spec=SpecConfig(...) (or True) to serve "
                    "speculatively, or drop the draft")
            if n_pool_pages is None:
                # page 0 is the reserved padding page; each slot may
                # need max_len/page_size pages
                n_pool_pages = slots * (max_len // page_size) + 1
            serving = llama_serving_decode_factory(
                model, max_len=max_len, page_size=page_size,
                n_pool_pages=n_pool_pages, kv_cache_dtype=kv_cache_dtype,
                batch_capacity=slots, chunked_prefill=page_size, tp=tp,
                lora=lora, draft=spec_draft, kv_quant=kv_quant,
                grammar=grammar_config, device=device)
        else:
            if spec_draft is not None:
                raise ValueError(
                    "spec_draft= is ignored with a prebuilt factory "
                    "— build it spec-capable instead ("
                    "llama_serving_decode_factory(draft=...) / "
                    "SimServing(spec_accept=...))")
            max_len = serving.max_len_
            page_size = serving.page_size_
            n_pool_pages = serving.n_pool_pages_
            fac_tp = getattr(serving, "tp_", None)
            if tp is not None and fac_tp != tp:
                raise ValueError(
                    f"tp={tp} conflicts with the prebuilt factory's "
                    f"tp_={fac_tp} — a factory's placement is fixed "
                    "at build; pass tp to the factory (or the model "
                    "path) instead")
            tp = fac_tp
            fac_lora = getattr(serving, "lora_", None)
            if lora is not None and fac_lora != lora:
                raise ValueError(
                    f"lora={lora} conflicts with the prebuilt "
                    f"factory's lora_={fac_lora} — the adapter bank "
                    "is sized at build; pass lora to the factory (or "
                    "the model path) instead")
            lora = fac_lora
            fac_q = getattr(serving, "kv_quant_", None)
            if kv_quant is not None and fac_q != kv_quant:
                raise ValueError(
                    f"kv_quant={kv_quant!r} conflicts with the "
                    f"prebuilt factory's kv_quant_={fac_q!r} — the "
                    "page-tier layout is fixed at build; pass "
                    "kv_quant to the factory (or the model path) "
                    "instead")
            kv_quant = fac_q
            if tp is not None:
                raise _not_ported(f"serving a factory with tp_={tp}")
            if kv_quant == "pressure":
                raise _not_ported("serving a factory with "
                                  "kv_quant_='pressure'")
            fac_g = getattr(serving, "grammar_", None)
            if grammar_config is not None and fac_g != grammar_config:
                raise ValueError(
                    f"grammar_config={grammar_config} conflicts with "
                    f"the prebuilt factory's grammar_={fac_g} — the "
                    "mask bank is sized at build; pass grammar_config "
                    "to the factory (or the model path) instead")
        # --- multi-model adapter serving (inert at adapters=None) ---
        self.lora = getattr(serving, "lora_", None)
        if adapters is not None and not isinstance(adapters,
                                                  AdapterStore):
            adapters = AdapterStore(dict(adapters))
        if adapters is not None and self.lora is None:
            raise ValueError(
                "adapters= needs a lora-enabled serving factory "
                "(llama_serving_decode_factory(lora=...) or "
                "SimServing(lora_slots=...)) — the adapter bank is "
                "part of the compiled program's inputs")
        self._adapter_store = adapters
        self._g_adapter_resident = None
        self._ctr_adapter_hits = None
        self._ctr_adapter_uploads = None
        if adapters is not None:
            # created ONLY when multi-model serving is configured, so
            # single-model runs leave no trace in the registry (the
            # clean-registry convention)
            self._g_adapter_resident = obs_metrics.REGISTRY.gauge(
                "serving_adapter_resident",
                "LoRA adapters resident in the device bank "
                "(pinned + retained)")
            self._ctr_adapter_hits = obs_metrics.REGISTRY.counter(
                "serving_adapter_hits_total",
                "adapter admissions served from the resident bank")
            self._ctr_adapter_uploads = obs_metrics.REGISTRY.counter(
                "serving_adapter_uploads_total",
                "host->device adapter delta uploads")
            # multi-model serving is paged-only, exactly like tp: the
            # dense wave cache has no adapter bank
            policy = _coerce_paged_only(
                policy, "with adapters",
                "the dense backend holds no adapter bank")
        # --- constrained decoding (inert at grammar=None) -----------
        self.grammar_cfg = getattr(serving, "grammar_", None)
        if grammar is not None and not isinstance(grammar,
                                                  GrammarStore):
            grammar = GrammarStore(dict(grammar))
        if grammar is not None and self.grammar_cfg is None:
            raise ValueError(
                "grammar= needs a grammar-enabled serving factory "
                "(llama_serving_decode_factory(grammar=...) or "
                "SimServing(grammar_slots=...)) — the mask bank is "
                "part of the compiled program's inputs")
        self._grammar_store = grammar
        # host-side compiled-automaton memo, shared by every run's
        # GrammarCache AND the scheduler's min-tokens probe: one
        # schema compiles ONCE per engine no matter how many runs,
        # sessions or probes touch it
        self._dfa_memo: Dict[str, object] = {}
        self._adapter_schemas: Dict[str, str] = {}
        if adapter_schemas:
            if grammar is None:
                raise ValueError(
                    "adapter_schemas= names default schemas but no "
                    "grammar= registry was given to resolve them")
            if adapters is None:
                raise ValueError(
                    "adapter_schemas= without adapters= — there are "
                    "no adapters to default")
            for a, gname in dict(adapter_schemas).items():
                if a not in adapters:
                    raise ValueError(
                        f"adapter_schemas names unknown adapter "
                        f"{a!r} (registered: {adapters.names()})")
                if gname not in grammar:
                    raise ValueError(
                        f"adapter_schemas[{a!r}] names unknown "
                        f"schema {gname!r} (registered: "
                        f"{grammar.names()})")
            self._adapter_schemas = dict(adapter_schemas)
        self._ctr_grammar_hits = None
        self._ctr_grammar_compiles = None
        if grammar is not None:
            # created ONLY when constrained decoding is configured,
            # so free-running runs leave no trace in the registry
            # (the clean-registry convention)
            self._ctr_grammar_hits = obs_metrics.REGISTRY.counter(
                "serving_grammar_hits_total",
                "constrained admissions served from the resident "
                "mask bank")
            self._ctr_grammar_compiles = obs_metrics.REGISTRY.counter(
                "serving_grammar_compiles_total",
                "grammar automaton compiles + mask-bank uploads")
            # constrained decoding is paged-only, exactly like tp and
            # adapters: the dense wave cache has no grammar mask bank
            policy = _coerce_paged_only(
                policy, "with grammar",
                "the dense backend holds no grammar mask bank")
        # --- speculative serving (inert at spec=None) ---------------
        self.spec = spec
        self._spec_parts = getattr(serving, "spec_parts", None)
        self._ctr_spec_rounds = None
        self._ctr_draft_proposed = None
        self._ctr_draft_accepted = None
        self._ctr_spec_flips = None
        if spec is not None:
            if self._spec_parts is None:
                raise ValueError(
                    "spec= needs a spec-capable serving factory "
                    "(llama_serving_decode_factory(draft=...) or "
                    "SimServing(spec_accept=...)) — the draft "
                    "programs and its paged pool are built with the "
                    "factory")
            if adapters is not None:
                raise ValueError(
                    "spec= does not compose with adapters= yet — the "
                    "draft has no adapter bank (serve spec engines "
                    "single-model)")
            # speculative serving is paged-only, exactly like tp and
            # adapters: the dense wave cache has no draft/verify
            # program
            policy = _coerce_paged_only(
                policy, "with spec",
                "the dense backend holds no draft/verify program")
            if not hasattr(serving, "_live_spec_pools"):
                # the draft pool buffers are DONATED through every
                # draft prefill / spec round, like the target pools —
                # the live buffers ride the shareable serving object
                serving._live_spec_pools = self._spec_parts[2]
            # created ONLY when a spec route is configured, so plain
            # runs leave no trace in the registry (the clean-registry
            # convention)
            _sc = obs_metrics.REGISTRY.counter
            self._ctr_spec_rounds = _sc(
                "serving_spec_rounds_total",
                "speculative draft/verify rounds run (one per spec "
                "row per turn)")
            self._ctr_draft_proposed = _sc(
                "serving_draft_tokens_proposed_total",
                "draft tokens proposed for target verification")
            self._ctr_draft_accepted = _sc(
                "serving_draft_tokens_accepted_total",
                "draft tokens the target verification accepted")
            self._ctr_spec_flips = {
                to: _sc("serving_spec_flips_total",
                        "adaptive spec-route flips by direction",
                        to=to)
                for to in ("plain", "spec")}
        self.tp = tp
        self.tp_size = tp.size if tp is not None else 1
        if tp is not None:
            # tensor-parallel serving is paged-only (no dense replica
            # exists — see llama_decode.PagedOnlyDense)
            policy = _coerce_paged_only(
                policy, "under tp",
                "a sharded factory holds no dense replica")
        # --- quantized paged KV (inert at kv_quant=None) ------------
        # 'int8': EVERY page stored as (int8, per-slot scale) — the
        # pool arrays are physically ~half the fp bytes, decode reads
        # through the existing dequant path. 'pressure': pages stay
        # full-precision while hot; pages parked in the evictable LRU
        # are COMPACTED to the int8 tier instead of freed — under a
        # byte budget (kv_quant_budget=) at allocation, and whenever a
        # pool_bytes_per_device incident delivered through
        # QoSScheduler.note_incident stays open (capacity degradation
        # one rung BEFORE any shedding tier). kv_quant=None is
        # byte-identical to every earlier PR.
        if kv_quant not in (None, "int8", "pressure"):
            raise ValueError(f"kv_quant {kv_quant!r}: use None, "
                             "'int8' or 'pressure'")
        self.kv_quant = kv_quant
        if kv_quant_budget is not None:
            if kv_quant != "pressure":
                raise ValueError(
                    "kv_quant_budget= only means something under "
                    "kv_quant='pressure' (the stored-byte ceiling "
                    "allocation-time compaction defends); an "
                    "always-int8 pool is already small")
            if kv_quant_budget <= 0:
                raise ValueError("kv_quant_budget must be > 0 bytes")
        self.kv_quant_budget = kv_quant_budget
        self._ctr_compactions = None
        self._ctr_quant_flips = None
        if kv_quant == "pressure":
            if spec is not None:
                raise ValueError(
                    "kv_quant='pressure' does not compose with spec= "
                    "— the draft pool rides the target's page ids "
                    "but carries no page-tier mask (use "
                    "kv_quant='int8')")
            if tp is not None:
                raise ValueError(
                    "kv_quant='pressure' does not compose with tp= — "
                    "the (P,) page-tier mask is a whole-pool jit "
                    "input with no kv-head axis to shard (use "
                    "kv_quant='int8')")
            # pressure-tier serving is paged-only, exactly like tp:
            # the dense wave cache has no page tiers to compact
            policy = _coerce_paged_only(
                policy, "under kv_quant='pressure'",
                "the dense wave cache has no page tiers")
            # created ONLY when the pressure tier is configured, so
            # plain and always-int8 runs leave no trace of them in
            # the registry (the clean-registry convention)
            _qc = obs_metrics.REGISTRY.counter
            self._ctr_compactions = _qc(
                "serving_kv_compactions_total",
                "parked full-precision pages compacted to the int8 "
                "tier")
            self._ctr_quant_flips = {
                to: _qc("serving_kv_quant_flips_total",
                        "pressure-tier actuation flips by direction",
                        to=to)
                for to in ("on", "off")}
        if serving.chunked_prefill_ is None:
            raise ValueError("the engine needs a chunked-prefill paged "
                             "backend (llama_serving_decode_factory("
                             "chunked_prefill=<page multiple>)) — "
                             "prefix-cache resume skips whole chunks")
        dense_parts = serving.dense._parts
        if dense_parts.get("rolling"):
            raise ValueError("dense wave batching over a rolling "
                             "(sliding-window) cache is unsupported")
        self.serving = serving
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.n_pool_pages = n_pool_pages
        self.W = max_len // page_size  # fixed page-table width
        self.chunk_C = serving.chunked_prefill_
        if clock not in ("measured", "fixed"):
            raise ValueError(f"clock {clock!r}: use 'measured' or "
                             "'fixed'")
        self.policy = make_policy(policy)
        # scheduler=None is the FIFO default and replays plain traces
        # BYTE-IDENTICALLY (the determinism promise above); "qos" or a
        # QoSScheduler instance routes runs through the QoS front door
        if scheduler == "qos":
            scheduler = QoSScheduler()
        if scheduler is not None and not hasattr(scheduler, "select"):
            raise ValueError("scheduler must be None, 'qos', or a "
                             "QoSScheduler-like object with "
                             "enqueue/select/commit")
        self.scheduler = scheduler
        if spec is not None and spec.overload_fallback \
                and scheduler is not None \
                and hasattr(scheduler, "track_overload"):
            # arm the declared overload seam: note_incident then
            # tracks open page-severity incidents so the spec gate's
            # overload_active() probe answers — tracked only when a
            # consumer is armed (the hardening discipline)
            scheduler.track_overload = True
        if kv_quant == "pressure" and scheduler is not None \
                and hasattr(scheduler, "track_pressure"):
            # same seam, one rung lower: note_incident then tracks
            # open pool_bytes_per_device incidents so the pressure
            # gate's pressure_active() probe answers — compaction
            # fires before any shedding tier would
            scheduler.track_pressure = True
        if grammar is not None and scheduler is not None \
                and hasattr(scheduler, "grammar_min_tokens"):
            # arm the degrade floor: a constrained stream is never
            # clamped below its automaton's shortest-accept length —
            # armed only when a consumer exists (the armed-only
            # discipline), so grammar-less schedulers are untouched
            scheduler.grammar_min_tokens = self._grammar_floor
        self.admission = admission or BatchingConfig()
        self._trace_spec = trace
        # ``slo``: None (off — zero monitor work, the default), an
        # obs.slo.SLOMonitor (caller keeps the handle and its
        # IncidentLog), or a sequence of SLO rules (a FRESH monitor is
        # built per run; its incidents land on ServeResult.incidents).
        # The monitor observes the run through MetricsCollector's
        # finish/shed/queue-depth feed — it never touches engine
        # state, so outputs/logs/records are byte-identical either way.
        if slo is not None and not isinstance(
                slo, (obs_slo.SLOMonitor, list, tuple)):
            raise ValueError("slo must be None, an SLOMonitor, or a "
                             "sequence of SLO rules")
        self._slo_spec = slo
        # obs counters prefetched once: the per-event hot path is then
        # one enabled-check + add (the <= 2% tracing-off overhead gate,
        # tools/bench_gate.py obs, prices exactly this)
        _c = obs_metrics.REGISTRY.counter
        self._ctr_arrived = _c("serving_requests_arrived_total",
                               "requests entering the engine")
        self._ctr_tokens = _c("serving_tokens_generated_total",
                              "tokens emitted across all requests")
        self._ctr_shed = _c("serving_requests_shed_total",
                            "requests rejected by the scheduler")
        self._ctr_finished = {
            o: _c("serving_requests_finished_total",
                  "finished requests by outcome", outcome=o)
            for o in ("completed", "cancel", "timeout")}
        self._ctr_compiles = _c("serving_jit_compiles_total",
                                "jit program-cache compiles observed "
                                "by the engine")
        self._ctr_prefix_hits = _c("serving_prefix_hit_tokens_total",
                                   "prompt tokens served from the "
                                   "prefix cache")
        self._ctr_prefix_evictions = _c(
            "serving_prefix_evictions_total",
            "prefix pages reclaimed from the evictable LRU pool")
        self._g_resident = obs_metrics.REGISTRY.gauge(
            "serving_prefix_resident_pages",
            "pool pages held by live sequences")
        self.prefix_cache = bool(prefix_cache)
        # --- async prefill lane (the disaggregation seam) -----------
        # None: legacy interleaved loop — a wave's whole prefill runs
        # at admission, byte-identical to every earlier PR. An int
        # >= 1: admitted requests park in the PREFILL LANE and each
        # engine turn runs the fixed-shape decode batch FIRST, then at
        # most this many prefill chunks — TPOT becomes independent of
        # how much prefill is queued (the DistServe/Splitwise split,
        # in-engine). Requests enter decode slots only when their
        # prefill completes; page/slot accounting and greedy tokens
        # are unchanged (each chunk computes exactly what the
        # monolithic prefill computed for those positions).
        if prefill_chunk_budget is not None and prefill_chunk_budget < 1:
            raise ValueError("prefill_chunk_budget must be >= 1 chunks "
                             "per turn (or None for the interleaved "
                             "legacy loop)")
        self.prefill_chunk_budget = prefill_chunk_budget
        self._g_lane_depth = None
        if prefill_chunk_budget is not None:
            # created ONLY when the lane exists, so pre-disagg runs
            # leave no trace of it in the registry (the clean-registry
            # convention)
            self._g_lane_depth = obs_metrics.REGISTRY.gauge(
                "serving_prefill_lane_depth",
                "requests parked in the async prefill lane")
        # --- ragged batched prefill (one program per lane turn) -----
        # False: the lane runs ONE bounded call per request-chunk —
        # byte-identical to every earlier PR. True: each lane turn
        # fuses every parked request's next pending chunk into ONE
        # fixed-shape ragged dispatch (per-row offsets/lengths ride as
        # jit data, so the program cache stays flat across admission
        # mixes); ``prefill_chunk_budget`` then bounds fused DISPATCHES
        # per turn, each advancing the whole lane one chunk. Greedy
        # tokens, page accounting and fixed-clock pricing are unchanged
        # (a fused dispatch of k chunks prices as k chunk calls).
        self.ragged_prefill = bool(ragged_prefill)
        self._p_prefill_ragged = None
        if self.ragged_prefill:
            if prefill_chunk_budget is None:
                raise ValueError(
                    "ragged_prefill=True fuses the async prefill "
                    "lane's pending chunks; pass prefill_chunk_budget "
                    ">= 1 to enable the lane")
            rg = getattr(serving, "prefill_ragged", None)
            if rg is None:
                raise ValueError(
                    "ragged_prefill=True needs a factory that "
                    "advertises prefill_ragged (built with "
                    "chunked_prefill and gather-path prefill "
                    "attention); this factory does not")
            self._p_prefill_ragged = rg
        # --- dispatch-ahead decode turn -----------------------------
        # False: strictly sequential turns (dispatch -> host
        # bookkeeping -> dispatch) — byte-identical to every earlier
        # PR. True: after a decode turn's readback, the NEXT turn's
        # decode batch is dispatched immediately from the post-update
        # slot state, so the device computes while Python routes; the
        # stashed result is served only when the roster fingerprint
        # still matches (any admission/finish/eviction discards it and
        # re-dispatches the identical work). Virtual clocks price the
        # served work exactly as a fresh dispatch, so fixed-clock runs
        # are byte-identical with the flag on; the win is measured
        # wall time.
        self.dispatch_ahead = bool(dispatch_ahead)
        if self.dispatch_ahead and spec is not None:
            raise ValueError(
                "dispatch_ahead=True cannot compose with spec=: "
                "speculative rows decode through a different program "
                "mid-roster, so a dispatched-ahead plain batch would "
                "be stale by construction")
        if self.dispatch_ahead and kv_quant is not None:
            raise ValueError(
                "dispatch_ahead=True cannot compose with kv_quant=: "
                "pressure/int8 tier moves rewrite pool pages between "
                "turns underneath a dispatched-ahead batch")
        if self.dispatch_ahead and grammar is not None:
            raise ValueError(
                "dispatch_ahead=True cannot compose with grammar=: "
                "a constrained row's next mask depends on the token "
                "the CURRENT turn emits, so a dispatched-ahead batch "
                "would mask with a stale DFA state by construction")
        # --- host-DRAM offload arena (inert at hostmem=None) --------
        # None: capacity ends at HBM, byte-identical to every earlier
        # PR (outputs, slot logs, records, report keys, registry).
        # An int byte budget or HostMemConfig arms the THIRD memory
        # tier: pages parked in the evictable LRU spill to a budgeted
        # host arena instead of dying when allocate() recycles them,
        # prefix hits on spilled chains page back in at priced
        # kv_pagein/kv_pageout transfers, and under a QoS scheduler
        # the engine gains the rung between degrade and shed —
        # PREEMPT: swap a low-priority running row's chain out,
        # requeue it with its emitted tokens, swap back in on
        # re-admission.
        self.hostmem = as_hostmem_config(hostmem)
        self._ctr_pageouts = None
        self._ctr_pageins = None
        self._ctr_preempts = None
        self._ctr_restores = None
        if self.hostmem is not None:
            if spec is not None:
                raise ValueError(
                    "hostmem= does not compose with spec= — the "
                    "draft pool rides the target's page ids but "
                    "spills no draft K/V, so a paged-in chain would "
                    "hand the draft a holed cache")
            if self.dispatch_ahead:
                raise ValueError(
                    "hostmem= cannot compose with dispatch_ahead=: "
                    "page-ins and preemption swaps rewrite pool "
                    "pages between turns underneath a "
                    "dispatched-ahead batch")
            # the arena tier is paged-only, exactly like tp: the
            # dense wave cache has no page pool to spill from
            # (self.policy was already built above — rebuild it from
            # the coerced spec)
            policy = _coerce_paged_only(
                policy, "with hostmem",
                "the dense wave cache has no page pool to spill")
            self.policy = make_policy(policy)
            if scheduler is not None \
                    and hasattr(scheduler, "track_preempt"):
                # arm the preempt rung: the scheduler's victim picker
                # answers only when a swap target exists (the
                # tracked-only-when-armed discipline)
                scheduler.track_preempt = True
            # created ONLY when the arena is configured, so
            # HBM-only runs leave no trace in the registry (the
            # clean-registry convention)
            _hc = obs_metrics.REGISTRY.counter
            self._ctr_pageouts = _hc(
                "serving_kv_pageouts_total",
                "device pages spilled to the host arena")
            self._ctr_pageins = _hc(
                "serving_kv_pageins_total",
                "host arena pages restored into the device pool")
            self._ctr_preempts = _hc(
                "serving_preemptions_total",
                "running rows swapped out to the host arena by the "
                "QoS preempt rung")
            self._ctr_restores = _hc(
                "serving_preempt_restores_total",
                "preempted rows re-admitted with their chain swapped "
                "back in")
        self.decode_chunk = decode_chunk
        # page-footprint slack beyond prompt+budget: the deepest
        # write a decode turn can land. Plain decode_n writes at most
        # decode_chunk positions past the last emitted token; a spec
        # round's verify block writes n_draft+1 (rejected proposals
        # included — overwritten later, but the pages must exist).
        # spec=None keeps the legacy arithmetic bit-for-bit.
        self._slack = decode_chunk if spec is None \
            else max(decode_chunk, spec.n_draft + 1)
        self.clock_mode = clock
        self.fixed_costs = fixed_costs
        # ``ledger``: None (byte-identical — the tr-is-None
        # convention), True (build a private CostLedger), or a shared
        # obs.ledger.CostLedger (the cluster router passes one so
        # every replica books onto the same accounts). Armed, every
        # priced clock delta and per-turn pool occupancy is
        # attributed (rid | "engine", kind) with exact integer
        # conservation audits; see docs/OBSERVABILITY.md.
        if ledger is True:
            ledger = obs_ledger.CostLedger()
        elif ledger is not None \
                and not isinstance(ledger, obs_ledger.CostLedger):
            raise ValueError("ledger= takes None, True or an "
                             "obs.ledger.CostLedger")
        self._ledger = ledger
        self.eos_token_id = eos_token_id
        self._expect_churn = expect_churn
        self._dense = dense_parts
        (self._p_outer, self._p_layers, pools, self._p_prefill,
         self._p_step, self._p_decode_n) = serving.paged_parts
        # The pool buffers are DONATED through every prefill/decode call,
        # so the factory's original arrays die at the first use. The live
        # pools therefore ride on the (shareable) serving object, not the
        # engine: engines sharing one factory hand the current buffers
        # along. Stale content between runs is harmless — attention only
        # reads positions < each row's length, all freshly written.
        if not hasattr(serving, "_live_pools"):
            serving._live_pools = pools
        # a factory may advertise wants_numpy_ (serving.sim does): its
        # callables take host arrays directly, so the per-call staging
        # is skipped; a real factory gets each host batch as a tensor on
        # the device its weights and pools live on
        self._tp_attr = {"tp": tp.size} if tp is not None else {}
        self.device = None
        if getattr(serving, "wants_numpy_", False):
            self._arr = lambda x: x
        else:
            self.device = self._p_outer["model.embed_tokens.weight"].device
            self._arr = lambda x, _d=self.device: torch.as_tensor(
                x, device=_d)
        # per-device pool residency: measured from the LIVE pool
        # arrays (factories may provide pool_device_bytes — the sim's
        # host pools model the head split arithmetically). Noted on
        # every run's bookkeeper and exported as the
        # serving_pool_bytes_per_device gauge ONLY when sharded
        # (the nonzero-only convention: tp=None leaves the registry
        # byte-identical).
        self._pool_bytes: Optional[Tuple[int, int]] = None
        self._g_pool_bytes = None
        if tp is not None or kv_quant is not None:
            # a quantizing factory prices its own pool (the sim's
            # token pools model the int8 layout arithmetically; the
            # real factory's leaves ARE the small arrays)
            tfn = getattr(serving, "pool_total_bytes", None)
            total = int(tfn(self._pools)) if tfn is not None \
                else sum(int(getattr(a, "nbytes", 0))
                         for a in _leaves(self._pools))
            fn = getattr(serving, "pool_device_bytes", None)
            per_dev = int(fn(self._pools)) if fn is not None \
                else tree_device_bytes(self._pools)
            self._pool_bytes = (total, per_dev)
            self._g_pool_bytes = obs_metrics.REGISTRY.gauge(
                "serving_pool_bytes_per_device",
                "KV pool bytes resident on one device of the TP mesh")
            self._g_pool_bytes.set(float(per_dev))

    def pool_bytes_per_device(self) -> Optional[int]:
        """One device's share of the live KV pool, bytes (None when
        the engine is unsharded — the whole pool is one device's)."""
        return self._pool_bytes[1] if self._pool_bytes is not None \
            else None

    def _note_pool(self, book: PagedKVCache, m: MetricsCollector,
                   t: float = 0.0):
        """Stamp the run bookkeeper with the REAL pool's byte census
        and stream the per-device signal to any attached SLO monitor
        (``pool_bytes_per_device`` — a ThresholdRule can watch it).
        No-op unsharded and unquantized: cache_stats/metrics stay
        byte-identical. With kv_quant= the bookkeeper is also armed
        with the tier pricing/compaction hooks here (one seam for
        run(), _run_scheduled() and sessions), and under 'pressure'
        the streamed signal is the LOGICAL stored-byte census —
        occupied pages priced by tier — not the static arena size:
        it moves as rows land and parked pages compact, which is
        exactly what a ThresholdRule needs to watch."""
        if self.kv_quant is not None:
            m.on_kv_quant(self.kv_quant)
            self._arm_quant(book)
        if self._pool_bytes is None:
            return
        book.note_pool_bytes(*self._pool_bytes)
        if self.kv_quant == "pressure":
            sb = book.stored_bytes()
            if sb is not None:
                per = int(sb) // self.tp_size
                m.on_pool_bytes(t, per)
                self._g_pool_bytes.set(float(per))
            return
        m.on_pool_bytes(t, self._pool_bytes[1])

    def _arm_quant(self, book: PagedKVCache):
        """Arm the run bookkeeper's tier census + compaction hooks:
        per-page byte pricing from the factory, the allocation-time
        byte budget, and (pressure) the device-side callback the book
        invokes whenever pages compact — it rebinds the live pools
        through the donating ``compact_pages`` program, so budget-
        driven and incident-driven compaction mutate the device
        arrays through ONE path."""
        pb = getattr(self.serving, "page_bytes_", None)
        cb = None
        if self.kv_quant == "pressure":
            compact = getattr(self.serving, "compact_pages", None)
            if compact is not None:
                wants_np = getattr(self.serving, "wants_numpy_", False)

                def cb(ids, _c=compact, _np=wants_np):
                    mask = np.zeros(self.n_pool_pages, dtype=bool)
                    mask[np.asarray(list(ids), dtype=np.int64)] = True
                    self._pools = _c(self._pools,
                                     mask if _np else self._arr(mask))
        book.note_kv_quant(
            self.kv_quant,
            fp_bytes_per_page=(pb[0] if pb is not None else None),
            q_bytes_per_page=(pb[1] if pb is not None else None),
            byte_budget=self.kv_quant_budget, compact_cb=cb)

    def _make_quant_state(self) -> Optional[dict]:
        """Fresh pressure-actuation state per run/session (tier off,
        empty flip log — two seeded replays flip and compact
        identically), or None unless kv_quant='pressure'."""
        if self.kv_quant != "pressure":
            return None
        return {"enabled": False, "flips": [],
                "compactions": 0, "pages_compacted": 0}

    def _wire_pressure(self, mon, sched):
        """The pressure seam, auto-wired like ``_wire_spec_overload``:
        with kv_quant='pressure', a QoS scheduler and an SLO monitor
        all configured, every incident the monitor opens is delivered
        to ``QoSScheduler.note_incident`` — a
        ``pool_bytes_per_device`` ThresholdRule firing then flips the
        compaction tier until it closes. Idempotent across runs."""
        if mon is None or sched is None or self.kv_quant != "pressure" \
                or not hasattr(sched, "note_incident"):
            return
        if hasattr(sched, "track_pressure"):
            sched.track_pressure = True
        if sched.note_incident not in mon._cbs:
            mon.subscribe(sched.note_incident)

    def _quant_flip(self, qst: dict, m, clock, tr, enabled: bool,
                    rule: str):
        """One deterministic pressure-tier flip on the virtual clock,
        with the rule that fired (the ``explain=`` discipline —
        mirrors ``_spec_flip``)."""
        qst["enabled"] = enabled
        qst["flips"].append({"t": round(clock.now(), 6),
                             "enabled": enabled, "rule": rule})
        m.on_kv_quant_flip(enabled)
        self._ctr_quant_flips["on" if enabled else "off"].inc()
        if tr is not None:
            tr.instant("kv_quant_flip", t=clock.now(), track="engine",
                       enabled=enabled, rule=rule)

    def _quant_turn(self, book: PagedKVCache, m, clock, tr,
                    qst: Optional[dict]):
        """Per-turn pressure bookkeeping, evaluated where the pool
        census is sampled: stream the stored-byte signal, flip the
        tier on the scheduler's open-incident probe, and while it is
        ON compact every page parked in the evictable LRU (capacity
        degradation first — the shedding tiers stay untouched, and a
        page freed by compaction is a request NOT shed). No-op unless
        kv_quant='pressure' (qst is None otherwise)."""
        if qst is None:
            return
        t = clock.now()
        sb = book.stored_bytes()
        if sb is not None:
            per = int(sb) // self.tp_size
            m.on_pool_bytes(t, per)
            if self._g_pool_bytes is not None:
                self._g_pool_bytes.set(float(per))
        sched = self.scheduler
        active = (sched is not None
                  and getattr(sched, "pressure_active", None)
                  is not None and sched.pressure_active())
        if active and not qst["enabled"]:
            self._quant_flip(
                qst, m, clock, tr, True,
                "pool_bytes_per_device incident open via "
                "QoSScheduler.note_incident — compact parked pages "
                "before any shedding tier fires")
        elif not active and qst["enabled"]:
            self._quant_flip(
                qst, m, clock, tr, False,
                "pool-byte incident closed (stored bytes back under "
                "threshold)")
        if qst["enabled"]:
            ids = book.compact_evictable()
            if ids:
                qst["compactions"] += 1
                qst["pages_compacted"] += len(ids)
                m.on_compaction(t, len(ids))
                self._ctr_compactions.inc(len(ids))
                if tr is not None:
                    tr.instant("kv_compaction", t=t, track="engine",
                               pages=len(ids))

    def _quant_result(self, book: PagedKVCache,
                      qst: Optional[dict]) -> Optional[dict]:
        """The ``ServeResult.kv_quant_stats`` block (None at
        kv_quant=None — the pre-quant result shape)."""
        if self.kv_quant is None:
            return None
        cs = book.cache_stats()
        out = {"mode": self.kv_quant,
               "quantized_pages": cs.get("quantized_pages", 0),
               "compactions": cs.get("compactions", 0)}
        sb = book.stored_bytes()
        if sb is not None:
            out["stored_bytes"] = int(sb)
        if qst is not None:
            out["flips"] = list(qst["flips"])
            out["pages_compacted"] = qst["pages_compacted"]
        return out

    def _arm_hostmem(self, book: PagedKVCache, clock, m,
                     tr=None) -> Optional[dict]:
        """Arm the run bookkeeper's host-arena spill tier: a FRESH
        arena per run (two seeded replays spill and page identically),
        the per-page byte prices, and the export closure the book
        invokes whenever an evicted page spills — each crossing is
        priced as one ``kv_pageout`` on the virtual clock (the
        ``adapter_upload``/``KVHandoff`` transfer-pricing pattern).
        Returns the per-run hostmem state dict, or None at
        hostmem=None (every caller then stays byte-identical)."""
        if self.hostmem is None:
            return None
        arena = HostArena(self.hostmem.byte_budget)
        # full-precision per-page price: explicit config override,
        # else the factory's advertisement, else the live pool's
        # measured bytes / page count
        fp = self.hostmem.page_bytes
        if fp is None:
            fp = getattr(self.serving, "page_host_bytes_", None)
        if fp is None:
            pb = getattr(self.serving, "page_bytes_", None)
            fp = pb[0] if pb is not None else None
        if fp is None:
            tfn = getattr(self.serving, "pool_total_bytes", None)
            total = int(tfn(self._pools)) if tfn is not None \
                else sum(int(getattr(a, "nbytes", 0))
                         for a in _leaves(self._pools))
            fp = max(1, total // max(1, self.n_pool_pages))
        qb = None
        if self.kv_quant is not None:
            # int8 pages spill at their int8+scale price — the
            # kv_quant_page_bytes arithmetic carried across the tier
            pb = getattr(self.serving, "page_bytes_", None)
            qb = pb[1] if pb is not None else None
        hst = {"arena": arena, "fp": int(fp), "qb": qb,
               "preempts": 0, "restores": 0,
               "resume_prefix": {}, "preempted": set()}

        def spill_cb(p, quant):
            data = self._timed(
                tr, clock, "kv_pageout",
                lambda: self.export_kv_pages([p]),
                cost=self._hm_cost("kv_pageout", quant, hst),
                page=p)
            m.on_pageout(clock.now(), 1)
            self._ctr_pageouts.inc()
            return data

        book.note_hostmem(arena, spill_cb, fp, qb)
        return hst

    def _hm_cost(self, kind, quant, hst) -> Optional[float]:
        """Fixed-clock transfer price override for one page crossing:
        an int8 page moves fewer bytes, so it pays the flat
        ``kv_pageout``/``kv_pagein`` cost scaled by its byte ratio.
        None (the clock's own default pricing) on measured clocks and
        for full-precision pages."""
        if self.clock_mode != "fixed" or not quant \
                or hst["qb"] is None or not hst["fp"]:
            return None
        base = (self.fixed_costs or {}).get(kind, 1.0)
        return base * (hst["qb"] / hst["fp"])

    def _pagein_page(self, p, entry, rid, clock, m, tr, hst):
        """The import closure ``PagedKVCache.page_in`` invokes per
        restored page: scatter the arena blob into the device pool at
        page ``p``, priced as one ``kv_pagein``."""
        self._timed(
            tr, clock, "kv_pagein",
            lambda: self.import_kv_pages([p], entry.data),
            rid=rid,
            cost=self._hm_cost("kv_pagein", entry.quant, hst),
            page=p)
        m.on_pagein(clock.now(), 1)
        self._ctr_pageins.inc()

    @staticmethod
    def _stitch_resumes(outputs, hst: Optional[dict]):
        """A preempted request's stream was emitted in two (or more)
        lives: the tokens it streamed before each swap-out, then what
        its resumed run produced. The client saw ONE stream — the
        result reports it as one (a preempted-then-shed request keeps
        the partial stream it was actually served)."""
        if hst is None:
            return
        for rid, pre in hst["resume_prefix"].items():
            outputs[rid] = list(pre) + outputs.get(rid, [])

    def _hostmem_result(self, book: PagedKVCache,
                        hst: Optional[dict]) -> Optional[dict]:
        """The ``ServeResult.hostmem_stats`` block (None at
        hostmem=None — the pre-hostmem result shape)."""
        if hst is None:
            return None
        cs = book.cache_stats()
        return {"arena": hst["arena"].stats(),
                "arena_census_ok": hst["arena"].census_ok(),
                "spilled_pages": cs.get("spilled_pages", 0),
                "spills": cs.get("spills", 0),
                "pageins": cs.get("pageins", 0),
                "spill_refusals": cs.get("spill_refusals", 0),
                "preempts": hst["preempts"],
                "restores": hst["restores"],
                "preempted_rids": sorted(hst["preempted"]
                                         | set(hst["resume_prefix"]))}

    @property
    def _pools(self):
        return self.serving._live_pools

    @_pools.setter
    def _pools(self, value):
        self.serving._live_pools = value

    @property
    def _spec_pools(self):
        return self.serving._live_spec_pools

    @_spec_pools.setter
    def _spec_pools(self, value):
        self.serving._live_spec_pools = value

    # --- tracing helpers --------------------------------------------------
    @staticmethod
    def _tenant_track(r: Request) -> str:
        return f"tenant/{r.tenant}" if r.tenant is not None \
            else "requests"

    def _make_tracer(self, clock) -> Optional[obs_trace.Tracer]:
        spec = self._trace_spec
        if spec is None or spec is False:
            return None
        if isinstance(spec, obs_trace.Tracer):
            t = spec
            t.clear()   # each run() is one trace
        else:
            t = obs_trace.Tracer()
        t.set_clock(clock.now)  # spans live in VIRTUAL time
        return t

    def _close_trace(self, tr: Optional[obs_trace.Tracer]):
        if tr is not None and isinstance(self._trace_spec, str):
            tr.export(self._trace_spec)

    def _make_monitor(self, fresh: bool = True) \
            -> Optional[obs_slo.SLOMonitor]:
        """``fresh``: a caller-held monitor instance is RESET (the
        ``trace=Tracer`` convention — each run() is one monitoring
        session; without the reset a second replay's low virtual
        timestamps would be instantly outside the first run's
        advanced windows and every rule would go blind). Sessions
        pass ``fresh=False`` — they are incremental by design and a
        reset would nuke a log shared with sibling sessions."""
        spec = self._slo_spec
        if spec is None:
            return None
        if isinstance(spec, obs_slo.SLOMonitor):
            if fresh:
                spec.reset()
            return spec
        return obs_slo.SLOMonitor(spec)

    def _make_adapter_cache(self) -> Optional[AdapterCache]:
        """A FRESH adapter cache per run/session (cold bank — two
        seeded replays upload identically), or None when the engine is
        single-model. The device hooks come from the factory
        (``init_adapter_bank``/``upload_adapter``); the bank is sized
        by the factory's ``lora_.n_slots``."""
        if self._adapter_store is None:
            return None
        return AdapterCache(self._adapter_store, self.lora.n_slots,
                            self.serving.init_adapter_bank,
                            self.serving.upload_adapter)

    def _make_grammar_cache(self) -> Optional[GrammarCache]:
        """A FRESH grammar cache per run/session (cold mask bank —
        two seeded replays upload identically), or None when the
        engine is free-running. The device hooks come from the
        factory (``init_grammar_bank``/``upload_grammar``); the bank
        is sized by the factory's ``grammar_`` config. The HOST
        compile memo is the engine's (shared across runs/sessions and
        with the scheduler's floor probe): a schema's automaton
        compiles once per engine, only the bank upload repeats."""
        if self._grammar_store is None:
            return None
        gc = GrammarCache(
            self._grammar_store, self.grammar_cfg.n_slots,
            self.grammar_cfg.max_states,
            TokenVocab.ascii_default(self.serving.grammar_vocab_),
            self.serving.init_grammar_bank,
            self.serving.upload_grammar)
        gc._dfa = self._dfa_memo
        return gc

    def _grammar_arg(self, gcache: Optional[GrammarCache], gids):
        """The ``grammar=`` argument for a factory call:
        ``(mask_table, state_ids)`` when constrained decoding is on
        (flat ids staged like every other host batch input), None
        otherwise — free-running engines call the factory EXACTLY as
        before, so their programs and outputs are untouched."""
        if gcache is None:
            return None
        return (gcache.bank, self._arr(np.asarray(gids, np.int32)))

    def _schema_of(self, r: Request) -> Optional[str]:
        """The schema this request decodes under: its own
        ``Request.schema`` first, else its adapter's default from
        ``adapter_schemas=``, else None (free-running). Always None
        on a grammar-less engine — ``_validate`` already refused any
        request that NAMES a schema there."""
        if self._grammar_store is None:
            return None
        if r.schema is not None:
            return r.schema
        if r.adapter is not None:
            return self._adapter_schemas.get(r.adapter)
        return None

    def _grammar_automaton(self, name: str):
        """Compile-and-memoize ``name``'s automaton host-side (the
        engine-lifetime memo every run's GrammarCache shares). No
        bank slot is touched — this is the probe path."""
        g = self._dfa_memo.get(name)
        if g is None:
            from .grammar import compile_source
            g = compile_source(self._grammar_store.get(name),
                               TokenVocab.ascii_default(
                                   self.serving.grammar_vocab_))
            if g.n_states > self.grammar_cfg.max_states:
                raise ValueError(
                    f"grammar {name!r} compiles to {g.n_states} "
                    f"states but the bank holds max_states="
                    f"{self.grammar_cfg.max_states}")
            self._dfa_memo[name] = g
        return g

    def _grammar_floor(self, r: Request) -> Optional[int]:
        """The scheduler's degrade floor for one request: the
        shortest token count its automaton accepts (None for free
        rows — the legacy floor of 1 applies)."""
        name = self._schema_of(r)
        if name is None:
            return None
        return int(self._grammar_automaton(name).min_tokens)

    def _make_spec_state(self) -> Optional[_SpecState]:
        """Fresh adaptive-route state per run/session (cold EWMA,
        empty flip log — two seeded replays flip identically), or
        None when the engine is spec-free."""
        if self.spec is None:
            return None
        return _SpecState(self.spec)

    def _make_ahead_state(self) -> Optional[_AheadState]:
        """Fresh dispatch-ahead double buffer per run/session (no
        stash can ever cross runs), or None with the flag off — every
        pass-through then sees exactly the legacy sequential turn."""
        return _AheadState() if self.dispatch_ahead else None

    def _wire_spec_overload(self, mon, sched):
        """The declared overload seam, auto-wired: with a spec route,
        a QoS scheduler and an SLO monitor all configured, every
        incident the monitor opens is delivered to
        ``QoSScheduler.note_incident`` — a page-severity
        ``BurnRateRule`` firing then parks the spec route until it
        closes. Idempotent: a caller-held monitor reused across runs
        never double-subscribes."""
        if mon is None or sched is None or self.spec is None \
                or not self.spec.overload_fallback \
                or not hasattr(sched, "note_incident"):
            return
        if sched.note_incident not in mon._cbs:
            mon.subscribe(sched.note_incident)

    def _spec_flip(self, spst: _SpecState, clock, tr, enabled: bool,
                   rule: str):
        """One deterministic route flip on the virtual clock, with
        the rule that fired (the ``explain=`` discipline)."""
        spst.enabled = enabled
        flip = {"t": round(clock.now(), 6), "enabled": enabled,
                "rule": rule}
        spst.flips.append(flip)
        self._ctr_spec_flips["spec" if enabled else "plain"].inc()
        if tr is not None:
            tr.instant("spec_flip", t=clock.now(), track="engine",
                       enabled=enabled, rule=rule)

    def _spec_gate(self, spst: _SpecState, clock, tr):
        """Evaluate the adaptive fallbacks once per decode turn,
        BEFORE the rows are grouped: overload first (spec wastes
        draft compute exactly when capacity is scarce — the moment a
        page-severity incident lands through
        ``QoSScheduler.note_incident``, spec rows decode plain until
        it closes), then the acceptance floor (EWMA below
        ``accept_floor`` after ``min_rounds`` row-rounds LATCHES
        plain for the rest of the run — with no spec rounds running,
        no new evidence could clear it)."""
        cfg = spst.cfg
        if spst.latched:
            return
        if cfg.overload_fallback and self.scheduler is not None \
                and getattr(self.scheduler, "overload_active",
                            None) is not None \
                and self.scheduler.overload_active():
            if spst.enabled:
                self._spec_flip(
                    spst, clock, tr, False,
                    "overload (page-severity incident open via "
                    "QoSScheduler.note_incident — draft compute is "
                    "waste when capacity is scarce)")
            return
        if spst.ewma is not None and spst.samples >= cfg.min_rounds \
                and spst.ewma < cfg.accept_floor:
            spst.latched = True
            if spst.enabled:
                self._spec_flip(
                    spst, clock, tr, False,
                    f"acceptance ewma {spst.ewma:.4f} < floor "
                    f"{cfg.accept_floor} after {spst.samples} spec "
                    "turns (latched plain for the run)")
            return
        if not spst.enabled:
            self._spec_flip(spst, clock, tr, True,
                            "overload cleared (incident closed)")

    def _spec_prefill_row(self, r: Request, book, T: int, clock, tr):
        """DRAFT prefill for one spec-eligible row, at the moment its
        target prompt pages hold real K/V: the draft walks the FULL
        prompt through the SAME page chain into its own pool arrays.
        Unlike the target, the draft never takes the prefix-cache
        skip — a cached chain's publisher may have been plain-routed
        (tight traffic, a latched run, ``prefix_cache`` off), in
        which case its draft pages were never written, and a draft
        conditioned on junk would quietly collapse acceptance. The
        walk is cheap by construction (the draft is a fraction of
        the target); the expensive TARGET prefill still takes the
        full cache skip. Clock kind ``spec_prefill`` (per-unit via
        ``spec_prefill_unit`` when the cost table carries it)."""
        sid = r.rid
        toks = np.zeros((1, T), np.int32)
        toks[0, :len(r.prompt)] = r.prompt
        pt = np.zeros((1, self.W), np.int32)
        table = book.tables[sid]
        pt[0, :len(table)] = table
        lens = np.asarray([len(r.prompt)], np.int32)
        s_outer, s_layers, _, s_prefill, _ = self._spec_parts

        def _call():
            arr = self._arr
            return s_prefill(s_outer, s_layers, arr(toks), arr(pt),
                             arr(lens), self._spec_pools,
                             resume_from=0)
        _, self._spec_pools = self._timed(
            tr, clock, "spec_prefill", _call, jitfn=s_prefill,
            rid=sid, units=T // self.chunk_C, **self._tp_attr)

    def _lora_arg(self, acache: Optional[AdapterCache], ids):
        """The ``lora=`` argument for a factory call: ``(bank, ids)``
        when multi-model serving is on (ids staged like every other
        host batch input), None otherwise — single-model engines call
        the factory EXACTLY as before, so their programs and outputs
        are untouched."""
        if acache is None:
            return None
        return (acache.bank, self._arr(np.asarray(ids, np.int32)))

    def _note_adapters(self, acache: Optional[AdapterCache], m, t):
        """Refresh the resident-adapter gauge and stream the count to
        any attached SLO monitor. No-op single-model."""
        if acache is None:
            return
        n = acache.resident_count()
        self._g_adapter_resident.set(float(n))
        m.on_adapter_resident(t, n)

    @staticmethod
    def _bank_incidents(mon) -> Optional[List]:
        """This run's incidents for ServeResult: the monitor's view of
        its own source (a cluster replica shares one IncidentLog with
        its siblings — its per-replica result banks only what IT
        fired; the router's ClusterResult carries the full set)."""
        if mon is None:
            return None
        return [i for i in mon.log.incidents if i.source == mon.source]

    def _make_clock(self, label: str = "engine") -> EngineClock:
        """This run's virtual clock: plain (byte-identical) without a
        ledger, ledger-booking with one — ``label`` names the
        per-engine conservation book (the replica name in cluster
        runs)."""
        if self._ledger is None:
            return EngineClock(self.clock_mode, self.fixed_costs)
        return _LedgerClock(self.clock_mode, self.fixed_costs,
                            self._ledger, label)

    def _req_features(self, r: Request) -> Tuple[str, ...]:
        """The request's static feature tags for the ledger's
        per-feature rollup (engine-wide transforms plus the request's
        own asks); dynamic ones (spec/hostmem/ragged) derive from the
        kinds actually charged."""
        feats = []
        if getattr(self, "tp_size", 1) > 1:
            feats.append("tp")
        if self.kv_quant is not None:
            feats.append("kv_quant")
        if r.adapter is not None:
            feats.append("lora")
        if self._schema_of(r) is not None:
            feats.append("grammar")
        return tuple(feats)

    def _req_open(self, tr, r: Request):
        if self._ledger is not None:
            self._ledger.open(r.rid, tenant=r.tenant,
                              features=self._req_features(r))
        if tr is None:
            return
        attrs = {"prompt_len": len(r.prompt),
                 "budget": r.max_new_tokens}
        if r.tenant is not None:
            attrs["tenant"] = r.tenant
        if r.priority:
            attrs["priority"] = r.priority
        if r.deadline_ms is not None:
            attrs["deadline_ms"] = r.deadline_ms
        tr.async_begin("request", r.rid, t=r.arrival,
                       track=self._tenant_track(r), **attrs)

    def _req_close(self, tr, r: Request, t: float, outcome: str,
                   n_tokens: int, reason: Optional[str] = None):
        if self._ledger is not None:
            # moves ("failover"/"handoff"/"requeued") and the final
            # outcome collect IN ORDER on the one shared account —
            # the exactly-once evidence chaos accounting asserts on
            self._ledger.note_outcome(r.rid, outcome)
        if tr is None:
            return
        attrs = {"outcome": outcome, "n_tokens": n_tokens}
        if reason is not None:
            attrs["reason"] = reason
        tr.async_end("request", r.rid, t=t,
                     track=self._tenant_track(r), **attrs)

    def _wave_instant(self, tr, decision: dict):
        if tr is not None:
            tr.instant("wave", t=decision["t"], track="engine",
                       **{k: v for k, v in decision.items()
                          if k != "t"})

    def _timed(self, tr, clock, kind, fn, jitfn=None, rid=None,
               units=None, cost=None, rids=None, **attrs):
        """``clock.timed`` plus, when tracing, a span in virtual time
        (wall seconds as an attr) and jit-recompile detection: the
        wrapped program cache growing across the call means THIS call
        compiled — the ``jit.compile`` instant names the site and the
        wall cost, the counter feeds the metrics registry.

        ``rids`` (batched dispatches) is the cost ledger's attribution
        vector: the charge splits pro-rata across the rows — by the
        per-row ``cost`` list when the call priced one (the ragged
        fused convention), equally otherwise. With ``rids`` unset the
        charge lands on ``rid``, or on "engine" when the call has no
        single beneficiary. Every priced call site funnels through
        here, so a ledger-armed run can never book an unattributed
        unit (the audit enforces it)."""
        setter = getattr(clock, "push_attr", None)
        if setter is not None:
            setter(rid, rids,
                   cost if isinstance(cost, (list, tuple)) else None)
        if tr is None:
            # no trace: recompile COUNTING stays live (the obs
            # contract — counters record when nobody traces) unless
            # the registry kill-switch is down (the no-obs arm);
            # detection is two cache-size reads around the call
            if jitfn is None or not obs_metrics.REGISTRY.enabled:
                return clock.timed(kind, fn, units, cost)
            c0 = _jit_cache_size(jitfn)
            out = clock.timed(kind, fn, units, cost)
            if c0 is not None:
                c1 = _jit_cache_size(jitfn)
                if c1 is not None and c1 > c0:
                    self._ctr_compiles.inc()
            return out
        t0 = clock.now()
        w0 = time.perf_counter()
        c0 = _jit_cache_size(jitfn) if jitfn is not None else None
        scope = obs_trace.trace_scope(rid) if rid is not None else None
        if scope is not None:
            with scope:
                out = clock.timed(kind, fn, units, cost)
        else:
            out = clock.timed(kind, fn, units, cost)
        wall = time.perf_counter() - w0
        if rid is not None:
            attrs["rid"] = rid
        tr.add_span(kind, t0, clock.now() - t0, track="engine",
                    wall_s=round(wall, 6), **attrs)
        if c0 is not None:
            c1 = _jit_cache_size(jitfn)
            if c1 is not None and c1 > c0:
                self._ctr_compiles.inc()
                inst = {"site": kind, "wall_s": round(wall, 6)}
                if rid is not None:
                    inst["rid"] = rid
                tr.instant("jit.compile", t=t0, track="jit", **inst)
        return out

    # --- helpers ----------------------------------------------------------
    def _pad_len(self, n: int) -> int:
        # pad prompts to the CHUNK multiple (a page multiple by factory
        # contract): prefill_chunked rejects prompts that are not — a
        # page-size pad under a larger chunk would crash mid-run
        c = self.chunk_C
        return max(c, -(-n // c) * c)

    def _footprint_len(self, prompt_len: int, budget: int) -> int:
        """The one footprint formula (`_validate` enforces it against
        ``max_len``; the cluster's retry sizing asks it before growing
        a resumed prompt): padded prompt + decode budget + one turn of
        write slack (a decode chunk, or the spec verify window when a
        spec route is configured — whichever writes deeper)."""
        return self._pad_len(prompt_len) + budget + self._slack

    def _footprint(self, r: Request) -> int:
        return self._footprint_len(len(r.prompt), r.max_new_tokens)

    def _order_wave(self, wave) -> List[Request]:
        """Cache-aware co-scheduling for the FIFO loop's PAGED branch:
        requests whose prompts open with the same first page become
        ADJACENT (groups in first-arrival order, members in their
        incoming order), so when slots run out mid-wave a cohort is
        admitted together — its publisher registers before the
        siblings prefill (register-then-acquire) and the shared pages
        stay resident while every sharer needs them. Prompts that
        share no page keep their order exactly (every group is a
        singleton), so plain traces replay bit-identically. Routing,
        dense waves and the QoS loop never see this reordering: dense
        has no page cache to win, and the QoS scheduler's
        priority/WFQ order is authoritative (cache awareness enters
        its admission through ``ServiceEstimator.prefill_cost``
        pricing instead, so adjacency can never invert a priority
        decision)."""
        if not self.prefix_cache or len(wave) < 2:
            return list(wave)
        ps = self.page_size
        groups: Dict = {}
        order: List = []
        for i, r in enumerate(wave):
            # adapter id joins the grouping key: rows of one adapter
            # become ADJACENT segments of the admission wave (the
            # segment-gather layout the batched delta application
            # reads), and a cohort sharing both prefix and adapter
            # still co-schedules. Adapter-less traces key every row
            # with the same None, so their ordering is untouched.
            key = (r.adapter, tuple(r.prompt[:ps])) \
                if len(r.prompt) >= ps else (r.adapter, ("short", i))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
        return [r for k in order for r in groups[k]]

    def _validate(self, trace):
        for r in trace:
            if self._footprint(r) > self.max_len:
                raise ValueError(
                    f"{r.rid}: padded prompt {self._pad_len(len(r.prompt))}"
                    f" + budget {r.max_new_tokens} + write slack "
                    f"{self._slack} exceeds max_len {self.max_len}")
            if r.adapter is not None:
                if self._adapter_store is None:
                    raise ValueError(
                        f"{r.rid}: names adapter {r.adapter!r} but "
                        "the engine was built without adapters= — a "
                        "silent base-model answer would be the wrong "
                        "model's tokens")
                if r.adapter not in self._adapter_store:
                    raise ValueError(
                        f"{r.rid}: unknown adapter {r.adapter!r} "
                        f"(registered: {self._adapter_store.names()})")
            if r.schema is not None:
                if self._grammar_store is None:
                    raise ValueError(
                        f"{r.rid}: names schema {r.schema!r} but the "
                        "engine was built without grammar= — a "
                        "free-running answer would break the "
                        "declared output contract")
                if r.schema not in self._grammar_store:
                    raise ValueError(
                        f"{r.rid}: unknown schema {r.schema!r} "
                        f"(registered: {self._grammar_store.names()})")

    # --- the replay loop --------------------------------------------------
    def run(self, trace: List[Request]) -> ServeResult:
        if self.scheduler is not None:
            return self._run_scheduled(trace, self.scheduler)
        self._validate(trace)
        clock = self._make_clock()
        tr = self._make_tracer(clock)
        mon = self._make_monitor()
        m = MetricsCollector(monitor=mon)
        book = PagedKVCache(self.n_pool_pages, self.page_size,
                            kv_heads=1, head_dim=1,
                            device="cpu")  # bookkeeping only:
        # tables/lengths/free-list/prefix refcounts — device pages live
        # in the factory pools, written by prefill/decode_n
        self._note_pool(book, m)
        hst = self._arm_hostmem(book, clock, m, tr)
        acache = self._make_adapter_cache()
        gcache = self._make_grammar_cache()
        spst = self._make_spec_state()
        qst = self._make_quant_state()
        ahst = self._make_ahead_state()
        run_w0 = time.perf_counter()
        pages_total = len(book._free)
        pending = deque(sorted(trace, key=lambda r: (r.arrival, r.rid)))
        waiting: List[Request] = []
        active: Dict[str, _PagedRow] = {}
        lane = deque() if self.prefill_chunk_budget is not None \
            else None
        free_slots = list(range(self.slots))
        outputs: Dict[str, List[int]] = {}
        decisions: List[dict] = []
        slot_log: List[tuple] = []
        prefix_cached: Dict[str, int] = {}
        seen_groups: set = set()
        prefill_tokens = 0
        inv_ok = True
        a_inv = True
        g_inv = True
        expect_churn = self._expect_churn if self._expect_churn \
            is not None else any(r.cancel_after is not None
                                 for r in trace)
        ctx_base = {"capacity": self.slots, "expect_churn": expect_churn}

        prev_tr = obs_trace.active()
        if tr is not None:
            obs_trace.activate(tr)
        try:
            while pending or waiting or active or lane:
                now = clock.now()
                while pending and pending[0].arrival <= now + 1e-12:
                    r = pending.popleft()
                    waiting.append(r)
                    # QoS fields ride along so a FIFO baseline run on a
                    # QoS trace still reports deadline attainment/goodput;
                    # on a plain trace they are all None and the metrics
                    # record stays byte-identical to the plain engine
                    m.on_arrival(r.rid, r.arrival, tenant=r.tenant,
                                 priority=r.priority,
                                 deadline_ms=r.deadline_ms)
                    self._ctr_arrived.inc()
                    self._req_open(tr, r)
                m.on_queue_depth(now, len(waiting))
                if tr is not None:
                    tr.counter("queue_depth", len(waiting), t=now)

                progressed = False
                if waiting and self._admission_ready(waiting, pending,
                                                     active, clock):
                    wave = waiting[:self.admission.max_batch]
                    groups = [r.prefix_group for r in wave
                              if r.prefix_group is not None]
                    shared = (len(groups) != len(set(groups))
                              or any(g in seen_groups for g in groups))
                    ctx = dict(ctx_base, shared_prefix=shared,
                               active_paged=len(active)
                               + (len(lane) if lane else 0))
                    backend, reason = self.policy.route(wave, ctx)
                    decision = {
                        "t": round(clock.now(), 6), "wave": len(wave),
                        "prompt_lens": [len(r.prompt) for r in wave],
                        "backend": backend, "rule": reason}
                    if backend == "dense":
                        decisions.append(decision)
                        self._wave_instant(tr, decision)
                        del waiting[:len(wave)]
                        seen_groups.update(g for g in groups)
                        self._run_dense_wave(wave, clock, m, outputs,
                                             tr=tr)
                        progressed = True
                    else:
                        # only the paged ADMISSION order is cache-
                        # reordered (routing and the decision log keep
                        # arrival order)
                        wave = self._order_wave(wave)
                        n_adm, _, ptoks = self._admit_paged(
                            wave, book, clock, m, active, free_slots,
                            slot_log, prefix_cached, seen_groups,
                            outputs, tr=tr, lane=lane, acache=acache,
                            spst=spst, hst=hst, gcache=gcache)
                        prefill_tokens += ptoks
                        for r in wave[:n_adm]:  # possibly reordered —
                            waiting.remove(r)   # remove by identity
                        progressed = n_adm > 0
                        if n_adm:
                            # a BLOCKED wave (no slots/pages yet) is not a
                            # decision — it will re-route once something
                            # frees; logging every retry turn would inflate
                            # the per-wave statistics the bench reports
                            decision["admitted"] = n_adm
                            # prompt_lens above is ARRIVAL order; the
                            # cache reorder means the first-n slice no
                            # longer names the admitted set — the rids do
                            decision["admit_rids"] = \
                                [r.rid for r in wave[:n_adm]]
                            decisions.append(decision)
                            self._wave_instant(tr, decision)
                        elif not active and not lane:
                            raise RuntimeError(
                                f"pool/slot config too small for "
                                f"{wave[0].rid} (free pages "
                                f"{len(book._free)}, free slots "
                                f"{len(free_slots)})")

                if active:
                    self._paged_chunk(book, clock, m, active, free_slots,
                                      slot_log, outputs, tr=tr,
                                      acache=acache, spst=spst,
                                      ahst=ahst, gcache=gcache)
                    progressed = True

                if lane:
                    # the async lane: decode ran FIRST — pending
                    # prefill gets at most prefill_chunk_budget chunks
                    # of this turn, so TPOT is independent of how much
                    # prefill is queued
                    _, ptoks = self._lane_step(
                        lane, book, clock, m, active, free_slots,
                        slot_log, outputs, prefix_cached, seen_groups,
                        tr=tr, acache=acache, spst=spst,
                        gcache=gcache)
                    prefill_tokens += ptoks
                    progressed = True

                if not progressed and not active:
                    targets = []
                    if pending:
                        targets.append(pending[0].arrival)
                    if waiting:
                        targets.append(waiting[0].arrival
                                       + self.admission.max_delay)
                    clock.advance_to(min(targets))
                self._quant_turn(book, m, clock, tr, qst)
                inv_ok &= book.census_ok()
                if acache is not None:
                    a_inv &= acache.census_ok()
                if gcache is not None:
                    g_inv &= gcache.census_ok()
                if self._ledger is not None:
                    self._ledger.sample_occupancy(
                        clock.label, book=book, acache=acache,
                        gcache=gcache,
                        arena=getattr(book, "_arena", None))
        finally:
            if tr is not None:
                if prev_tr is not None:
                    obs_trace.activate(prev_tr)
                else:
                    obs_trace.deactivate()
        cost_stats = self._cost_result(clock, tr, m)
        self._close_trace(tr)
        self._stitch_resumes(outputs, hst)
        return ServeResult(policy=self.policy.name, outputs=outputs,
                           metrics=m, decisions=decisions,
                           slot_log=slot_log, prefix_cached=prefix_cached,
                           pages_total=pages_total,
                           pages_free_end=(len(book._free)
                                           + len(book._evictable)),
                           trace=tr, prefill_tokens=prefill_tokens,
                           cache_stats=dict(book.cache_stats(),
                                            invariant_ok=inv_ok),
                           incidents=self._bank_incidents(mon),
                           adapter_stats=(
                               None if acache is None else
                               dict(acache.cache_stats(),
                                    invariant_ok=a_inv)),
                           spec_stats=(None if spst is None
                                       else spst.stats()),
                           kv_quant_stats=self._quant_result(book,
                                                             qst),
                           overhead=self._overhead_row(clock, run_w0),
                           hostmem_stats=self._hostmem_result(book,
                                                              hst),
                           pages_spilled=(
                               None if hst is None else
                               book.cache_stats().get(
                                   "spilled_pages", 0)),
                           grammar_stats=(
                               None if gcache is None else
                               dict(gcache.cache_stats(),
                                    invariant_ok=g_inv)),
                           cost_stats=cost_stats)

    def _overhead_row(self, clock, run_w0) -> Optional[Dict]:
        """The measured-clock host-overhead decomposition:
        ``engine_host_frac`` is the fraction of the run's wall time
        NOT covered by in-flight device work (timed dispatch waits,
        plus the overlapped span of every dispatched-ahead batch that
        was served). Dispatch-ahead exists to shrink it. None on
        fixed clocks — their results stay byte-identical."""
        if self.clock_mode != "measured":
            return None
        run_wall = time.perf_counter() - run_w0
        dev = min(clock.dev_wall, run_wall)
        frac = 1.0 - dev / run_wall if run_wall > 0 else 0.0
        return {"run_wall_s": round(run_wall, 6),
                "device_wall_s": round(dev, 6),
                "engine_host_frac": round(max(0.0, frac), 6)}

    def _cost_result(self, clock, tr=None, m=None) -> Optional[Dict]:
        """Bank the cost ledger's run-end evidence for this engine's
        book: ``cost_stats`` (unit totals, per-kind breakdown, the
        page-turn integral, and both conservation-audit flags), one
        ``cost`` instant on the trace's engine track (armed AND
        tracing only — un-armed traces stay byte-identical), and the
        watermarked Prometheus publish (safe to repeat on a shared
        cluster ledger). None when the run carries no ledger, so the
        result shape every pre-ledger consumer sees is unchanged."""
        if self._ledger is None:
            return None
        label = getattr(clock, "label", "engine")
        stats = self._ledger.cost_stats(label)
        if m is not None:
            m.note_costs(self._ledger.tenant_costs())
        if tr is not None:
            tr.instant("cost", t=clock.now(), track="engine",
                       **{k: stats[k] for k in
                          ("engine", "elapsed_units", "idle_units",
                           "attributed_units", "page_turns",
                           "conserved_ok", "occupancy_ok")})
        self._ledger.publish(obs_metrics.REGISTRY)
        return stats

    def _admission_ready(self, waiting, pending, active, clock) -> bool:
        if len(waiting) >= self.admission.max_batch:
            return True
        # the window-close test MUST round identically to the idle
        # target `arrival + max_delay` the loop advances to: comparing
        # `now - arrival >= max_delay` instead livelocks once the
        # clock is large enough that one ulp exceeds the epsilon
        # (advance_to(target) lands ON target yet reads as not-ready
        # — first seen at t ~ 6e4 on the 10^5-request cluster trace)
        if clock.now() >= waiting[0].arrival \
                + self.admission.max_delay - 1e-12:
            return True
        return not pending and not active  # nothing else will ever come

    # --- the QoS-scheduled replay loop ------------------------------------
    def _run_scheduled(self, trace: List[Request],
                       sched) -> ServeResult:
        """The same arrive->admit->route->prefill->decode lifecycle,
        with the scheduler owning the waiting set: it orders admission
        (priority above weighted fair queueing), sheds what cannot meet
        its deadline (at enqueue under a queue bound, at selection once
        infeasible), clamps budgets through degradation tiers, and the
        engine times out RUNNING rows past their deadline through the
        same eviction path ``cancel_after`` uses."""
        self._validate(trace)
        sched.reset()
        clock = self._make_clock()
        tr = self._make_tracer(clock)
        costs = self.fixed_costs or {}
        est_kw = {}
        if "prefill_unit" in costs:
            # per-chunk clock pricing -> per-chunk admission pricing
            # (the feasibility check then sees exactly what the clock
            # will charge, cached chunks excluded)
            est_kw = {"prefill_unit": costs["prefill_unit"],
                      "chunk_tokens": self.chunk_C}
        est = ServiceEstimator(prefill=costs.get("prefill", 1.0),
                               decode=costs.get("decode", 1.0),
                               **est_kw)
        mon = self._make_monitor()
        self._wire_spec_overload(mon, sched)
        self._wire_pressure(mon, sched)
        m = MetricsCollector(monitor=mon)
        book = PagedKVCache(self.n_pool_pages, self.page_size,
                            kv_heads=1, head_dim=1, device="cpu")
        self._note_pool(book, m)
        hst = self._arm_hostmem(book, clock, m, tr)
        acache = self._make_adapter_cache()
        gcache = self._make_grammar_cache()
        spst = self._make_spec_state()
        qst = self._make_quant_state()
        ahst = self._make_ahead_state()
        run_w0 = time.perf_counter()
        pages_total = len(book._free)
        pending = deque(sorted(trace, key=lambda r: (r.arrival, r.rid)))
        active: Dict[str, _PagedRow] = {}
        lane = deque() if self.prefill_chunk_budget is not None \
            else None
        free_slots = list(range(self.slots))
        outputs: Dict[str, List[int]] = {}
        decisions: List[dict] = []
        slot_log: List[tuple] = []
        prefix_cached: Dict[str, int] = {}
        shed_log: Dict[str, str] = {}
        seen_groups: set = set()
        prefill_tokens = 0
        inv_ok = True
        a_inv = True
        g_inv = True
        expect_churn = self._expect_churn if self._expect_churn \
            is not None else any(r.cancel_after is not None
                                 for r in trace)
        ctx_base = {"capacity": self.slots, "expect_churn": expect_churn}

        def _shed(pairs):
            for r, reason in pairs:
                t = clock.now()
                m.on_shed(r.rid, t, reason)
                shed_log[r.rid] = reason
                self._ctr_shed.inc()
                if acache is not None:
                    acache.forget_pending(r.rid)
                if gcache is not None:
                    gcache.forget_pending(r.rid)
                if hst is not None and r.rid in hst["preempted"]:
                    # a preempted request shed while requeued: its
                    # pinned chain will never page back in — release
                    # the arena bytes (the partial stream it was
                    # served survives via _stitch_resumes)
                    hst["preempted"].discard(r.rid)
                    book.drop_spilled_owner(r.rid)
                if tr is not None:
                    tr.instant("shed", t=t, track="scheduler",
                               rid=r.rid, reason=reason,
                               tenant=r.tenant)
                self._req_close(tr, r, t, "shed", 0, reason=reason)
            return bool(pairs)

        prev_tr = obs_trace.active()
        if tr is not None:
            obs_trace.activate(tr)
        try:
            while pending or sched.waiting() or active or lane:
                now = clock.now()
                while pending and pending[0].arrival <= now + 1e-12:
                    r = pending.popleft()
                    m.on_arrival(r.rid, r.arrival, tenant=r.tenant,
                                 priority=r.priority,
                                 deadline_ms=r.deadline_ms)
                    self._ctr_arrived.inc()
                    self._req_open(tr, r)
                    _shed(sched.enqueue(r, now))
                m.on_queue_depth(now, sched.waiting())
                if tr is not None:
                    tr.counter("queue_depth", sched.waiting(), t=now)
                progressed = _shed(sched.shed_expired(now))

                if sched.waiting() and self._sched_ready(sched, pending,
                                                         active, clock):
                    dec = sched.select(now,
                                       max_batch=self.admission.max_batch,
                                       est=est,
                                       decode_chunk=self.decode_chunk,
                                       match_prefix=(book.match_prefix
                                                     if self.prefix_cache
                                                     else None),
                                       backlog_cost=(
                                           self._lane_backlog_cost(
                                               lane, est)
                                           if lane else 0.0))
                    progressed |= _shed(dec.shed)
                    # the scheduler's priority/WFQ order is kept as-is:
                    # its feasibility estimates assumed it, and a cache
                    # reorder could hand a scarce slot to a lower class
                    # (cache awareness is in the select() pricing)
                    wave = dec.wave
                    if wave:
                        groups = [r.prefix_group for r in wave
                                  if r.prefix_group is not None]
                        shared = (len(groups) != len(set(groups))
                                  or any(g in seen_groups
                                         for g in groups))
                        ctx = dict(ctx_base, shared_prefix=shared,
                                   active_paged=len(active)
                                   + (len(lane) if lane else 0))
                        backend, reason = self.policy.route(wave, ctx)
                        decision = {
                            "t": round(clock.now(), 6), "wave": len(wave),
                            "prompt_lens": [len(r.prompt) for r in wave],
                            "backend": backend, "rule": reason,
                            "rids": [r.rid for r in wave]}
                        if backend == "dense":
                            decisions.append(decision)
                            self._wave_instant(tr, decision)
                            seen_groups.update(g for g in groups)
                            self._commit_wave(wave, dec, sched, m,
                                              tr=tr, t=clock.now())
                            self._run_dense_wave(wave, clock, m, outputs,
                                                 timeouts=True, tr=tr)
                            progressed = True
                        else:
                            t0 = clock.now()
                            n_adm, n_chunks, ptoks = self._admit_paged(
                                wave, book, clock, m, active, free_slots,
                                slot_log, prefix_cached, seen_groups,
                                outputs, tr=tr, lane=lane,
                                acache=acache, spst=spst, hst=hst,
                                gcache=gcache)
                            prefill_tokens += ptoks
                            if n_adm:
                                dt = clock.now() - t0
                                est.observe("prefill", dt / n_adm)
                                if n_chunks and "prefill_unit" \
                                        in est.costs:
                                    est.observe("prefill_unit",
                                                dt / n_chunks)
                                self._commit_wave(wave[:n_adm], dec,
                                                  sched, m, tr=tr,
                                                  t=clock.now())
                                decision["admitted"] = n_adm
                                decisions.append(decision)
                                self._wave_instant(tr, decision)
                                progressed = True
                            elif hst is not None and active \
                                    and self._preempt_turn(
                                        wave[0], book, clock, m,
                                        active, free_slots, slot_log,
                                        sched, hst, _shed, tr=tr,
                                        acache=acache, gcache=gcache):
                                # the rung between degrade and shed:
                                # a fully blocked wave swaps ONE
                                # lower-priority running row out to
                                # the arena; the blocked request
                                # stays queued and admits next turn
                                # into the freed slot/pages
                                progressed = True
                            elif not active and not lane:
                                raise RuntimeError(
                                    f"pool/slot config too small for "
                                    f"{wave[0].rid} (free pages "
                                    f"{len(book._free)}, free slots "
                                    f"{len(free_slots)})")

                if active:
                    t0 = clock.now()
                    self._paged_chunk(book, clock, m, active, free_slots,
                                      slot_log, outputs, tr=tr,
                                      acache=acache, spst=spst,
                                      ahst=ahst, gcache=gcache)
                    est.observe("decode", clock.now() - t0)
                    t = clock.now()
                    for sid in list(active):
                        dl = active[sid].req.deadline_time()
                        if dl is not None and t > dl + 1e-9:
                            self._finish_paged(sid, book, clock, m,
                                               active, free_slots,
                                               slot_log, outputs,
                                               timeout=True, tr=tr,
                                               acache=acache,
                                               gcache=gcache)
                    progressed = True

                if lane:
                    _, ptoks = self._lane_step(
                        lane, book, clock, m, active, free_slots,
                        slot_log, outputs, prefix_cached, seen_groups,
                        tr=tr, acache=acache, spst=spst,
                        gcache=gcache)
                    prefill_tokens += ptoks
                    self._lane_timeouts(lane, book, clock, m,
                                        free_slots, slot_log, outputs,
                                        tr=tr, acache=acache,
                                        gcache=gcache)
                    progressed = True

                if not progressed and not active:
                    targets = []
                    if pending:
                        targets.append(pending[0].arrival)
                    if sched.waiting():
                        targets.append(sched.oldest_arrival()
                                       + self.admission.max_delay)
                    if not targets:
                        break  # everything left this turn was shed
                    clock.advance_to(min(targets))
                self._quant_turn(book, m, clock, tr, qst)
                inv_ok &= book.census_ok()
                if acache is not None:
                    a_inv &= acache.census_ok()
                if gcache is not None:
                    g_inv &= gcache.census_ok()
                if self._ledger is not None:
                    self._ledger.sample_occupancy(
                        clock.label, book=book, acache=acache,
                        gcache=gcache,
                        arena=getattr(book, "_arena", None))
        finally:
            if tr is not None:
                if prev_tr is not None:
                    obs_trace.activate(prev_tr)
                else:
                    obs_trace.deactivate()
        cost_stats = self._cost_result(clock, tr, m)
        self._close_trace(tr)
        self._stitch_resumes(outputs, hst)
        return ServeResult(policy=self.policy.name, outputs=outputs,
                           metrics=m, decisions=decisions,
                           slot_log=slot_log,
                           prefix_cached=prefix_cached,
                           pages_total=pages_total,
                           pages_free_end=(len(book._free)
                                           + len(book._evictable)),
                           scheduler=sched.name, shed=shed_log,
                           trace=tr, prefill_tokens=prefill_tokens,
                           cache_stats=dict(book.cache_stats(),
                                            invariant_ok=inv_ok),
                           incidents=self._bank_incidents(mon),
                           adapter_stats=(
                               None if acache is None else
                               dict(acache.cache_stats(),
                                    invariant_ok=a_inv)),
                           spec_stats=(None if spst is None
                                       else spst.stats()),
                           kv_quant_stats=self._quant_result(book,
                                                             qst),
                           overhead=self._overhead_row(clock, run_w0),
                           hostmem_stats=self._hostmem_result(book,
                                                              hst),
                           pages_spilled=(
                               None if hst is None else
                               book.cache_stats().get(
                                   "spilled_pages", 0)),
                           grammar_stats=(
                               None if gcache is None else
                               dict(gcache.cache_stats(),
                                    invariant_ok=g_inv)),
                           cost_stats=cost_stats)

    def _commit_wave(self, admitted, dec, sched, m, tr=None, t=0.0):
        """Charge the fair-queue tags for what actually ran (the
        degraded budget when a tier fired) and record degradations
        only then — a wave member blocked on slots stays queued,
        uncharged, and may re-degrade differently next turn. With a
        cost ledger armed, the scheduler's admission price is banked
        on the request's account here — commit is the moment the
        estimate became a promise — feeding the estimator-vs-actual
        calibration report."""
        for r in admitted:
            sched.commit(r.rid, budget=r.max_new_tokens)
            if self._ledger is not None:
                priced = sched.priced(r.rid) \
                    if hasattr(sched, "priced") else None
                if priced is not None:
                    self._ledger.note_estimate(r.rid, priced)
            if r.rid in dec.degraded:
                b, b0 = dec.degraded[r.rid]
                m.on_degrade(r.rid, b, b0)
                if tr is not None:
                    tr.instant("degrade", t=t, track="scheduler",
                               rid=r.rid, budget=b, orig_budget=b0,
                               tenant=r.tenant)

    def _sched_ready(self, sched, pending, active, clock) -> bool:
        if sched.waiting() >= self.admission.max_batch:
            return True
        # same-rounding rule as _admission_ready (see comment there)
        if clock.now() >= sched.oldest_arrival() \
                + self.admission.max_delay - 1e-12:
            return True
        return not pending and not active

    def _preempt_turn(self, blocked, book, clock, m, active,
                      free_slots, slot_log, sched, hst, shed_fn,
                      tr=None, acache=None, gcache=None) -> bool:
        """The QoS rung between degrade and shed: a wave the pool/slots
        fully blocked asks the scheduler for ONE strictly-lower-priority
        running victim, swaps its chain out to the host arena (pinned
        under its rid — the only K/V copy), releases its slot and pages,
        and requeues it carrying its emitted tokens (the
        resume-from-prefix arithmetic; re-admission swaps the chain
        back in instead of recomputing it). One victim per turn keeps
        the actuation deterministic and observable. Returns True when
        a victim actually swapped out."""
        running = [(sid, row.req, len(row.out))
                   for sid, row in active.items()]
        vic = sched.preempt_victim(clock.now(), blocked, running)
        if vic is None:
            return False
        row = active[vic]
        r = row.req
        keep = len(row.out)
        # the resumed request must still fit one slot (padded longer
        # prompt + remaining budget) — decline otherwise
        if self._footprint_len(len(r.prompt) + keep,
                               r.max_new_tokens - keep) > self.max_len:
            return False
        history = list(r.prompt) + list(row.out)
        keys = book.spill_chain(vic, history, owner=vic)
        if not keys and int(book.lengths.get(vic, 0)) >= self.page_size:
            # the arena refused (atomically — nothing moved): a swap
            # that would DISCARD the chain is a worse shed, so the
            # victim keeps decoding and the blocked request waits for
            # ordinary finishes
            return False
        # tear the row down WITHOUT finishing it: pages freed (their
        # content is safe in the arena), slot released, no on_finish —
        # the request is still live, just queued again
        active.pop(vic)
        book.free(vic)
        self._g_resident.set(float(len(book._refs)))
        if acache is not None and r.adapter is not None:
            acache.release(r.adapter, vic)
            self._note_adapters(acache, m, clock.now())
        if gcache is not None and row.gname is not None:
            # the automaton pin rolls off with the row; the DFA state
            # itself needs no spill — re-admission re-walks it from
            # the resume prefix (host arithmetic, no device work)
            gcache.release(row.gname, vic)
        free_slots.append(row.slot)
        free_slots.sort()
        t = clock.now()
        slot_log.append((round(t, 6), "release", vic, row.slot))
        hst["preempts"] += 1
        self._ctr_preempts.inc()
        m.on_preempt(vic, t, emitted=keep)
        hst["resume_prefix"][vic] = (hst["resume_prefix"].get(vic, [])
                                     + list(row.out))
        hst["preempted"].add(vic)
        if tr is not None:
            tr.add_span(vic, row.t0, t - row.t0,
                        track=f"slot/{row.slot}", backend="paged")
            tr.instant("preempt", t=t, track="scheduler", rid=vic,
                       emitted=keep, pages_spilled=len(keys),
                       tenant=r.tenant)
        res = dataclasses.replace(
            r, prompt=tuple(history),
            max_new_tokens=r.max_new_tokens - keep,
            cancel_after=(max(1, r.cancel_after - keep)
                          if r.cancel_after is not None else None))
        shed_fn(sched.enqueue(res, t))
        return True

    # --- paged backend ----------------------------------------------------
    def _admit_paged(self, wave, book, clock, m, active, free_slots,
                     slot_log, prefix_cached, seen_groups, outputs,
                     tr=None, lane=None, sink=None, acache=None,
                     spst=None, hst=None, gcache=None):
        """Returns (admitted, prefill chunks computed, prefill tokens
        computed) for this wave. With ``lane`` (the async prefill
        lane), admission only RESERVES — pages, slot, bookkeeping —
        and parks the request in the lane; its chunks run later under
        ``_lane_step``'s per-turn budget, so this wave's prefill never
        stalls the decode batch (chunk counts are then accounted by
        the lane steps, not here). ``sink`` is the prefill-role
        handoff interceptor (see ``_prefill_complete``). ``acache``
        (multi-model serving): admission PINS the request's adapter
        in the device bank — a resident adapter is a free hit, a miss
        pays one paced ``adapter_upload`` on the virtual clock, and a
        bank whose every slot is pinned by in-flight rows requeues
        the wave exactly like a page-pool refusal."""
        admitted = 0
        chunks_done = 0
        tokens_done = 0
        for r in wave:
            if not free_slots:
                break
            sid = r.rid
            # adapter residency FIRST (it is the cheapest refusal):
            # pin-while-in-flight guarantees the bank slot outlives
            # this row; a rolled-back page allocate below releases
            # the pin so the requeue retries from a clean slate
            aslot, a_up = 0, False
            if acache is not None and r.adapter is not None:
                try:
                    # a miss's host->device upload runs INSIDE the
                    # timed wrapper: paced per upload on the fixed
                    # clock, real transfer time attributed to the
                    # adapter_upload span on the measured one (a
                    # later page-refusal retry HITS and never
                    # re-pays). Hit/upload COUNTING waits for the
                    # admission to actually succeed — see
                    # took_upload below.
                    aslot, a_up = acache.acquire(
                        r.adapter, sid,
                        timed=lambda f: self._timed(
                            tr, clock, "adapter_upload", f, rid=sid,
                            adapter=r.adapter))
                except MemoryError:
                    break  # every slot pinned: requeue, retry as
                    # rows finish and release their pins
            # grammar residency SECOND (same pin discipline, one tier
            # over): a resident automaton is a free hit, a miss pays
            # one paced grammar_compile (host DFA compile + mask-bank
            # upload), and a bank whose every slot is pinned requeues
            # the wave — rolling back the adapter pin first
            gname = self._schema_of(r) if gcache is not None else None
            gslot, g_up, gaut = 0, False, None
            if gname is not None:
                try:
                    gslot, g_up = gcache.acquire(
                        gname, sid,
                        timed=lambda f: self._timed(
                            tr, clock, "grammar_compile", f, rid=sid,
                            schema=gname))
                except MemoryError:
                    if acache is not None and r.adapter is not None:
                        acache.note_rollback(r.adapter, sid, a_up)
                    break
                gaut = gcache.automaton(gname)
            # AUTOMATIC prefix acquisition: every request probes the
            # pool's chain-hashed page cache (page-aligned exact match
            # gives token-level sharing with no trace tag;
            # prefix_group stays a routing hint only). A failed
            # allocate below MUST release these shared refs — the
            # free() in the except arm is the leak-proof rollback,
            # returning revived pages to the evictable pool so the
            # requeue retries from a clean slate.
            n_cached = 0
            if self.prefix_cache:
                n_cached = book.acquire_prefix(sid, list(r.prompt))
                if hst is not None:
                    # PRICED page-in: the spilled extension of the
                    # resident match swaps back into fresh device
                    # pages (one kv_pagein each) and counts as cached
                    # — the prefill resumes past it exactly as past a
                    # resident hit. A preempted request's swapped
                    # chain restores through this same path.
                    n_cached += book.page_in(
                        sid, list(r.prompt), n_cached,
                        lambda p, e, _s=sid: self._pagein_page(
                            p, e, _s, clock, m, tr, hst))
            ev0 = book._stats["evictions"]
            try:
                book.allocate(sid, self._footprint(r))
            except MemoryError:
                if self.prefix_cache:
                    # shared refs released, revived pages re-parked,
                    # hit/lookup stats unwound (the requeue must not
                    # inflate hit_rate)
                    book.rollback_acquire(sid, list(r.prompt))
                else:
                    book.free(sid)
                if acache is not None and r.adapter is not None:
                    # the adapter pin rolls back too; the upload — if
                    # one ran — stays resident (the retry hits) and
                    # is REMEMBERED so the successful admission still
                    # reports it as this request's upload
                    acache.note_rollback(r.adapter, sid, a_up)
                if gname is not None:
                    # same discipline for the automaton pin: the
                    # compile — if one ran — stays resident and is
                    # remembered for the retry's attribution
                    gcache.note_rollback(gname, sid, g_up)
                break
            d_ev = book._stats["evictions"] - ev0
            if d_ev:
                self._ctr_prefix_evictions.inc(d_ev)
                if tr is not None:
                    tr.instant("prefix_evict", t=clock.now(),
                               track="engine", pages=d_ev, rid=sid)
            book.lengths[sid] = len(r.prompt)
            if hst is not None and sid in hst["preempted"]:
                # the preempted request is BACK: leftover pinned pages
                # demote to ordinary spilled cache (the page-ins above
                # already priced the swap-in; whatever the pool could
                # not take re-prefills below, same tokens either way)
                hst["preempted"].discard(sid)
                book.unpin_spilled_owner(sid)
                hst["restores"] += 1
                self._ctr_restores.inc()
                m.on_restore(sid, clock.now())
                if tr is not None:
                    tr.instant("restore", t=clock.now(),
                               track="scheduler", rid=sid,
                               tenant=r.tenant)
            slot = free_slots.pop(0)
            T = self._pad_len(len(r.prompt))
            toks = np.zeros((1, T), np.int32)
            toks[0, :len(r.prompt)] = r.prompt
            pt = np.zeros((1, self.W), np.int32)
            table = book.tables[sid]
            pt[0, :len(table)] = table
            lens = np.asarray([len(r.prompt)], np.int32)
            resume = (n_cached // self.chunk_C) * self.chunk_C
            # the factory clamps resume so the FINAL chunk always runs
            # (last-position logits) — charge the clock for what it
            # actually computes
            n_chunks = (T - min(resume, T - self.chunk_C)) \
                // self.chunk_C
            # per-request adaptive spec verdict, decided ONCE at
            # admission (the policy's spec_route rule): the row's
            # route for its whole lifetime, modulo the run-level
            # enable gate
            sp = False
            if spst is not None:
                sp, _sp_rule = self.policy.spec_route(r, spst.cfg)
            if gaut is not None:
                # a constrained row always decodes PLAIN: the draft
                # proposes unmasked tokens the verify would reject
                # almost surely, and acceptance bookkeeping under a
                # mask would fork the emission rule — free rows in
                # the same wave keep their spec verdict
                sp = False
            # DFA state the first emitted token is masked by: the
            # start state, or — for a preempted request swapping back
            # in — the state its already-served tokens walked to (the
            # resume prefix is exactly the emitted stream)
            gstate = 0
            if gaut is not None:
                gstate = gaut.start
                if hst is not None and hst["resume_prefix"].get(sid):
                    gstate = gaut.walk(hst["resume_prefix"][sid])
            t_admit = clock.now()
            m.on_admit(sid, t_admit, "paged")
            if gname is not None:
                # one hit-or-compile event per ADMISSION, the
                # took_upload discipline: a compile paid by a
                # rolled-back earlier acquire is attributed here
                g_up = gcache.took_compile(sid, g_up)
                (self._ctr_grammar_compiles if g_up
                 else self._ctr_grammar_hits).inc()
                m.on_grammar(sid, gname, hit=not g_up)
            if acache is not None and r.adapter is not None:
                # one hit-or-upload event per ADMISSION: an upload
                # paid by a rolled-back earlier acquire is attributed
                # here, so every counter surface (registry, report,
                # cache_stats) tells the same story
                a_up = acache.took_upload(sid, a_up)
                (self._ctr_adapter_uploads if a_up
                 else self._ctr_adapter_hits).inc()
                m.on_adapter(sid, r.adapter, hit=not a_up)
            if tr is not None:
                attrs = {} if r.adapter is None \
                    else {"adapter": r.adapter}
                if spst is not None:
                    # the admit instant carries the verdict ONLY on
                    # spec-configured runs, so plain traces keep
                    # their event args exactly
                    attrs["spec"] = sp
                if gname is not None:
                    # schema tag ONLY on constrained rows — free rows
                    # and grammar-less runs keep their event args
                    # exactly (the trace_report waterfall reads it)
                    attrs["schema"] = gname
                tr.instant("admit", t=t_admit,
                           track=self._tenant_track(r), rid=sid,
                           backend="paged", slot=slot, cached=n_cached,
                           **attrs)
            if lane is not None:
                lane.append(_PrefillingRow(r, slot, t_admit, n_cached,
                                           resume, T, self.chunk_C,
                                           toks, pt, aslot=aslot,
                                           spec=sp, gslot=gslot,
                                           gname=gname, gaut=gaut,
                                           gstate=gstate))
                admitted += 1
                continue

            def _call(toks=toks, pt=pt, lens=lens, resume=resume,
                      aslot=aslot, gslot=gslot, gstate=gstate):
                arr = self._arr
                kw = {}
                if acache is not None:
                    kw["lora"] = self._lora_arg(acache, [aslot])
                if gcache is not None:
                    kw["grammar"] = self._grammar_arg(
                        gcache, [gcache.flat_id(gslot, gstate)
                                 if gslot else 0])
                return self._p_prefill(
                    self._p_outer, self._p_layers, arr(toks),
                    arr(pt), arr(lens), self._pools,
                    resume_from=resume, **kw)
            first, self._pools = self._timed(
                tr, clock, "prefill", _call, jitfn=self._p_prefill,
                rid=sid, units=n_chunks, resume=resume,
                cached=n_cached, **self._tp_attr)
            first_tok = int(_host(first)[0])
            chunks_done += n_chunks
            tokens_done += n_chunks * self.chunk_C
            self._prefill_complete(r, slot, first_tok, n_cached,
                                   resume, T, book, clock, m, active,
                                   free_slots, slot_log, outputs,
                                   prefix_cached, seen_groups, tr=tr,
                                   t0=t_admit, t_admit=t_admit,
                                   sink=sink, acache=acache,
                                   aslot=aslot, spst=spst,
                                   spec_row=sp, gcache=gcache,
                                   gslot=gslot, gname=gname,
                                   gaut=gaut, gstate=gstate)
            admitted += 1
        if admitted:
            self._g_resident.set(float(len(book._refs)))
            self._note_adapters(acache, m, clock.now())
        return admitted, chunks_done, tokens_done

    def _prefill_complete(self, r, slot, first_tok, n_cached, resume,
                          T, book, clock, m, active, free_slots,
                          slot_log, outputs, prefix_cached,
                          seen_groups, tr, t0, t_admit, sink=None,
                          acache=None, aslot=0, spst=None,
                          spec_row=False, gcache=None, gslot=0,
                          gname=None, gaut=None, gstate=0):
        """Everything that happens the moment a request's prompt pages
        hold real K/V: publish them for prefix sharing, account the
        cache hit, then either enter the decode slot (the default),
        finish outright (eos / a 1-token budget at the first token),
        or — when ``sink`` (a prefill-role session's handoff exporter)
        takes the row — hand the KV chain off instead of decoding.
        ``t0`` is the slot-occupancy span start: the admit time in the
        interleaved loop (whose slot span covers the prefill), the
        decode-entry time under the async lane (whose ``prefill_lane``
        span covers admit→here instead)."""
        sid = r.rid
        if self.prefix_cache:
            book.register_prefix(sid, list(r.prompt))
        if r.prefix_group is not None:
            seen_groups.add(r.prefix_group)
        if n_cached:
            self._ctr_prefix_hits.inc(n_cached)
        m.on_prefix(sid, cached=n_cached,
                    saved=min(resume, T - self.chunk_C),
                    prompt=len(r.prompt))
        prefix_cached[sid] = n_cached
        # a row joins the spec path only if the route is LIVE at its
        # prefill: a parked route (overload) or a latched one would
        # decode it plain — running the draft walk anyway would waste
        # compute on a row whose first plain turn demotes it (see
        # _paged_chunk), and skipping the walk while still flagging
        # it spec would hand the draft an unwarmed pool. A
        # prefill-ROLE session (sink set) never specs either: its
        # rows hand off to a decode worker that recreates them plain,
        # so a draft walk here would be compute the fleet never
        # cashes (disaggregated spec is future work).
        sp = bool(spec_row and spst is not None and spst.enabled
                  and not spst.latched and sink is None
                  and gaut is None)
        if sp:
            self._spec_prefill_row(r, book, T, clock, tr)
        row = _PagedRow(r, slot, first_tok, t0=t0, aslot=aslot,
                        spec=sp, prev=int(r.prompt[-1]), gslot=gslot,
                        gname=gname, gaut=gaut, gstate=gstate)
        g_mf = 0.0
        if gaut is not None:
            # the first token was emitted under gstate's mask — step
            # the DFA host-side; acceptance ends the stream like eos
            g_mf = gaut.masked_frac(gstate)
            row.gmasked += g_mf
            row.gstate = gaut.step(gstate, first_tok)
        done = len(row.out) >= row.eff \
            or first_tok == self.eos_token_id \
            or (gaut is not None and gaut.accepts_at(row.gstate))
        # a request DONE at its first token never hands off — the
        # stream is complete where it stands, there is no decode
        # phase to move
        if sink is not None and not done \
                and sink(r, slot, first_tok, n_cached, t_admit):
            return None
        active[sid] = row
        slot_log.append((round(clock.now(), 6), "acquire", sid, slot))
        t_first = clock.now()
        m.on_tokens(sid, t_first, 1)
        self._ctr_tokens.inc()
        if gaut is not None:
            m.on_grammar_tokens(1, g_mf)
            if gaut.accepts_at(row.gstate):
                m.on_grammar_accept(sid, t_first)
                if tr is not None:
                    tr.instant("grammar_accept", t=t_first,
                               track=self._tenant_track(r), rid=sid,
                               schema=gname)
        if tr is not None:
            tr.instant("first_token", t=t_first,
                       track=self._tenant_track(r), rid=sid)
        if done:
            self._finish_paged(sid, book, clock, m, active,
                               free_slots, slot_log, outputs, tr=tr,
                               acache=acache, gcache=gcache)
        return row

    def _lane_step(self, lane, book, clock, m, active, free_slots,
                   slot_log, outputs, prefix_cached, seen_groups,
                   tr=None, sink=None, acache=None, spst=None,
                   gcache=None):
        """Run up to ``prefill_chunk_budget`` prefill chunks from the
        lane, SHORTEST-REMAINING-FIRST (admission order breaking
        ties): a one-chunk prompt reaches its first token in one lane
        turn instead of queueing behind a long prompt's whole chunk
        walk — head-of-line blocking is exactly the TTFT tax the lane
        exists to remove. Starvation is BOUNDED by aging: an entry
        passed over ``_LANE_STARVE_LIMIT`` consecutive times runs its
        next chunk regardless, so a long prefill drains at >= 1 chunk
        per (limit+1) chunks even under a sustained stream of short
        arrivals. Each chunk is ONE bounded call into the
        chunked-prefill program — the prompt sliced to the chunk
        boundary with ``lengths`` clamped to it — which computes
        exactly what the monolithic prefill computes for those
        positions (causal attention never looks past the chunk, so
        greedy tokens are bit-equal); a request's own chunks still
        run in order, and its final chunk passes the true length and
        yields the real first-token logits. Fixed-clock pricing: with
        a ``prefill_unit`` entry each chunk costs one unit; with only
        a flat per-call cost, that cost is split EVENLY across the
        request's chunk calls, so the lane charges the same total the
        monolithic call would (an N-chunk prompt must not become N
        times pricier just because the lane bounds its calls).
        Returns (chunks computed, prompt tokens computed)."""
        if self.ragged_prefill:
            return self._lane_step_ragged(
                lane, book, clock, m, active, free_slots, slot_log,
                outputs, prefix_cached, seen_groups, tr=tr, sink=sink,
                acache=acache, spst=spst, gcache=gcache)
        C = self.chunk_C
        chunks_run = 0
        tokens_run = 0
        flat = self.clock_mode == "fixed" \
            and "prefill_unit" not in (self.fixed_costs or {})
        while lane and chunks_run < self.prefill_chunk_budget:
            oldest = min(lane, key=lambda x: (x.t_admit, x.req.rid))
            if oldest.skipped >= self._LANE_STARVE_LIMIT:
                e = oldest
            else:
                e = min(lane, key=lambda x: (x.remaining_chunks(),
                                             x.t_admit, x.req.rid))
            if e is oldest:
                oldest.skipped = 0
            else:
                oldest.skipped += 1
            sid = e.req.rid
            k = e.next_chunk
            final = (k + 1 == e.n_chunks)
            toks = e.toks[:, :(k + 1) * C]
            lens = np.asarray(
                [len(e.req.prompt) if final else (k + 1) * C],
                np.int32)

            def _call(toks=toks, pt=e.pt, lens=lens, resume=k * C,
                      aslot=e.aslot, gslot=e.gslot, gstate=e.gstate):
                arr = self._arr
                kw = {}
                if acache is not None:
                    kw["lora"] = self._lora_arg(acache, [aslot])
                if gcache is not None:
                    # only the FINAL chunk's logits are harvested, so
                    # masking every chunk with the row's current gid
                    # is exact (intermediate chunks discard theirs)
                    kw["grammar"] = self._grammar_arg(
                        gcache, [gcache.flat_id(gslot, gstate)
                                 if gslot else 0])
                return self._p_prefill(
                    self._p_outer, self._p_layers, arr(toks),
                    arr(pt), arr(lens), self._pools,
                    resume_from=resume, **kw)
            first, self._pools = self._timed(
                tr, clock, "prefill", _call, jitfn=self._p_prefill,
                rid=sid, units=1, chunk=k, of=e.n_chunks,
                cost=((self.fixed_costs or {}).get("prefill", 1.0)
                      / e.run_chunks if flat else None),
                **self._tp_attr)
            e.next_chunk += 1
            chunks_run += 1
            tokens_run += C
            if not final:
                continue
            lane.remove(e)
            t_done = clock.now()
            if tr is not None:
                tr.add_span(sid, e.t_admit, t_done - e.t_admit,
                            track="prefill_lane", cached=e.n_cached)
            self._prefill_complete(
                e.req, e.slot, int(_host(first)[0]), e.n_cached,
                e.resume, e.T, book, clock, m, active, free_slots,
                slot_log, outputs, prefix_cached, seen_groups, tr=tr,
                t0=t_done, t_admit=e.t_admit, sink=sink,
                acache=acache, aslot=e.aslot, spst=spst,
                spec_row=e.spec, gcache=gcache, gslot=e.gslot,
                gname=e.gname, gaut=e.gaut, gstate=e.gstate)
        if self._g_lane_depth is not None:
            self._g_lane_depth.set(float(len(lane)))
        m.on_lane_depth(clock.now(), len(lane))
        if tr is not None:
            tr.counter("prefill_lane_depth", len(lane), t=clock.now())
        return chunks_run, tokens_run

    def _lane_step_ragged(self, lane, book, clock, m, active,
                          free_slots, slot_log, outputs, prefix_cached,
                          seen_groups, tr=None, sink=None, acache=None,
                          spst=None, gcache=None):
        """The FUSED lane turn: every parked request's next pending
        chunk rides ONE fixed-shape ragged dispatch (row index = the
        request's reserved decode slot; per-row chunk tokens, resume
        offsets and lengths as jit data, so the program cache stays
        flat across admission mixes). ``prefill_chunk_budget`` bounds
        fused DISPATCHES per turn — a burst of k admissions advances
        k chunks per dispatch instead of queueing behind the serial
        chunk loop, which is exactly the burst-TTFT tax this path
        removes. No entry is ever passed over (the whole lane
        advances together), so the per-chunk path's anti-starvation
        aging bound holds trivially and ``skipped`` stays 0. Pricing
        is chunk-for-chunk identical to the per-chunk path: with a
        ``prefill_unit`` entry the dispatch charges one unit per
        fused chunk; with only a flat per-call cost it charges the
        SUM of each fused row's even per-chunk split. A request's own
        chunks still run in order (one per dispatch), and rows whose
        FINAL chunk ran complete individually — prefill-role sessions
        export each finished row's KVHandoff exactly as before.
        Returns (dispatches run, prompt tokens computed)."""
        C = self.chunk_C
        R = self.slots
        dispatches = 0
        tokens_run = 0
        flat = self.clock_mode == "fixed" \
            and "prefill_unit" not in (self.fixed_costs or {})
        while lane and dispatches < self.prefill_chunk_budget:
            picked = sorted(lane, key=lambda x: (x.t_admit, x.req.rid))
            toks = np.zeros((R, C), np.int32)
            starts = np.zeros((R,), np.int32)
            pt = np.zeros((R, self.W), np.int32)
            # idle rows ride as plain causal garbage over the reserved
            # page 0 (length C, start 0) — NOT length 0, which would
            # fully mask their attention rows
            lens = np.full((R,), C, np.int32)
            aids = np.zeros((R,), np.int32) if acache is not None \
                else None
            gids = np.zeros((R,), np.int32) if gcache is not None \
                else None
            finals = []
            for e in picked:
                e.skipped = 0
                k = e.next_chunk
                final = (k + 1 == e.n_chunks)
                toks[e.slot] = e.toks[0, k * C:(k + 1) * C]
                starts[e.slot] = k * C
                pt[e.slot] = e.pt[0]
                lens[e.slot] = len(e.req.prompt) if final \
                    else (k + 1) * C
                if aids is not None:
                    aids[e.slot] = e.aslot
                if gids is not None and e.gslot:
                    gids[e.slot] = gcache.flat_id(e.gslot, e.gstate)
                if final:
                    finals.append(e)

            def _call(toks=toks, starts=starts, pt=pt, lens=lens,
                      aids=aids, gids=gids):
                arr = self._arr
                kw = {}
                if acache is not None:
                    kw["lora"] = self._lora_arg(acache, aids)
                if gcache is not None:
                    kw["grammar"] = self._grammar_arg(gcache, gids)
                return self._p_prefill_ragged(
                    self._p_outer, self._p_layers, arr(toks),
                    arr(starts), arr(pt), arr(lens), self._pools,
                    **kw)
            firsts, self._pools = self._timed(
                tr, clock, "prefill", _call,
                jitfn=self._p_prefill_ragged, units=len(picked),
                ragged=len(picked),
                cost=([(self.fixed_costs or {}).get("prefill", 1.0)
                       / e.run_chunks for e in picked]
                      if flat else None),
                rids=[e.req.rid for e in picked],
                **self._tp_attr)
            if self._ledger is not None:
                for e in picked:
                    self._ledger.tag(e.req.rid, "ragged")
            firsts = _host(firsts)
            for e in picked:
                e.next_chunk += 1
            dispatches += 1
            tokens_run += C * len(picked)
            t_done = clock.now()
            for e in finals:
                sid = e.req.rid
                lane.remove(e)
                if tr is not None:
                    tr.add_span(sid, e.t_admit, t_done - e.t_admit,
                                track="prefill_lane",
                                cached=e.n_cached)
                self._prefill_complete(
                    e.req, e.slot, int(firsts[e.slot]), e.n_cached,
                    e.resume, e.T, book, clock, m, active, free_slots,
                    slot_log, outputs, prefix_cached, seen_groups,
                    tr=tr, t0=t_done, t_admit=e.t_admit, sink=sink,
                    acache=acache, aslot=e.aslot, spst=spst,
                    spec_row=e.spec, gcache=gcache, gslot=e.gslot,
                    gname=e.gname, gaut=e.gaut, gstate=e.gstate)
        if self._g_lane_depth is not None:
            self._g_lane_depth.set(float(len(lane)))
        m.on_lane_depth(clock.now(), len(lane))
        if tr is not None:
            tr.counter("prefill_lane_depth", len(lane), t=clock.now())
        return dispatches, tokens_run

    def _lane_timeouts(self, lane, book, clock, m, free_slots,
                       slot_log, outputs, tr=None, acache=None,
                       gcache=None):
        """A lane entry whose deadline passes MID-PREFILL is evicted
        exactly like a running row past deadline (reason "timeout",
        pages and slot freed) — a state the interleaved loop cannot
        reach (its prefill is atomic at admission), so only the
        QoS-scheduled async lane scans for it. The stream is empty:
        no token was ever produced."""
        t = clock.now()
        for e in list(lane):
            dl = e.req.deadline_time()
            if dl is None or t <= dl + 1e-9:
                continue
            lane.remove(e)
            sid = e.req.rid
            book.free(sid)
            self._g_resident.set(float(len(book._refs)))
            if acache is not None and e.req.adapter is not None:
                acache.release(e.req.adapter, sid)
                self._note_adapters(acache, m, t)
            if gcache is not None and e.gname is not None:
                gcache.release(e.gname, sid)
            free_slots.append(e.slot)
            free_slots.sort()
            slot_log.append((round(t, 6), "release", sid, e.slot))
            outputs[sid] = []
            m.on_finish(sid, t, evicted=True, reason="timeout")
            self._ctr_finished["timeout"].inc()
            if tr is not None:
                tr.add_span(sid, e.t_admit, t - e.t_admit,
                            track="prefill_lane", timeout=True)
            self._req_close(tr, e.req, t, "timeout", 0)

    @staticmethod
    def _lane_backlog_cost(lane, est) -> float:
        """The admission-feasibility price of the prefill work already
        COMMITTED to the lane: a new candidate's service cannot start
        before the lane drains. Per-chunk priced when the estimator
        carries a unit cost; under flat per-call pricing each entry's
        remaining cost is its flat cost pro-rated by the chunks still
        to run — exactly what ``_lane_step`` will charge the clock, so
        feasibility verdicts agree with the clock they model."""
        if not lane:
            return 0.0
        unit = est.costs.get("prefill_unit")
        if unit is not None:
            return float(unit) * sum(e.remaining_chunks()
                                     for e in lane)
        return est.prefill * sum(e.remaining_chunks() / e.run_chunks
                                 for e in lane)

    # --- KV page export/import (the cluster handoff's data plane) ---------
    def export_kv_pages(self, page_ids):
        """Gather the pool content of ``page_ids`` for a KV handoff.
        A factory may provide its own ``export_kv_pages(pools, ids)``
        (``serving.sim`` does — numpy pools); the default handles the
        real llama factory's pools, whose every leaf is page-indexed
        on axis 2 ((L, Hkv, P, page_size, ...) arrays — int8
        data+scale tuples included)."""
        fn = getattr(self.serving, "export_kv_pages", None)
        ids = list(page_ids)
        if fn is not None:
            return fn(self._pools, ids)
        return _tree_map(lambda a: a[:, :, torch.as_tensor(
            ids, dtype=torch.long, device=a.device)], self._pools)

    def import_kv_pages(self, page_ids, data):
        """Scatter a handoff's exported page content into THIS
        engine's pool at ``page_ids`` (the importer's freshly
        allocated chain). Counterpart of ``export_kv_pages``."""
        fn = getattr(self.serving, "import_kv_pages", None)
        ids = list(page_ids)
        if fn is not None:
            self._pools = fn(self._pools, ids, data)
            return
        pools, parts = _leaves(self._pools), _leaves(data)
        if len(pools) != len(parts):
            raise ValueError(f"import_kv_pages: {len(parts)} leaves for "
                             f"a pool of {len(pools)}")
        for a, d in zip(pools, parts):
            # in place: the pools are the factory's live tensors
            idx = torch.as_tensor(ids, dtype=torch.long, device=a.device)
            a[:, :, idx] = torch.as_tensor(d, device=a.device).to(a.dtype)

    # --- heterogeneous handoffs: the reshard-on-import transform ----------
    def handoff_steps(self, h: "KVHandoff"):
        """Which priced transform steps THIS engine would run to adopt
        ``h`` — the compatibility verdict that replaced the placement
        filters. Returns ``()`` for a twin (adopt as-is, the
        pre-hetero fast path, zero spans), an ordered tuple drawn from
        ``("kv_reshard", "kv_repage", "kv_transcode")`` for a
        transformable mismatch, or ``None`` for the pairings that
        still refuse:

        - a QUANTIZED source (int8 precision is unrecoverable → fp
          refused; no tier bits to lift → pressure refused; int8
          scales don't re-tier → the codec only adopts same-codec);
        - a PRESSURE chain across page geometries (its per-page tier
          bits have no token-resolution meaning, so a re-paged chain
          could not say which arena each new page reads from).

        Raises ``UnstampedHandoffError`` when the handoff never got
        its source geometry stamped — loud, instead of the pre-hetero
        silent match-nothing."""
        if int(getattr(h, "page_size", 0)) <= 0 \
                or int(getattr(h, "tp", 0)) <= 0:
            raise UnstampedHandoffError(h)
        steps = []
        if h.tp != self.tp_size:
            steps.append("kv_reshard")
        if h.page_size != self.page_size:
            if h.kv_quant == "pressure":
                return None
            steps.append("kv_repage")
        if h.kv_quant != self.kv_quant:
            if h.kv_quant is not None:
                return None
            steps.append("kv_transcode")
        return tuple(steps)

    def handoff_price(self, h: "KVHandoff", steps=None):
        """Price the transform steps this engine would run to adopt
        ``h``, in its OWN clock units — placement's scoring input.
        Mirrors ``EngineClock``'s fixed arithmetic exactly (per-page
        when the cost table carries a ``<kind>_unit`` entry, the flat
        per-call default otherwise), so the score and the charge the
        importer's clock will actually book can never disagree. The
        router adds none of this to ``t_arrive``: delivery stays
        ``kv_transfer``-priced, and the importer's clock charges the
        transform spans when the import runs — one source of truth
        per cost. ``None`` = untransformable."""
        if steps is None:
            steps = self.handoff_steps(h)
        if steps is None:
            return None
        costs = self.fixed_costs or {}
        n_dst = -(-len(h.req.prompt) // self.page_size)
        total = 0.0
        for kind in steps:
            units = h.n_pages if kind == "kv_reshard" else n_dst
            unit = costs.get(f"{kind}_unit")
            total += float(unit) * units if unit is not None \
                else float(costs.get(kind, 1.0))
        return total

    def reshard_kv_pages(self, data):
        """The ``kv_reshard`` data plane: gather an exported chain
        across the SOURCE mesh's kv-head shards into the canonical
        head-major layout. A factory may override
        (``reshard_kv_pages(data)`` — ``serving.sim``'s is the
        identity, one host array has no shards); the default pulls
        every leaf to a single host view (the cross-shard gather), and
        the import scatter re-splits it under THIS engine's own pool
        sharding (GSPMD does the distribution — the destination mesh
        width never appears in the data plane)."""
        raise _not_ported("reshard_kv_pages (a heterogeneous KV handoff)")
        fn = getattr(self.serving, "reshard_kv_pages", None)
        if fn is not None:
            return fn(data)
        return _tree_map(_host, data)

    def repage_kv_pages(self, data, page_size_from: int,
                        n_tokens: int):
        """The ``kv_repage`` data plane: refold an exported chain from
        the source page geometry to THIS engine's. Factory hook
        ``repage_kv_pages(data, ps_from, ps_to, n_tokens)`` when
        provided (the sim's token rows), the llama head-major
        arithmetic otherwise."""
        raise _not_ported("repage_kv_pages (a heterogeneous KV handoff)")
        fn = getattr(self.serving, "repage_kv_pages", None)
        if fn is not None:
            return fn(data, page_size_from, self.page_size, n_tokens)
        return repage_kv_data(data, page_size_from, self.page_size,
                              n_tokens)

    def transcode_kv_pages(self, data, quant_from):
        """The ``kv_transcode`` data plane: re-encode a full-precision
        chain into THIS engine's codec (int8 scales / pressure arenas
        + tier bits stamped). Factory hook
        ``transcode_kv_pages(data, q_from, q_to)`` when provided (the
        sim's lossless identity), the llama ``_q8`` codec otherwise —
        the same codec the destination's own write path runs, so a
        transcoded page is bit-identical to one written in place."""
        raise _not_ported("transcode_kv_pages (a heterogeneous KV handoff)")
        fn = getattr(self.serving, "transcode_kv_pages", None)
        if fn is not None:
            return fn(data, quant_from, self.kv_quant)
        return transcode_kv_data(data, quant_from, self.kv_quant)

    def _paged_chunk(self, book, clock, m, active, free_slots, slot_log,
                     outputs, tr=None, acache=None, spst=None,
                     ahst=None, gcache=None):
        """One decode turn. With a spec route (``spst``), the active
        rows split into the PLAIN group (decode_n, exactly the legacy
        turn) and the SPEC group (one batched draft/verify round) —
        two fixed-shape programs, each compiled once, rows outside a
        group riding along as length-0 page-0 slots. ``spst=None``
        is the legacy turn bit-for-bit. ``ahst`` (dispatch-ahead
        only; refuses spec at construction) threads the double
        buffer through the plain turn."""
        rows = sorted(active.values(), key=lambda s: s.slot)
        spec_rows: List[_PagedRow] = []
        if spst is not None:
            self._spec_gate(spst, clock, tr)
            if spst.enabled:
                spec_rows = [st for st in rows if st.spec]
                if spec_rows:
                    rows = [st for st in rows if not st.spec]
            else:
                # a spec row that decodes even ONE plain turn is
                # DEMOTED for its remainder: plain turns advance the
                # target pool but write no draft K/V and move the
                # two-token feed's anchor, so re-entering the spec
                # group later would condition the draft on a stale
                # prev token and a holed cache — acceptance would
                # collapse and latch the route plain for everyone.
                # Re-enabling therefore applies to rows ADMITTED
                # after the incident clears, whose draft state is
                # contiguous by construction.
                for st in rows:
                    st.spec = False
        if rows:
            self._plain_decode_rows(rows, book, clock, m, active,
                                    free_slots, slot_log, outputs,
                                    tr=tr, acache=acache, ahst=ahst,
                                    gcache=gcache)
        if spec_rows:
            self._spec_decode_rows(spec_rows, book, clock, m, active,
                                   free_slots, slot_log, outputs,
                                   spst, tr=tr)

    def _decode_batch(self, rows, book, acache, gcache=None):
        """The fixed-shape decode batch for ``rows`` (host side):
        token feed, page tables, lengths, adapter ids, grammar flat
        state ids — the inputs a decode_n dispatch is a pure function
        of."""
        toks = np.zeros((self.slots,), np.int32)
        pt = np.zeros((self.slots, self.W), np.int32)
        lens = np.zeros((self.slots,), np.int32)
        # per-slot adapter ids (0 = identity slot): built only when
        # multi-model serving is on — this is the engine's hottest
        # loop and single-model replays never read it
        aids = np.zeros((self.slots,), np.int32) \
            if acache is not None else None
        # per-slot grammar flat ids (0 = the all-allow identity row):
        # free rows and empty slots mask with row 0 by construction
        gids = np.zeros((self.slots,), np.int32) \
            if gcache is not None else None
        for st in rows:
            table = book.tables[st.req.rid]
            pt[st.slot, :len(table)] = table
            lens[st.slot] = book.lengths[st.req.rid]
            toks[st.slot] = st.tok
            if aids is not None:
                aids[st.slot] = st.aslot
            if gids is not None and st.gaut is not None:
                gids[st.slot] = gcache.flat_id(st.gslot, st.gstate)
        return toks, pt, lens, aids, gids

    @staticmethod
    def _roster_fp(rows, book):
        """The dispatch-ahead roster fingerprint: a stashed decode
        batch is served only when every (rid, slot, length, feed
        token, adapter slot) it was dispatched from is still exactly
        the live state — admissions, finishes, evictions and handoffs
        all change it, so a stale stash can never be read."""
        return tuple((st.req.rid, st.slot,
                      int(book.lengths[st.req.rid]), int(st.tok),
                      int(st.aslot)) for st in rows)

    def _plain_decode_rows(self, rows, book, clock, m, active,
                           free_slots, slot_log, outputs, tr=None,
                           acache=None, ahst=None, gcache=None):
        n = self.decode_chunk
        if gcache is not None and any(st.gaut is not None
                                      for st in rows):
            # the DFA advances HOST-side: a constrained row's mask for
            # token k+1 depends on token k, so a wave with any
            # constrained row decodes one token per turn. n is a
            # static jit arg — this adds at most ONE extra program
            # cache entry total, flat in the number of schemas; and
            # greedy decode is chunking-invariant, so free rows in
            # the same wave still emit byte-identical streams.
            n = 1
        toks, pt, lens, aids, gids = self._decode_batch(
            rows, book, acache, gcache)
        served_ahead = (ahst is not None and ahst.emits is not None
                        and ahst.fp == self._roster_fp(rows, book))
        if served_ahead:
            # turn t+1's batch was dispatched before turn t's host
            # bookkeeping completed and the roster still matches:
            # serve the in-flight result. The measured clock charges
            # only the RESIDUAL wait (the overlap is the win); a
            # fixed clock prices it exactly like a fresh dispatch, so
            # virtual-clock replays are byte-identical.
            stash = (ahst.emits, None, self._pools)
            if clock.mode == "measured":
                # the overlapped device span started at dispatch, not
                # at this serve — credit the hidden part to dev_wall
                # so the host-overhead decomposition sees the overlap
                clock.dev_wall += max(
                    0.0, time.perf_counter() - ahst.wall0)

            def _call():
                return stash
        else:
            def _call():
                arr = self._arr
                kw = {}
                if acache is not None:
                    kw["lora"] = self._lora_arg(acache, aids)
                if gcache is not None:
                    kw["grammar"] = self._grammar_arg(gcache, gids)
                return self._p_decode_n(
                    self._p_outer, self._p_layers, arr(toks),
                    arr(pt), arr(lens), self._pools, n, **kw)
        attrs = dict(self._tp_attr)
        if served_ahead:
            attrs["ahead"] = True
        emits, _, self._pools = self._timed(
            tr, clock, "decode", _call, jitfn=self._p_decode_n,
            n=n, rows=len(rows),
            rids=[st.req.rid for st in rows], **attrs)
        emits = _host(emits)  # (n, slots) greedy tokens
        t = clock.now()
        for st in rows:
            sid = st.req.rid
            taken = 0
            for k in range(n):
                if len(st.out) >= st.eff or st.done:
                    break
                tok = int(emits[k, st.slot])
                st.out.append(tok)
                taken += 1
                if st.gaut is not None:
                    # the mask the device just applied came from
                    # gstate; account it, then advance to the state
                    # the NEXT turn will mask with
                    mf = st.gaut.masked_frac(st.gstate)
                    st.gmasked += mf
                    m.on_grammar_tokens(1, mf)
                    st.gstate = st.gaut.step(st.gstate, tok)
                    if st.gaut.accepts_at(st.gstate):
                        st.done = True
                        m.on_grammar_accept(sid, t)
                        if tr is not None:
                            tr.instant(
                                "grammar_accept", t=t,
                                track=self._tenant_track(st.req),
                                rid=sid, schema=st.gname)
                if tok == self.eos_token_id:
                    st.done = True
            st.tok = int(emits[-1, st.slot])
            book.lengths[sid] += n  # all n K/V writes happened
            if taken:
                m.on_tokens(sid, t, taken)
                self._ctr_tokens.inc(taken)
            if st.done or len(st.out) >= st.eff:
                self._finish_paged(sid, book, clock, m, active,
                                   free_slots, slot_log, outputs,
                                   tr=tr, acache=acache,
                                   gcache=gcache)
        if ahst is not None:
            self._dispatch_ahead_turn(ahst, book, active, acache, n)

    def _dispatch_ahead_turn(self, ahst, book, active, acache, n):
        """Dispatch turn t+1's decode batch NOW, from the post-update
        slot state, before the caller's remaining host bookkeeping
        (lane prefill routing, admission, metrics) runs — the device
        computes while Python routes. Outside the clock: the work is
        priced when (and only when) the stash is served. Safe to be
        wrong: a speculative dispatch only writes each surviving
        row's OWN pages at positions >= its length (never read until
        that row's turn actually lands, when identical values would
        be rewritten anyway) and the reserved page 0; a roster change
        discards the stash and re-dispatches. The donated pool buffer
        is rebound immediately, exactly like a synchronous call."""
        ahst.clear()
        nxt = sorted(active.values(), key=lambda s: s.slot)
        if not nxt or any(st.spec for st in nxt):
            return
        toks, pt, lens, aids, _ = self._decode_batch(nxt, book, acache)
        ahst.wall0 = time.perf_counter()
        arr = self._arr
        emits, _, self._pools = self._p_decode_n(
            self._p_outer, self._p_layers, arr(toks), arr(pt),
            arr(lens), self._pools, n,
            **({} if acache is None else
               {"lora": self._lora_arg(acache, aids)}))
        ahst.emits = emits
        ahst.fp = self._roster_fp(nxt, book)

    def _spec_decode_rows(self, rows, book, clock, m, active,
                          free_slots, slot_log, outputs,
                          spst: _SpecState, tr=None):
        """One speculative round for the spec group: the draft
        proposes ``n_draft`` tokens per row (two-token feed + in-jit
        walk), the target verifies them in ONE batched block, and
        each row advances by its accepted prefix + the correction
        token — 1..n_draft+1 tokens for one ``spec_decode`` clock
        action, vs ``decode_chunk`` tokens per ``decode``. Greedy
        acceptance keeps every token EXACTLY the target's greedy
        token (speculation changes latency, never content); rejected
        K/V — in both pools — sits beyond the advanced length and is
        overwritten by later writes, the rollback-free
        invariant."""
        k = spst.cfg.n_draft
        prev = np.zeros((self.slots,), np.int32)
        toks = np.zeros((self.slots,), np.int32)
        pt = np.zeros((self.slots, self.W), np.int32)
        lens = np.zeros((self.slots,), np.int32)
        for st in rows:
            table = book.tables[st.req.rid]
            pt[st.slot, :len(table)] = table
            lens[st.slot] = book.lengths[st.req.rid]
            toks[st.slot] = st.tok
            prev[st.slot] = st.prev
        s_outer, s_layers = self._spec_parts[0], self._spec_parts[1]
        s_step = self._spec_parts[4]

        def _call():
            arr = self._arr
            return s_step(self._p_outer, self._p_layers, s_outer,
                          s_layers, arr(prev), arr(toks), arr(pt),
                          arr(lens), self._pools, self._spec_pools,
                          k)
        counts, cands, self._pools, self._spec_pools = self._timed(
            tr, clock, "spec_decode", _call, jitfn=s_step, k=k,
            rows=len(rows),
            rids=[st.req.rid for st in rows], **self._tp_attr)
        counts = _host(counts)
        cands = _host(cands)
        t = clock.now()
        turn_prop = turn_acc = 0
        for st in rows:
            sid = st.req.rid
            n = int(counts[st.slot])
            cand = cands[st.slot]
            taken = 0
            for i in range(n + 1):
                if len(st.out) >= st.eff or st.done:
                    break
                tok = int(cand[i])
                st.out.append(tok)
                taken += 1
                if tok == self.eos_token_id:
                    st.done = True
            # position bookkeeping: all n+1 verified positions hold
            # real K/V (position L took st.tok, L+1+i took d_i for
            # i < n); the new last token t_n sits at position L+n+1,
            # not yet written — exactly decode_n's lengths discipline
            st.prev = int(cand[n - 1]) if n >= 1 else st.tok
            st.tok = int(cand[n])
            book.lengths[sid] += n + 1
            st.sprop += k
            st.sacc += n
            turn_prop += k
            turn_acc += n
            if taken:
                m.on_tokens(sid, t, taken)
                self._ctr_tokens.inc(taken)
            if st.done or len(st.out) >= st.eff:
                self._finish_paged(sid, book, clock, m, active,
                                   free_slots, slot_log, outputs,
                                   tr=tr)
        spst.note(len(rows), turn_prop, turn_acc)
        m.on_spec(len(rows), turn_prop, turn_acc)
        self._ctr_spec_rounds.inc(len(rows))
        self._ctr_draft_proposed.inc(turn_prop)
        self._ctr_draft_accepted.inc(turn_acc)

    def _finish_paged(self, sid, book, clock, m, active, free_slots,
                      slot_log, outputs, timeout: bool = False,
                      tr=None, acache=None, gcache=None):
        st = active.pop(sid)
        book.free(sid)
        self._g_resident.set(float(len(book._refs)))
        if acache is not None and st.req.adapter is not None:
            # unpin: the adapter is RETAINED evictable (the next
            # sharer hits), reclaimed only under bank pressure
            acache.release(st.req.adapter, sid)
            self._note_adapters(acache, m, clock.now())
        if gcache is not None and st.gname is not None:
            # same retention discipline as adapters: the automaton
            # stays resident-evictable for the schema's next sharer
            gcache.release(st.gname, sid)
        free_slots.append(st.slot)
        free_slots.sort()
        slot_log.append((round(clock.now(), 6), "release", sid, st.slot))
        outputs[sid] = st.out
        r = st.req
        evicted = (r.cancel_after is not None
                   and st.eff == r.cancel_after
                   and st.eff < r.max_new_tokens and not st.done)
        # a deadline timeout is the same eviction path as client churn
        # (cancel_after): stop decoding, free pages, mark evicted —
        # only the recorded reason differs
        t_fin = clock.now()
        m.on_finish(sid, t_fin, evicted=evicted or timeout,
                    reason="timeout" if timeout
                    else ("cancel" if evicted else None))
        outcome = "timeout" if timeout else (
            "cancel" if evicted else "completed")
        self._ctr_finished[outcome].inc()
        if tr is not None:
            tr.add_span(sid, st.t0, t_fin - st.t0,
                        track=f"slot/{st.slot}", backend="paged")
            if st.sprop > 0:
                # per-request spec evidence for trace_report's
                # accept=a/p waterfall column — emitted ONLY when the
                # row actually ran spec rounds, so plain traces keep
                # their event set exactly
                tr.instant("spec", t=t_fin,
                           track=self._tenant_track(r), rid=sid,
                           proposed=st.sprop, accepted=st.sacc)
        self._req_close(tr, r, t_fin, outcome, len(st.out))

    def session(self, *, tracer=None, replica: Optional[str] = None,
                expect_churn: bool = False, role: str = "both",
                slo=None) -> "EngineSession":
        """An incremental session over this engine's configuration —
        the cluster router's entry point (see ``EngineSession``).
        ``role`` is the disaggregation stage this session serves
        ("prefill" exports finished prefills as KV handoffs, "decode"
        adopts them, "both" is the classic replica). ``slo`` is this
        replica's ``obs.slo.SLOMonitor`` (the cluster router builds
        one per replica over a shared IncidentLog); it observes the
        session's metrics stream and never mutates it. With ``slo``
        unset, an engine constructed with ``ServingEngine(slo=...)``
        monitors its sessions too — both run paths see the same
        watchdog config. The engine object itself is untouched;
        ``run()`` keeps replaying traces byte-identically."""
        if slo is None:
            slo = self._make_monitor(fresh=False)
        return EngineSession(self, tracer=tracer, replica=replica,
                             expect_churn=expect_churn, role=role,
                             slo=slo)

    # --- dense backend ----------------------------------------------------
    def _run_dense_wave(self, wave, clock, m, outputs,
                        timeouts: bool = False, tr=None):
        """A wave on the dense compiled cache: equal-length groups batch
        together (the dense prefill needs one S0 per program); each
        group runs prefill + per-token decode to the LONGEST effective
        budget in the group — short-budget rows ride along, which is
        exactly the dense tax on mixed traffic that the router prices.
        The wave runs start-to-finish (dense slots cannot admit or
        evict mid-stream); arrivals meanwhile queue.

        ``timeouts`` (the QoS-scheduled loop only): a row whose
        deadline passes mid-wave stops STREAMING at that point — like
        ``cancel_after``, the batch keeps computing but the row takes
        no more tokens and is marked evicted with reason "timeout", so
        the goodput/timeout accounting matches the paged path even
        though dense cannot free resources mid-stream."""
        parts = self._dense
        dtype = parts["outer"]["model.embed_tokens.weight"].dtype
        groups: Dict[int, List[Request]] = {}
        for r in wave:
            groups.setdefault(len(r.prompt), []).append(r)
        for S0 in sorted(groups):
            grp = groups[S0]
            B = len(grp)
            toks = np.asarray([r.prompt for r in grp], np.int32)
            kc = parts["init_caches"](B, dtype)
            vc = parts["init_caches"](B, dtype)
            t_admit = clock.now()
            for r in grp:
                m.on_admit(r.rid, t_admit, "dense")
                if tr is not None:
                    tr.instant("admit", t=t_admit,
                               track=self._tenant_track(r),
                               rid=r.rid, backend="dense")

            def _pf(kc=kc, vc=vc):
                return parts["prefill"](parts["outer"], parts["layers"],
                                        self._arr(toks), kc, vc)
            logits, kc, vc = self._timed(
                tr, clock, "dense_prefill", _pf,
                jitfn=parts["prefill"], S0=S0, B=B,
                rids=[r.rid for r in grp])
            cur = np.argmax(_host(logits), -1).astype(np.int32)
            t = clock.now()
            outs = [[int(c)] for c in cur]
            eff = [min(r.max_new_tokens,
                       r.cancel_after if r.cancel_after is not None
                       else 10 ** 9) for r in grp]
            dls = [r.deadline_time() if timeouts else None
                   for r in grp]
            timed = [False] * B
            fin: List[Optional[float]] = [None] * B
            eos_hit = [False] * B
            for i, r in enumerate(grp):
                m.on_tokens(r.rid, t, 1)
                self._ctr_tokens.inc()
                if tr is not None:
                    tr.instant("first_token", t=t,
                               track=self._tenant_track(r), rid=r.rid)
                if outs[i][0] == self.eos_token_id:
                    eos_hit[i] = True
                if len(outs[i]) >= eff[i] or eos_hit[i]:
                    fin[i] = t
                elif dls[i] is not None and t > dls[i] + 1e-9:
                    fin[i] = t
                    timed[i] = True
            pos = S0
            while any(f is None for f in fin):
                def _st(cur=cur, pos=pos, kc=kc, vc=vc):
                    return parts["decode_step"](
                        parts["outer"], parts["layers"],
                        self._arr(cur), pos, kc, vc)
                logits, kc, vc = self._timed(
                    tr, clock, "dense_decode", _st,
                    jitfn=parts["decode_step"], B=B,
                    rids=[r.rid for r in grp])
                cur = np.argmax(_host(logits), -1).astype(np.int32)
                pos += 1
                t = clock.now()
                for i, r in enumerate(grp):
                    if fin[i] is None:
                        tok = int(cur[i])
                        outs[i].append(tok)
                        m.on_tokens(r.rid, t, 1)
                        self._ctr_tokens.inc()
                        if tok == self.eos_token_id:
                            eos_hit[i] = True
                        if len(outs[i]) >= eff[i] or eos_hit[i]:
                            fin[i] = t
                        elif dls[i] is not None and t > dls[i] + 1e-9:
                            fin[i] = t
                            timed[i] = True
            t_end = clock.now()
            if tr is not None:
                tr.add_span("dense_wave", t_admit, t_end - t_admit,
                            track="waves", S0=S0, B=B)
            for i, r in enumerate(grp):
                outputs[r.rid] = outs[i]
                evicted = (r.cancel_after is not None
                           and eff[i] == r.cancel_after
                           and eff[i] < r.max_new_tokens
                           and not eos_hit[i])
                m.on_finish(r.rid, fin[i], evicted=evicted or timed[i],
                            reason="timeout" if timed[i]
                            else ("cancel" if evicted else None))
                outcome = "timeout" if timed[i] else (
                    "cancel" if evicted else "completed")
                self._ctr_finished[outcome].inc()
                self._req_close(tr, r, fin[i], outcome, len(outs[i]))


class EngineSession:
    """One INCREMENTAL engine replay — the seam the cluster layer
    composes N replicas through.

    ``ServingEngine.run()`` replays a whole trace start-to-finish on a
    private clock; a session is the same arrive→admit→route→prefill→
    decode→finish lifecycle driven from outside, one event at a time:

    - ``submit(r)`` feeds one arrival (the router has already advanced
      this replica's clock to the arrival time);
    - ``advance_until(t)`` processes this replica's lane of the shared
      virtual timeline up to ``t`` — called for EVERY replica before
      each placement decision, so load/prefix probes answer "as of
      ``t``", not "as of whenever this replica last ran";
    - ``pull_unadmitted()`` hands the queued-but-never-admitted backlog
      back for placement elsewhere (the drain path; in-flight rows keep
      streaming);
    - ``finish()`` runs the backlog dry and builds the ``ServeResult``.

    Both admission disciplines drive through here — FIFO
    (``scheduler=None``) mirrors ``run()``'s loop body, a
    ``QoSScheduler`` mirrors ``_run_scheduled``'s (shedding, degrade
    tiers, cache-aware feasibility pricing, running-row timeouts). The
    single-engine loops are untouched and replay byte-identically.

    Each replica needs its OWN engine (and its own serving factory:
    factories share live pool buffers, and two sessions allocating page
    ids from independent bookkeepers over one buffer would corrupt each
    other's K/V). Timestamps are always explicit, so one shared cluster
    ``Tracer`` serves N per-replica clocks.

    Per-request metrics, outputs, decisions and slot logs match
    ``run()`` exactly on the same stream; the one sampled diagnostic
    that differs is queue-depth cadence (``run()`` also samples on
    pure arrival-ingestion iterations; a session samples once per
    turn), so ``queue_depth_mean`` is comparable but not bit-equal.
    """

    def __init__(self, engine: ServingEngine, *, tracer=None,
                 replica: Optional[str] = None,
                 expect_churn: bool = False, role: str = "both",
                 slo=None):
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"role {role!r}: use 'prefill', 'decode' "
                             "or 'both'")
        eng = self.eng = engine
        self.replica = replica
        # --- disaggregation (all inert at role="both") --------------
        # "prefill": every finished prefill EXPORTS its KV chain as a
        # KVHandoff (banked in handoff_ready for the router) instead
        # of entering a decode slot. "decode": this session never
        # receives admissions from a disaggregated placement policy —
        # it adopts handoffs through submit_handoff/import_queue and
        # only decodes. "both" is the classic replica.
        self.role = role
        self.lane = deque() if eng.prefill_chunk_budget is not None \
            else None
        self.handoff_ready: List[KVHandoff] = []
        self.import_queue: List[KVHandoff] = []
        self.handoff_stats = {"imported": 0, "reclaimed": 0}
        # axis -> transform-step count ("tp"/"page"/"codec"); stays
        # EMPTY on a twin fleet — the armed-only convention, folded
        # into the router's census like handoff_stats
        self.handoff_resharded: Dict[str, int] = {}
        self.clock = eng._make_clock(replica or "engine")
        self.tr = tracer
        self.slo = slo
        self.m = MetricsCollector(monitor=slo)
        self._g_busy = None
        if slo is not None:
            # the utilization gauge rides the monitored path only, so
            # unmonitored replays leave no trace of it in the
            # registry (the clean-registry convention); the child is
            # resolved once
            # here, not per turn
            self._g_busy = obs_metrics.REGISTRY.gauge(
                "serving_replica_busy_frac",
                "busy decode slots / slot capacity, sampled per turn",
                replica=replica or "-")
        self.book = PagedKVCache(eng.n_pool_pages, eng.page_size,
                                 kv_heads=1, head_dim=1, device="cpu")
        eng._note_pool(self.book, self.m)
        # per-session host arena (hostmem= engines; None otherwise):
        # each replica owns its spill tier — eviction spill, priced
        # page-in and the QoS preempt rung all work per session
        self.hst = eng._arm_hostmem(self.book, self.clock, self.m,
                                    tracer)
        # per-session adapter cache (multi-model serving; None when
        # the engine is single-model): each replica owns its bank —
        # residency is the signal adapter-aware placement routes on
        self.acache = eng._make_adapter_cache()
        # per-session grammar cache (constrained decoding; None when
        # the engine has no grammar store): each replica owns its
        # mask bank, so schema residency is per-replica too
        self.gcache = eng._make_grammar_cache()
        # per-session spec-route state (multi-replica: each replica
        # EWMAs its own acceptance and flips independently)
        self.spst = eng._make_spec_state()
        # per-session pressure-tier state (each replica watches its
        # own pool's byte census and flips/compacts independently)
        self.qst = eng._make_quant_state()
        # per-session dispatch-ahead double buffer (None with the
        # flag off — the turn is then the legacy sequential one)
        self.ahst = eng._make_ahead_state()
        self.pages_total = len(self.book._free)
        self.sched = eng.scheduler
        eng._wire_spec_overload(slo, self.sched)
        eng._wire_pressure(slo, self.sched)
        self.est: Optional[ServiceEstimator] = None
        if self.sched is not None:
            self.sched.reset()
            costs = eng.fixed_costs or {}
            est_kw = {}
            if "prefill_unit" in costs:
                est_kw = {"prefill_unit": costs["prefill_unit"],
                          "chunk_tokens": eng.chunk_C}
            self.est = ServiceEstimator(
                prefill=costs.get("prefill", 1.0),
                decode=costs.get("decode", 1.0), **est_kw)
        self.waiting: List[Request] = []   # FIFO discipline only
        self.active: Dict[str, _PagedRow] = {}
        self.free_slots = list(range(eng.slots))
        self.outputs: Dict[str, List[int]] = {}
        self.decisions: List[dict] = []
        self.slot_log: List[tuple] = []
        self.prefix_cached: Dict[str, int] = {}
        self.shed_log: Dict[str, str] = {}
        self.seen_groups: set = set()
        self.prefill_tokens = 0
        self.inv_ok = True
        # adapter-slot census flag, SEPARATE from the pool census so
        # a page leak is never reported as a bank-slot leak (and vice
        # versa)
        self.a_inv_ok = True
        # grammar-slot census flag, separate for the same reason
        self.g_inv_ok = True
        # True while the router may still submit here; finish() (and a
        # drain) clears it, enabling run()'s "nothing else will ever
        # come" admission clause
        self.more_expected = True
        self._ctx_base = {"capacity": eng.slots,
                          "expect_churn": bool(expect_churn)}
        self._finished: Optional[ServeResult] = None
        # --- fault-tolerance state (all inert on the happy path) ---
        # crashed: the replica process is DEAD — it queues submissions
        # (the router does not know yet) but processes nothing; its
        # in-flight rows were torn down at crash time into
        # crash_salvage for the router's failover to resume elsewhere.
        self.crashed = False
        self.crash_salvage: List[Tuple[Request, List[int]]] = []
        # arrivals routed here AFTER the crash (the router has not
        # detected the silence yet): no admission policy runs on a
        # dead process — they wait for pull_unadmitted, uncounted by
        # the scheduler
        self._dead_letter: List[Request] = []
        # stall_until: transient liveness-preserving pause — no turn
        # runs before this virtual time, but the session still answers
        # health probes (a stall is slow, not dead).
        self.stall_until: Optional[float] = None
        # decode_fault_hook: callable(session) invoked inside each
        # decode turn's try block; raising DecodeError(rid) from it
        # exercises the single-row teardown path. Aborted rows bank in
        # .aborted as (Request, emitted tokens) for the failover layer to
        # re-place.
        self.decode_fault_hook = None
        self.aborted: List[Tuple[Request, List[int]]] = []

    # --- placement probes --------------------------------------------------
    def queued(self) -> int:
        n = self.sched.waiting() if self.sched is not None \
            else len(self.waiting)
        return n + len(self._dead_letter)

    def load(self) -> int:
        """The live load signal placement policies read: queued +
        in-flight requests on this replica (prefilling lane rows and
        accepted-but-not-imported handoffs included — both are work
        this replica owes)."""
        return self.queued() + self.in_flight()

    def in_flight(self) -> int:
        """Rows this session still owes work for: decoding rows,
        prefilling lane rows, and handoffs accepted but not yet
        imported."""
        return len(self.active) + len(self.lane or ()) \
            + len(self.import_queue)

    def free_slot_count(self) -> int:
        """Open decode slots right now — the signal the disaggregated
        placement's decode stage places handoffs by."""
        return len(self.free_slots)

    def prefill_backlog(self) -> int:
        """Pending prefill CHUNKS on this replica: the lane's
        remaining chunks plus every queued (not yet admitted) prompt's
        padded chunk count — what the disaggregated placement policy
        prices the prefill stage with (multiply by the estimator's
        ``prefill_unit`` for clock units)."""
        C = self.eng.chunk_C
        n = sum(e.remaining_chunks() for e in self.lane or ())
        reqs = self.sched.queued_requests() if self.sched is not None \
            else self.waiting
        for r in reqs:
            n += self.eng._pad_len(len(r.prompt)) // C
        return n

    def match_prefix(self, prompt) -> int:
        """Non-acquiring probe of THIS replica's paged pool: leading
        tokens of ``prompt`` its prefix cache could serve right now
        (0 when the engine runs cache-off)."""
        if not self.eng.prefix_cache:
            return 0
        return self.book.match_prefix(list(prompt))

    def adapter_resident(self, name) -> bool:
        """Non-acquiring probe of THIS replica's adapter bank: is
        ``name`` on device right now (pinned or retained)? The
        adapter-aware placement signal — False on a single-model
        session or for ``name=None``."""
        if self.acache is None or name is None:
            return False
        return self.acache.resident(name)

    # --- arrivals ----------------------------------------------------------
    def submit(self, r: Request):
        """One arrival (advance this lane to ``r.arrival`` first). On
        a CRASHED session the request dead-letters instead of entering
        the scheduler: a dead process cannot run admission policy, so
        it must never shed (a terminal rejection issued by a corpse
        would permanently drop a request the failover contract
        promises to rescue) — the dead letters leave with the queue
        at ``pull_unadmitted``."""
        eng = self.eng
        eng._validate([r])
        self.m.on_arrival(r.rid, r.arrival, tenant=r.tenant,
                          priority=r.priority,
                          deadline_ms=r.deadline_ms)
        eng._ctr_arrived.inc()
        eng._req_open(self.tr, r)
        if self.crashed:
            self._dead_letter.append(r)
        elif self.sched is not None:
            self._shed(self.sched.enqueue(r, self.clock.now()))
        else:
            self.waiting.append(r)

    def pull_unadmitted(self, outcome: str = "requeued") \
            -> List[Request]:
        """Drain/failover support: remove every queued-but-never-
        admitted request from this session — the queue entry, the
        metrics arrival record (it moves with the request, so a
        cluster rollup counts it ONCE, at wherever it finally runs or
        sheds) and the trace root (closed with ``outcome``: "requeued"
        for a graceful drain, "failover" when a dead replica's queue
        is rescued) — and return them in (arrival, rid) order.
        In-flight rows are untouched and keep streaming to completion
        (on a crashed session there are none left to touch)."""
        if self.sched is not None:
            reqs = self.sched.drain_queue()
        else:
            reqs = list(self.waiting)
            self.waiting = []
        reqs = sorted(reqs + self._dead_letter,
                      key=lambda r: (r.arrival, r.rid))
        self._dead_letter = []
        t = self.clock.now()
        for r in reqs:
            self.m.forget(r.rid)
            if self.acache is not None:
                self.acache.forget_pending(r.rid)
            if self.gcache is not None:
                self.gcache.forget_pending(r.rid)
            self.eng._req_close(self.tr, r, t, outcome, 0)
        # accepted-but-not-imported handoffs leave with the queue:
        # their exported KV is RECLAIMED (dropped — wherever the
        # request lands next re-prefills) and the request re-places;
        # it has no metrics record or open trace root HERE (the source
        # closed its root at export, the importer would have re-opened
        # one), so there is nothing to forget or close
        if self.import_queue:
            self.handoff_stats["reclaimed"] += len(self.import_queue)
            imports = [h.req for h in self.import_queue]
            self.import_queue = []
            reqs = sorted(reqs + imports,
                          key=lambda r: (r.arrival, r.rid))
        return reqs

    # --- fault teardown ----------------------------------------------------
    def abort_row(self, rid: str, reason: str = "decode_error") \
            -> Tuple[Request, List[int]]:
        """Tear down ONE in-flight row without corrupting survivors:
        its pool pages are released, its slot freed (logged as an
        "abort" slot event), its metrics record forgotten and its
        trace root closed with outcome "failover" — the request is
        MOVING, not finishing, so nothing lands in ``outputs`` and no
        finish counter fires. Returns (request, tokens emitted so
        far): the salvage a failover resumes from."""
        st = self.active.pop(rid)
        self.book.free(rid)
        eng = self.eng
        eng._g_resident.set(float(len(self.book._refs)))
        if self.acache is not None and st.req.adapter is not None:
            self.acache.release(st.req.adapter, rid)
            eng._note_adapters(self.acache, self.m, self.clock.now())
        if self.gcache is not None and st.gname is not None:
            self.gcache.release(st.gname, rid)
        self.free_slots.append(st.slot)
        self.free_slots.sort()
        t = self.clock.now()
        self.slot_log.append((round(t, 6), "abort", rid, st.slot))
        obs_metrics.REGISTRY.counter(
            "serving_rows_aborted_total",
            "in-flight rows torn down by crash/decode faults",
            reason=reason).inc()
        if self.tr is not None:
            self.tr.add_span(rid, st.t0, t - st.t0,
                             track=f"slot/{st.slot}", backend="paged",
                             aborted=reason)
        eng._req_close(self.tr, st.req, t, "failover", len(st.out),
                       reason=reason)
        self.m.forget(rid)
        self.inv_ok &= self.book.census_ok()
        return st.req, list(st.out)

    def crash(self) -> None:
        """The replica process dies NOW (distinct from drain: nothing
        is handed anywhere — the router's failure detector must notice
        the silence). Every in-flight row is torn down into
        ``crash_salvage`` (admission order, so failover is
        deterministic), then the pool is PURGED — retained prefix
        pages included, with the epoch bumped, because a dead
        replica's K/V cannot serve anyone — and the session stops
        processing. Submissions still queue here (the router does not
        know yet); ``pull_unadmitted`` rescues them at detection."""
        if self.crashed:
            raise RuntimeError("session already crashed")
        self.crashed = True
        for rid in sorted(self.active,
                          key=lambda r: (self.active[r].t0, r)):
            self.crash_salvage.append(
                self.abort_row(rid, reason="replica_crash"))
        # prefilling lane rows die with the pool: no token was ever
        # emitted, so their salvage is an empty stream (admit order —
        # deterministic failover, after the decoding rows)
        for e in list(self.lane or ()):
            self.lane.remove(e)
            self.crash_salvage.append(
                self._abort_lane_entry(e, reason="replica_crash"))
        # accepted-but-not-imported handoffs: the exported KV dies
        # here unlanded (reclaimed); the REQUEST fails over and
        # re-prefills on a survivor — accounted, never lost
        if self.import_queue:
            self.handoff_stats["reclaimed"] += len(self.import_queue)
            for h in self.import_queue:
                self.crash_salvage.append((h.req, []))
            self.import_queue = []
        self.book.purge()
        self.inv_ok &= self.book.census_ok()

    def _abort_lane_entry(self, e: _PrefillingRow, reason: str) \
            -> Tuple[Request, List[int]]:
        """Tear down ONE prefilling lane row (the lane twin of
        ``abort_row``): pages freed, slot released ("abort" slot
        event), metrics record forgotten, trace root closed with
        outcome "failover" — the request is moving, not finishing.
        Salvage is always the empty stream: no token existed yet."""
        sid = e.req.rid
        self.book.free(sid)
        eng = self.eng
        eng._g_resident.set(float(len(self.book._refs)))
        if self.acache is not None and e.req.adapter is not None:
            self.acache.release(e.req.adapter, sid)
            eng._note_adapters(self.acache, self.m, self.clock.now())
        if self.gcache is not None and e.gname is not None:
            self.gcache.release(e.gname, sid)
        self.free_slots.append(e.slot)
        self.free_slots.sort()
        t = self.clock.now()
        self.slot_log.append((round(t, 6), "abort", sid, e.slot))
        obs_metrics.REGISTRY.counter(
            "serving_rows_aborted_total",
            "in-flight rows torn down by crash/decode faults",
            reason=reason).inc()
        if self.tr is not None:
            self.tr.add_span(sid, e.t_admit, t - e.t_admit,
                             track="prefill_lane", aborted=reason)
        eng._req_close(self.tr, e.req, t, "failover", 0, reason=reason)
        self.m.forget(sid)
        self.inv_ok &= self.book.census_ok()
        return e.req, []

    # --- KV handoff (the disaggregated prefill->decode seam) --------------
    def _handoff_sink(self, r: Request, slot: int, first_tok: int,
                      n_cached: int, t_admit: float) -> bool:
        """The prefill-role completion path: export the prompt's page
        chain, free the row's pages and slot (the KV MOVED — the
        registered prefix pages stay retained in this pool's evictable
        LRU, so later sharers still skip their prefill here), move the
        metrics record and trace root out (forgotten here, re-recorded
        by the importer — the cluster counts the request exactly
        once), and bank the handoff for the router."""
        eng = self.eng
        book = self.book
        sid = r.rid
        t = self.clock.now()
        ids = book.export_chain(sid, len(r.prompt))
        n_exp = len(ids)
        data = eng.export_kv_pages(ids)
        q_idx: Tuple[int, ...] = ()
        if eng.kv_quant == "pressure":
            # the exported slices carry the device tier bits; the
            # chain POSITIONS in the int8 tier ride the handoff so
            # the importer can mirror them into its own bookkeeper
            # (pool page ids are meaningless across pools)
            q_idx = tuple(i for i, p in enumerate(ids)
                          if p in book._quant)
        self.handoff_ready.append(KVHandoff(
            req=r, first_tok=int(first_tok), n_pages=n_exp,
            kv_data=data, n_cached=n_cached, t_admit=t_admit,
            t_first=t, t_ready=t, replica_from=self.replica,
            page_size=eng.page_size, tp=eng.tp_size,
            kv_quant=eng.kv_quant, quant_pages=q_idx,
            layout=getattr(eng.serving, "kv_layout_", "head_major")))
        book.free(sid)
        eng._g_resident.set(float(len(book._refs)))
        if self.acache is not None and r.adapter is not None:
            # the adapter pin moves with the request: the exporter
            # unpins (its bank retains the adapter evictable for the
            # next sharer), the importer re-pins at adoption
            self.acache.release(r.adapter, sid)
            eng._note_adapters(self.acache, self.m, t)
        gname = eng._schema_of(r)
        if self.gcache is not None and gname is not None:
            # the grammar pin moves with the request too: the
            # importer re-acquires and re-derives the DFA state from
            # the first token (the exporter advanced no stream, so
            # grammar token metrics are the IMPORTER's to count)
            self.gcache.release(gname, sid)
        self.free_slots.append(slot)
        self.free_slots.sort()
        self.slot_log.append((round(t, 6), "handoff", sid, slot))
        obs_metrics.REGISTRY.counter(
            "serving_kv_handoffs_total",
            "KV chains moved between prefill and decode workers",
            direction="export").inc()
        if self.tr is not None:
            self.tr.instant("handoff_export", t=t, track="engine",
                            rid=sid, pages=n_exp)
        eng._req_close(self.tr, r, t, "handoff", 0)
        self.m.forget(sid)
        self.inv_ok &= book.census_ok()
        return True

    def submit_handoff(self, h: KVHandoff):
        """Router-facing: queue an exported KV chain for adoption.
        The import runs inside ``_turn`` once this lane's clock
        reaches ``h.t_arrive`` (the router stamps it with the
        per-page transfer cost on the shared timeline) and a decode
        slot is free."""
        self.import_queue.append(h)

    def _transform_handoff(self, h: KVHandoff, steps):
        """Run the priced reshard/repage/transcode steps on the
        IMPORTER's clock — the ``adapter_upload`` discipline: each
        step is one ``_timed`` span on the engine track (per-page
        priced on a fixed clock via its ``<kind>_unit`` entry, flat
        default otherwise), which the ledger funnel books as its own
        first-class kind. Mutates the handoff's stamps in place as
        each step lands, so every step's output is the next step's
        honestly-described input and the downstream import/tier-mirror
        code reads destination-true metadata."""
        eng, clock, tr = self.eng, self.clock, self.tr
        r = h.req
        sid = r.rid
        if "kv_reshard" in steps:
            h.kv_data = eng._timed(
                tr, clock, "kv_reshard",
                lambda: eng.reshard_kv_pages(h.kv_data),
                rid=sid, units=h.n_pages, tp_from=h.tp,
                tp_to=eng.tp_size)
            h.tp = eng.tp_size
            self._note_reshard("tp")
        if "kv_repage" in steps:
            n_dst = -(-len(r.prompt) // eng.page_size)
            ps_from = h.page_size
            h.kv_data = eng._timed(
                tr, clock, "kv_repage",
                lambda: eng.repage_kv_pages(h.kv_data, ps_from,
                                            len(r.prompt)),
                rid=sid, units=n_dst, page_from=ps_from,
                page_to=eng.page_size)
            h.n_pages = n_dst
            h.page_size = eng.page_size
            self._note_reshard("page")
        if "kv_transcode" in steps:
            q_from = h.kv_quant
            h.kv_data = eng._timed(
                tr, clock, "kv_transcode",
                lambda: eng.transcode_kv_pages(h.kv_data, q_from),
                rid=sid, units=h.n_pages, codec_from=q_from or "fp",
                codec_to=eng.kv_quant)
            h.kv_quant = eng.kv_quant
            if eng.kv_quant == "pressure":
                # the transcode parked the WHOLE chain in the int8
                # tier (tier bits all set); the chain positions ride
                # quant_pages so the existing import mirror prices
                # the adopted chain in this pool's byte census
                h.quant_pages = tuple(range(h.n_pages))
            self._note_reshard("codec")

    def _note_reshard(self, axis: str):
        """Account one transform step: the labeled counter is CREATED
        on the first transform ever run (armed-only — a twin fleet's
        registry stays byte-identical to pre-hetero) and the session
        tally feeds the router's census fold at removal/bank time."""
        obs_metrics.REGISTRY.counter(
            "serving_handoff_resharded_total",
            "KV handoffs transformed on import, by mismatch axis",
            axis=axis).inc()
        self.handoff_resharded[axis] = \
            self.handoff_resharded.get(axis, 0) + 1

    def _import_handoffs(self) -> bool:
        """Adopt every deliverable handoff: allocate a fresh chain,
        scatter the exported page content into it, re-record the
        request (its real arrival, the admission that happened on the
        source, the first token at its source timestamp — the client
        already has it) and enter a decode slot. A handoff blocked on
        pages retries next turn as rows finish; blocked with nothing
        else running is a sizing error and refuses loudly."""
        eng = self.eng
        book = self.book
        clock, m, tr = self.clock, self.m, self.tr
        got = False
        while self.import_queue and self.free_slots:
            # deliverable = transfer complete by now. Submission order
            # is NOT delivery order (t_arrive scales with each chain's
            # page count), so scan the whole queue — gating on the
            # head alone would park a delivered chain behind a slower
            # transfer forever
            ready = [h for h in self.import_queue
                     if clock.now() >= h.t_arrive - 1e-12]
            if not ready:
                break
            h = min(ready, key=lambda x: (x.t_arrive, x.req.rid))
            r = h.req
            sid = r.rid
            # the compatibility verdict (raises UnstampedHandoffError
            # on a hand-built handoff that skipped the geometry
            # stamps): () = twin, adopt as-is — the pre-hetero path
            # bit-for-bit, zero transform spans
            steps = eng.handoff_steps(h)
            if steps is None:
                raise RuntimeError(
                    f"handoff {sid!r} was exported under kv_quant="
                    f"{h.kv_quant!r}/page_size={h.page_size} but this "
                    f"decode worker runs kv_quant={eng.kv_quant!r}/"
                    f"page_size={eng.page_size} — an untransformable "
                    "pairing (quantized sources only adopt same-codec; "
                    "pressure chains never re-page), so placement must "
                    "refuse it like the geometry filters once did")
            if steps and h.layout != getattr(eng.serving, "kv_layout_",
                                             "head_major"):
                raise RuntimeError(
                    f"handoff {sid!r} carries canonical layout "
                    f"{h.layout!r} but this worker's factory speaks "
                    f"{getattr(eng.serving, 'kv_layout_', 'head_major')!r}"
                    " — a transform cannot reinterpret a foreign "
                    "layout (mixed sim/real fleets cannot exchange KV)")
            aslot, a_up = 0, False
            if r.adapter is not None:
                if self.acache is None:
                    raise RuntimeError(
                        f"handoff {sid!r} names adapter "
                        f"{r.adapter!r} but this decode worker was "
                        "built without adapters= — disaggregated "
                        "adapter serving needs the store on BOTH "
                        "stages")
                try:
                    # the importer pays the paced upload too when its
                    # bank never saw this adapter (run inside the
                    # timed wrapper; counting waits for the adoption
                    # to succeed)
                    aslot, a_up = self.acache.acquire(
                        r.adapter, sid,
                        timed=lambda f: eng._timed(
                            tr, clock, "adapter_upload", f, rid=sid,
                            adapter=r.adapter))
                except MemoryError:
                    break  # bank fully pinned: retry as rows finish
            if r.schema is not None and self.gcache is None:
                # _schema_of goes silently None on a grammar-less
                # engine (the single-engine _validate path refuses
                # earlier); an ADOPTED row must refuse here instead
                # of free-running past its declared output contract
                raise RuntimeError(
                    f"handoff {sid!r} names schema {r.schema!r} but "
                    "this decode worker was built without grammar= "
                    "— disaggregated constrained serving needs the "
                    "store on BOTH stages")
            gname = eng._schema_of(r)
            gslot, g_up, gaut = 0, False, None
            if gname is not None:
                try:
                    # the importer compiles when its bank never saw
                    # this schema — the priced clock action fires
                    # here, on adoption, like adapter_upload above
                    gslot, g_up = self.gcache.acquire(
                        gname, sid,
                        timed=lambda f: eng._timed(
                            tr, clock, "grammar_compile", f, rid=sid,
                            schema=gname))
                except MemoryError:
                    if r.adapter is not None \
                            and self.acache is not None:
                        self.acache.note_rollback(r.adapter, sid,
                                                  a_up)
                    break  # bank fully pinned: retry as rows finish
                gaut = self.gcache.automaton(gname)
            try:
                book.allocate(sid, eng._footprint(r))
            except MemoryError:
                if r.adapter is not None and self.acache is not None:
                    self.acache.note_rollback(r.adapter, sid, a_up)
                if gname is not None:
                    self.gcache.note_rollback(gname, sid, g_up)
                if not self.active and not (self.lane or ()) \
                        and not self.queued():
                    raise RuntimeError(
                        f"pool too small to import handoff {sid!r} "
                        f"(free pages {len(book._free)}, needs "
                        f"{eng._footprint(r)} tokens)")
                break
            if r.adapter is not None:
                a_up = self.acache.took_upload(sid, a_up)
                (eng._ctr_adapter_uploads if a_up
                 else eng._ctr_adapter_hits).inc()
            if gname is not None:
                g_up = self.gcache.took_compile(sid, g_up)
                (eng._ctr_grammar_compiles if g_up
                 else eng._ctr_grammar_hits).inc()
                m.on_grammar(sid, gname, hit=not g_up)
            self.import_queue.remove(h)
            book.lengths[sid] = len(r.prompt)
            if steps:
                # priced on THIS clock only now — after the chain
                # allocated, so a page-blocked import that retried
                # across turns never charged for transforms it had to
                # redo, and a twin import runs zero extra spans
                self._transform_handoff(h, steps)
            eng.import_kv_pages(book.tables[sid][:h.n_pages],
                                h.kv_data)
            if h.kv_quant == "pressure" and h.quant_pages:
                # the scattered data restored the device tier bits;
                # mirror them in this pool's bookkeeper so the byte
                # census prices the adopted chain by its real tier
                tbl = book.tables[sid]
                book.mark_quantized([tbl[i] for i in h.quant_pages])
            if eng.prefix_cache:
                # the imported prompt pages hold real K/V: publish
                # them, so sharers landing on this decode worker hit
                book.register_prefix(sid, list(r.prompt))
            slot = self.free_slots.pop(0)
            t = clock.now()
            m.on_arrival(sid, r.arrival, tenant=r.tenant,
                         priority=r.priority,
                         deadline_ms=r.deadline_ms)
            eng._req_open(tr, r)
            m.on_admit(sid, h.t_admit, "paged")
            obs_metrics.REGISTRY.counter(
                "serving_kv_handoffs_total",
                "KV chains moved between prefill and decode workers",
                direction="import").inc()
            if tr is not None:
                tr.instant("handoff_import", t=t, track="engine",
                           rid=sid, pages=h.n_pages,
                           source=h.replica_from)
            if r.adapter is not None:
                m.on_adapter(sid, r.adapter, hit=not a_up)
                eng._note_adapters(self.acache, m, t)
            gstate = 0
            row = _PagedRow(r, slot, h.first_tok, t0=t, aslot=aslot,
                            gslot=gslot, gname=gname, gaut=gaut)
            if gaut is not None:
                # the exporter advanced no stream: the first token's
                # DFA step — and its grammar token metrics — land on
                # the importer, mirroring m.on_tokens below
                gstate = gaut.start
                mf = gaut.masked_frac(gstate)
                row.gmasked += mf
                m.on_grammar_tokens(1, mf)
                gstate = gaut.step(gstate, int(h.first_tok))
                row.gstate = gstate
                if gaut.accepts_at(gstate):
                    row.done = True
                    m.on_grammar_accept(sid, h.t_first)
                    if tr is not None:
                        tr.instant("grammar_accept", t=h.t_first,
                                   track=eng._tenant_track(r),
                                   rid=sid, schema=gname)
            self.active[sid] = row
            self.slot_log.append((round(t, 6), "acquire", sid, slot))
            self.prefix_cached[sid] = 0
            m.on_tokens(sid, h.t_first, 1)
            eng._ctr_tokens.inc()
            if tr is not None:
                tr.instant("first_token", t=h.t_first,
                           track=eng._tenant_track(r), rid=sid)
            self.handoff_stats["imported"] += 1
            eng._g_resident.set(float(len(book._refs)))
            got = True
        return got

    # --- the drive loop ----------------------------------------------------
    def _shed(self, pairs) -> bool:
        eng = self.eng
        for r, reason in pairs:
            t = self.clock.now()
            self.m.on_shed(r.rid, t, reason)
            self.shed_log[r.rid] = reason
            eng._ctr_shed.inc()
            if self.acache is not None:
                self.acache.forget_pending(r.rid)
            if self.gcache is not None:
                self.gcache.forget_pending(r.rid)
            if self.hst is not None \
                    and r.rid in self.hst["preempted"]:
                # preempted-then-shed: the pinned chain never pages
                # back in — release its arena bytes
                self.hst["preempted"].discard(r.rid)
                self.book.drop_spilled_owner(r.rid)
            if self.tr is not None:
                self.tr.instant("shed", t=t, track="scheduler",
                                rid=r.rid, reason=reason,
                                tenant=r.tenant)
            eng._req_close(self.tr, r, t, "shed", 0, reason=reason)
        return bool(pairs)

    def _ready(self) -> bool:
        """run()'s admission-window test with ``more_expected``
        standing in for the trace's pending deque. The comparison uses
        the IDENTICAL float expression ``oldest + max_delay`` as
        ``_idle_target`` — advance_to(target) must always read as
        ready on arrival, or one ulp of a large clock livelocks the
        advance loop (see ``_admission_ready``)."""
        if self.queued() >= self.eng.admission.max_batch:
            return True
        oldest = self.sched.oldest_arrival() if self.sched is not None \
            else self.waiting[0].arrival
        if self.clock.now() >= oldest \
                + self.eng.admission.max_delay - 1e-12:
            return True
        return not self.more_expected and not self.active

    def _idle_target(self) -> Optional[float]:
        """When nothing progressed and nothing runs: the time the
        oldest waiting request's admission window closes, or the next
        queued handoff's delivery time — whichever is sooner (None
        with neither: only a new arrival can wake this lane)."""
        targets = []
        if self.queued():
            oldest = self.sched.oldest_arrival() \
                if self.sched is not None else self.waiting[0].arrival
            targets.append(oldest + self.eng.admission.max_delay)
        now = self.clock.now()
        future = [h.t_arrive for h in self.import_queue
                  if h.t_arrive > now + 1e-12]
        if future:
            # already-delivered-but-blocked handoffs define no idle
            # target: they import the moment a slot/pages free, and
            # an in-the-past target would spin the advance loop
            targets.append(min(future))
        return min(targets) if targets else None

    def _turn(self) -> bool:
        """One scheduler turn: admission attempt + decode chunk —
        run()'s / _run_scheduled's loop body minus arrival ingestion
        (the router owns arrivals)."""
        eng = self.eng
        clock, tr, m = self.clock, self.tr, self.m
        now = clock.now()
        m.on_queue_depth(now, self.queued())
        # decode-slot utilization (busy slots / capacity), sampled
        # once per turn like queue depth: the live gauge any scrape
        # reads, and — through the collector — the SLO-watchable
        # `replica_busy_frac` signal the autoscaler's drain decision
        # stands on (`ThresholdRule(signal="replica_busy_frac")`)
        busy = (eng.slots - self.free_slot_count()) / eng.slots
        m.on_busy_frac(now, busy)
        if self._g_busy is not None:
            self._g_busy.set(busy)
        if tr is not None:
            tr.counter("queue_depth", self.queued(), t=now)
        progressed = False
        if self.import_queue:
            # adopt deliverable handoffs first, so the imported row
            # joins this turn's decode batch
            progressed |= self._import_handoffs()
        if self.sched is not None:
            progressed |= self._shed(self.sched.shed_expired(now))
            if self.sched.waiting() and self._ready():
                progressed |= self._qos_wave(now)
        elif self.waiting and self._ready():
            progressed |= self._fifo_wave()
        if self.active:
            t0 = clock.now()
            try:
                if self.decode_fault_hook is not None:
                    self.decode_fault_hook(self)
                eng._paged_chunk(self.book, clock, m, self.active,
                                 self.free_slots, self.slot_log,
                                 self.outputs, tr=tr,
                                 acache=self.acache, spst=self.spst,
                                 ahst=self.ahst, gcache=self.gcache)
            except DecodeError as e:
                # one slot's computation failed: tear down exactly
                # that row (the decode turn is forfeit — survivors
                # resume next turn with their state intact) and bank
                # it for the failover layer to fail over
                if e.rid not in self.active:
                    raise
                self.aborted.append(
                    self.abort_row(e.rid, reason="decode_error"))
            else:
                if self.est is not None:
                    self.est.observe("decode", clock.now() - t0)
            if self.est is not None:
                # the deadline-timeout scan runs whether the decode
                # turn completed or aborted — an expired row must not
                # survive an extra chunk just because another slot's
                # fault forfeited this turn
                t = clock.now()
                for sid in list(self.active):
                    dl = self.active[sid].req.deadline_time()
                    if dl is not None and t > dl + 1e-9:
                        eng._finish_paged(sid, self.book, clock, m,
                                          self.active,
                                          self.free_slots,
                                          self.slot_log,
                                          self.outputs,
                                          timeout=True, tr=tr,
                                          acache=self.acache,
                                          gcache=self.gcache)
            progressed = True
        if self.lane:
            sink = self._handoff_sink if self.role == "prefill" \
                else None
            _, ptoks = eng._lane_step(
                self.lane, self.book, clock, m, self.active,
                self.free_slots, self.slot_log, self.outputs,
                self.prefix_cached, self.seen_groups, tr=tr,
                sink=sink, acache=self.acache, spst=self.spst,
                gcache=self.gcache)
            self.prefill_tokens += ptoks
            if self.est is not None:
                eng._lane_timeouts(self.lane, self.book, clock, m,
                                   self.free_slots, self.slot_log,
                                   self.outputs, tr=tr,
                                   acache=self.acache,
                                   gcache=self.gcache)
            progressed = True
        eng._quant_turn(self.book, m, clock, tr, self.qst)
        self.inv_ok &= self.book.census_ok()
        if self.acache is not None:
            self.a_inv_ok &= self.acache.census_ok()
        if self.gcache is not None:
            self.g_inv_ok &= self.gcache.census_ok()
        if eng._ledger is not None:
            eng._ledger.sample_occupancy(
                clock.label, book=self.book, acache=self.acache,
                gcache=self.gcache,
                arena=getattr(self.book, "_arena", None))
        return progressed

    def _route_ctx(self, wave):
        groups = [r.prefix_group for r in wave
                  if r.prefix_group is not None]
        shared = (len(groups) != len(set(groups))
                  or any(g in self.seen_groups for g in groups))
        return groups, dict(self._ctx_base, shared_prefix=shared,
                            active_paged=len(self.active)
                            + len(self.lane or ()))

    def _fifo_wave(self) -> bool:
        eng, clock, tr, m = self.eng, self.clock, self.tr, self.m
        wave = self.waiting[:eng.admission.max_batch]
        groups, ctx = self._route_ctx(wave)
        backend, reason = eng.policy.route(wave, ctx)
        decision = {"t": round(clock.now(), 6), "wave": len(wave),
                    "prompt_lens": [len(r.prompt) for r in wave],
                    "backend": backend, "rule": reason}
        if backend == "dense":
            self.decisions.append(decision)
            eng._wave_instant(tr, decision)
            del self.waiting[:len(wave)]
            self.seen_groups.update(g for g in groups)
            eng._run_dense_wave(wave, clock, m, self.outputs, tr=tr)
            return True
        wave = eng._order_wave(wave)
        n_adm, _, ptoks = eng._admit_paged(
            wave, self.book, clock, m, self.active, self.free_slots,
            self.slot_log, self.prefix_cached, self.seen_groups,
            self.outputs, tr=tr, lane=self.lane,
            sink=(self._handoff_sink if self.role == "prefill"
                  else None), acache=self.acache, spst=self.spst,
            hst=self.hst, gcache=self.gcache)
        self.prefill_tokens += ptoks
        for r in wave[:n_adm]:
            self.waiting.remove(r)  # possibly reordered: by identity
        if n_adm:
            decision["admitted"] = n_adm
            decision["admit_rids"] = [r.rid for r in wave[:n_adm]]
            self.decisions.append(decision)
            eng._wave_instant(tr, decision)
        elif not self.active and not self.lane \
                and not self.import_queue:
            raise RuntimeError(
                f"pool/slot config too small for {wave[0].rid} (free "
                f"pages {len(self.book._free)}, free slots "
                f"{len(self.free_slots)})")
        return n_adm > 0

    def _qos_wave(self, now: float) -> bool:
        eng, clock, tr, m = self.eng, self.clock, self.tr, self.m
        dec = self.sched.select(
            now, max_batch=eng.admission.max_batch, est=self.est,
            decode_chunk=eng.decode_chunk,
            match_prefix=(self.book.match_prefix if eng.prefix_cache
                          else None),
            backlog_cost=(eng._lane_backlog_cost(self.lane, self.est)
                          if self.lane else 0.0))
        progressed = self._shed(dec.shed)
        wave = dec.wave
        if not wave:
            return progressed
        groups, ctx = self._route_ctx(wave)
        backend, reason = eng.policy.route(wave, ctx)
        decision = {"t": round(clock.now(), 6), "wave": len(wave),
                    "prompt_lens": [len(r.prompt) for r in wave],
                    "backend": backend, "rule": reason,
                    "rids": [r.rid for r in wave]}
        if backend == "dense":
            self.decisions.append(decision)
            eng._wave_instant(tr, decision)
            self.seen_groups.update(g for g in groups)
            eng._commit_wave(wave, dec, self.sched, m, tr=tr,
                             t=clock.now())
            eng._run_dense_wave(wave, clock, m, self.outputs,
                                timeouts=True, tr=tr)
            return True
        t0 = clock.now()
        n_adm, n_chunks, ptoks = eng._admit_paged(
            wave, self.book, clock, m, self.active, self.free_slots,
            self.slot_log, self.prefix_cached, self.seen_groups,
            self.outputs, tr=tr, lane=self.lane,
            sink=(self._handoff_sink if self.role == "prefill"
                  else None), acache=self.acache, spst=self.spst,
            hst=self.hst, gcache=self.gcache)
        self.prefill_tokens += ptoks
        if n_adm:
            dt = clock.now() - t0
            self.est.observe("prefill", dt / n_adm)
            if n_chunks and "prefill_unit" in self.est.costs:
                self.est.observe("prefill_unit", dt / n_chunks)
            eng._commit_wave(wave[:n_adm], dec, self.sched, m, tr=tr,
                             t=clock.now())
            decision["admitted"] = n_adm
            self.decisions.append(decision)
            eng._wave_instant(tr, decision)
            return True
        if self.hst is not None and self.active \
                and eng._preempt_turn(wave[0], self.book, clock, m,
                                      self.active, self.free_slots,
                                      self.slot_log, self.sched,
                                      self.hst, self._shed, tr=tr,
                                      acache=self.acache,
                                      gcache=self.gcache):
            return True
        if not self.active and not self.lane \
                and not self.import_queue:
            raise RuntimeError(
                f"pool/slot config too small for {wave[0].rid} (free "
                f"pages {len(self.book._free)}, free slots "
                f"{len(self.free_slots)})")
        return progressed

    def advance_until(self, t: float):
        """Process this lane up to virtual time ``t``. Compute may
        overshoot ``t`` (a decode chunk crossing the horizon models a
        busy replica — same as the single-engine loop); an idle lane's
        clock jumps straight to ``t`` so later submissions see honest
        queueing delays.

        A CRASHED session advances its clock but processes nothing (a
        dead process has no turns). A STALLED session does the same
        until ``stall_until`` passes, then resumes mid-call — queued
        and in-flight work eats the pause, exactly the transient-slow
        replica the failure detector must NOT declare dead."""
        if self.crashed:
            self.clock.advance_to(t)
            return
        if self.stall_until is not None:
            if t < self.stall_until - 1e-12:
                self.clock.advance_to(t)
                return
            self.clock.advance_to(self.stall_until)
            self.stall_until = None
        while True:
            if self.queued() == 0 and not self.active \
                    and not self.lane and not self.import_queue:
                self.clock.advance_to(t)
                return
            if self.clock.now() >= t - 1e-12:
                return
            progressed = self._turn()
            if not progressed and not self.active and not self.lane:
                target = self._idle_target()
                if target is not None and target <= t:
                    self.clock.advance_to(target)
                else:
                    self.clock.advance_to(t)
                    return

    def finish(self) -> ServeResult:
        """No more arrivals will ever reach this session: run the
        backlog dry and build the ServeResult (idempotent)."""
        if self._finished is not None:
            return self._finished
        self.more_expected = False
        # a stall outliving the driven timeline is still real time:
        # the final backlog drain must eat the remaining pause, not
        # skip it (advance_until honors stalls; this loop drives
        # _turn directly)
        if self.stall_until is not None and not self.crashed:
            self.clock.advance_to(self.stall_until)
            self.stall_until = None
        # a crashed session has nothing left to run (its rows were
        # torn down at crash; its queue is rescued by the router) —
        # its result banks only the work that finished before death
        while not self.crashed and (self.queued() or self.active
                                    or self.lane
                                    or self.import_queue):
            progressed = self._turn()
            if not progressed and not self.active and not self.lane:
                target = self._idle_target()
                if target is None:
                    break  # everything left this turn was shed
                self.clock.advance_to(target)
        ServingEngine._stitch_resumes(self.outputs, self.hst)
        self._finished = ServeResult(
            policy=self.eng.policy.name, outputs=self.outputs,
            metrics=self.m, decisions=self.decisions,
            slot_log=self.slot_log, prefix_cached=self.prefix_cached,
            pages_total=self.pages_total,
            pages_free_end=(len(self.book._free)
                            + len(self.book._evictable)),
            scheduler=("fifo" if self.sched is None
                       else self.sched.name),
            shed=self.shed_log, trace=self.tr,
            prefill_tokens=self.prefill_tokens,
            cache_stats=dict(self.book.cache_stats(),
                             invariant_ok=self.inv_ok),
            replica=self.replica,
            incidents=ServingEngine._bank_incidents(self.slo),
            adapter_stats=(
                None if self.acache is None else
                dict(self.acache.cache_stats(),
                     invariant_ok=self.a_inv_ok)),
            spec_stats=(None if self.spst is None
                        else self.spst.stats()),
            kv_quant_stats=self.eng._quant_result(self.book,
                                                  self.qst),
            hostmem_stats=self.eng._hostmem_result(self.book,
                                                   self.hst),
            pages_spilled=(
                None if self.hst is None else
                self.book.cache_stats().get("spilled_pages", 0)),
            grammar_stats=(
                None if self.gcache is None else
                dict(self.gcache.cache_stats(),
                     invariant_ok=self.g_inv_ok)),
            cost_stats=self.eng._cost_result(self.clock, self.tr,
                                             self.m))
        return self._finished
