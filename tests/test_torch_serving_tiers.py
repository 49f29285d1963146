"""The serving engine's memory tiers and dispatch-ahead turns in the port
(``kv_quant="pressure"`` / ``kv_quant_budget``, ``hostmem``,
``dispatch_ahead``) against the JAX package's, on the CPU.

* Over ``SimServing`` on the fixed clock, each option's runs are
  byte-identical to the reference's: outputs, slot logs, ``report()``,
  ``save_log``, the chrome trace less its ``wall_s``, the tier stats;
  pressure flips and compaction under an SLO incident, budget-driven
  compaction through a session, host spill and page-in, preempt and
  resume, and dispatch-ahead (which equals the flag-off run, and serves
  turns from its stash).
* The tiny f32 Llama's two-tier pool: ``compact_kv_pages``,
  ``export_quant_pages``, ``import_quant_pages`` and the ``"pressure"``
  transcode give the reference's bits; the pressure, host-memory and
  dispatch-ahead engines give the reference's tokens, tier stats and
  censuses, and the reference's composition refusals, word for word.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.obs as JO
import paddle_tpu.serving as J
import paddle_tpu_torch.obs as TO
import paddle_tpu_torch.serving as T
from paddle_tpu.models.nlp import LlamaConfig as JaxConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.nlp import llama_decode as JD
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state_dict)
from paddle_tpu_torch.models.nlp import llama_decode as TD

PKG = {"jax": (J, JO), "torch": (T, TO)}
COSTS = {"prefill_unit": 1.0, "decode": 1.0}
HM_COSTS = {"prefill": 5.0, "decode": 1.0, "kv_pageout": 2.0,
            "kv_pagein": 2.0}
ARENA = 1 << 20


def _strip_wall(chrome):
    for e in chrome["traceEvents"]:
        e.get("args", {}).pop("wall_s", None)
    return json.dumps(chrome)


def _fingerprint(res, tracer, path):
    res.save_log(str(path))
    return {"outputs": res.outputs, "slot_log": res.slot_log,
            "decisions": res.decisions, "shed": res.shed,
            "report": json.dumps(res.report(), sort_keys=True),
            "cache_stats": res.cache_stats,
            "kv_quant_stats": res.kv_quant_stats,
            "hostmem_stats": res.hostmem_stats,
            "pages_spilled": res.pages_spilled,
            "incidents": [(i.kind, i.rule, i.t_open, i.rids)
                          for i in res.incidents or []],
            "log": path.read_bytes(),
            "chrome": _strip_wall(tracer.to_chrome())}


# --- SimServing: byte-identical bookkeeping ----------------------------------

def _pressure(S, O, tracer):
    """The reference's pressure tentpole: a ThresholdRule on the pool's
    stored bytes trips the tier through the QoS scheduler, parked pages
    compact, the incident closes and the tier flips off."""
    sim = S.make_sim_serving(max_len=64, page_size=8, n_pool_pages=48,
                             slots=8, vocab=509, chunked_prefill=8,
                             kv_quant="pressure")
    trace = S.synthesize_trace(seed=2, n_requests=80, vocab_size=509,
                               prompt_len=(8, 24), output_len=(4, 12),
                               shared_prefix_frac=0.3, prefix_len=16,
                               churn_frac=0.1)
    return S.ServingEngine(
        serving=sim, slots=8, policy="paged", clock="fixed",
        fixed_costs=dict(COSTS), scheduler=S.QoSScheduler(), trace=tracer,
        slo=[O.ThresholdRule(name="pool_pressure",
                             signal="pool_bytes_per_device",
                             bound=float(sim.page_bytes_[0] * 20),
                             op=">=", severity="page")],
        kv_quant_budget=sim.page_bytes_[0] * 40).run(trace)


def _churn(S, seed, n):
    return S.synthesize_trace(seed=seed, n_requests=n, arrival="poisson",
                              mean_interarrival=0.5, prompt_len=(4, 16),
                              output_len=(8, 24), vocab_size=509,
                              shared_prefix_frac=0.3, prefix_len=8,
                              churn_frac=0.2, rid_prefix="m")


def _pressure_session(S, O, tracer):
    """Budget-driven compaction through ``session()`` (the allocate seam
    fires it; no monitor)."""
    sim = S.make_sim_serving(max_len=64, page_size=8, n_pool_pages=30,
                             slots=4, vocab=509, kv_quant="pressure")
    sess = S.ServingEngine(serving=sim, slots=4, policy="paged",
                           clock="fixed", fixed_costs=dict(COSTS),
                           trace=tracer,
                           kv_quant_budget=sim.page_bytes_[0] * 22).session()
    for r in sorted(_churn(S, 6, 24), key=lambda r: (r.arrival, r.rid)):
        sess.advance_until(r.arrival)
        sess.submit(r)
    return sess.finish()


def _hm_engine(S, hostmem, slots=4, n_pool_pages=24, sched=None,
               tracer=None, **kw):
    sim = S.make_sim_serving(max_len=96, page_size=8, slots=slots,
                             vocab=211, n_pool_pages=n_pool_pages,
                             chunked_prefill=8)
    return S.ServingEngine(serving=sim, slots=slots, policy="paged",
                           clock="fixed", fixed_costs=dict(HM_COSTS),
                           scheduler=sched, trace=tracer, hostmem=hostmem,
                           **kw)


def _hostmem_spill(S, O, tracer):
    """Session turns whose parked prefixes overflow the pool spill to the
    arena and page back in on the next turn's prefix hit."""
    trace = S.synthesize_session_trace(
        seed=0, n_sessions=12, turns=3, think_time=150.0,
        first_prompt_len=(16, 32), turn_prompt_len=(6, 12),
        output_len=(6, 10), vocab_size=211, mean_interarrival=3.0)
    return _hm_engine(S, ARENA, tracer=tracer).run(trace)


def _preempt_pair(S):
    return [S.Request(rid="lo", prompt=tuple(range(10, 26)),
                      max_new_tokens=30, arrival=0.0, tenant="t0",
                      priority=0),
            S.Request(rid="hi", prompt=tuple(range(40, 56)),
                      max_new_tokens=8, arrival=20.0, tenant="t1",
                      priority=9)]


def _hostmem_preempt(S, O, tracer):
    """One slot: the QoS preempt rung swaps the running low-priority row
    out to the arena, serves the high-priority one, swaps it back."""
    sess = _hm_engine(S, ARENA, slots=1, sched=S.QoSScheduler(),
                      tracer=tracer).session()
    for r in _preempt_pair(S):
        sess.advance_until(r.arrival)
        sess.submit(r)
    return sess.finish()


def _ahead_trace(S):
    short = S.synthesize_trace(seed=3, n_requests=16, arrival="poisson",
                               mean_interarrival=0.6, prompt_len=(4, 16),
                               output_len=(8, 24), vocab_size=509,
                               rid_prefix="s")
    long = S.synthesize_trace(seed=4, n_requests=4, arrival="poisson",
                              mean_interarrival=3.0, prompt_len=(48, 72),
                              output_len=(4, 8), vocab_size=509,
                              rid_prefix="l")
    return S.merge_traces(short, long)


def _ahead(budget, ragged=False):
    def run(S, O, tracer):
        return S.ServingEngine(
            serving=S.make_sim_serving(max_len=96, page_size=8, slots=8,
                                       vocab=509),
            slots=8, policy="paged", clock="fixed", fixed_costs=dict(COSTS),
            decode_chunk=4, prefill_chunk_budget=budget,
            ragged_prefill=ragged, dispatch_ahead=True,
            trace=tracer).run(_ahead_trace(S))
    return run


SIM_CASES = {"pressure_incident": _pressure,
             "pressure_budget_session": _pressure_session,
             "hostmem_spill": _hostmem_spill,
             "hostmem_preempt": _hostmem_preempt,
             "dispatch_ahead": _ahead(None),
             "dispatch_ahead_lane": _ahead(2),
             "dispatch_ahead_ragged": _ahead(2, ragged=True)}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_tier_is_byte_identical(case, tmp_path):
    got = {}
    for pkg, (S, O) in PKG.items():
        tracer = O.Tracer()
        got[pkg] = _fingerprint(SIM_CASES[case](S, O, tracer), tracer,
                                tmp_path / f"{pkg}.jsonl")
    for key in got["jax"]:
        assert got["jax"][key] == got["torch"][key], key
    res = got["torch"]
    assert res["outputs"] and res["slot_log"]
    rep = json.loads(res["report"])
    if case.startswith("pressure"):
        qs = res["kv_quant_stats"]
        assert qs["compactions"] >= 1
        if case == "pressure_incident":
            assert qs["pages_compacted"] > 0
            assert [f["enabled"] for f in qs["flips"]][:2] == [True, False]
            assert rep["kv_quant_flips"] == len(qs["flips"])
    if case.startswith("hostmem"):
        hs = res["hostmem_stats"]
        assert hs["arena_census_ok"] is True
        if case == "hostmem_spill":
            assert hs["spills"] > 0 and hs["pageins"] > 0
        else:
            assert hs["preempts"] >= 1 and hs["restores"] >= 1


@pytest.mark.parametrize("budget,ragged", [(None, False), (2, False),
                                           (2, True)])
def test_dispatch_ahead_equals_the_flag_off_run(budget, ragged):
    """The fixed clock prices the same work with the flag on: outputs,
    slot logs and reports equal the flag-off engine's, and the stash
    serves decode turns (spans tagged ``ahead``)."""
    tracer = TO.Tracer()
    on = _ahead(budget, ragged)(T, TO, tracer)
    off = T.ServingEngine(
        serving=T.make_sim_serving(max_len=96, page_size=8, slots=8,
                                   vocab=509),
        slots=8, policy="paged", clock="fixed", fixed_costs=dict(COSTS),
        decode_chunk=4, prefill_chunk_budget=budget,
        ragged_prefill=ragged).run(_ahead_trace(T))
    assert on.outputs == off.outputs
    assert on.slot_log == off.slot_log
    assert on.report() == off.report()
    served = [e for e in tracer.events if e.get("ph") == "X"
              and e.get("name") == "decode"
              and e.get("args", {}).get("ahead")]
    assert served, "no decode turn was served from the stash"


# --- the tiny f32 Llama's two-tier pool --------------------------------------

def _pools(seed, P=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    L, H, S, D = 2, 2, 4, 8
    kf = rng.normal(0, 1, (L, H, P, S, D)).astype(dtype)
    vf = rng.normal(0, 1, (L, H, P, S, D)).astype(dtype)
    kf[0, 0, 1, 2] = 0.0                     # an all-zero slot
    return kf, vf


def _as_jax(kf, vf, P):
    zq = jnp.zeros(kf.shape, jnp.int8)
    zs = jnp.ones(kf.shape[:-1], jnp.float32)
    return ((jnp.asarray(kf), zq, zs), (jnp.asarray(vf), zq, zs),
            jnp.zeros((P,), bool))


def _as_torch(kf, vf, P):
    def one(fp):
        return (torch.tensor(fp), torch.zeros(fp.shape, dtype=torch.int8),
                torch.ones(fp.shape[:-1]))
    return one(kf), one(vf), torch.zeros(P, dtype=torch.bool)


def _same(got, want):
    g, w = TD._leaves(got), [np.asarray(a) for a in
                             JD.jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() \
            == b.tobytes()


def test_compaction_export_import_are_bit_equal():
    """Compaction quantizes only the masked pages (twice: a second batch
    over a mixed pool), in place; an exported mixed-tier chain imports
    into fresh pages exactly; the bits equal the reference's."""
    kf, vf = _pools(0, P=5)
    got, want = _as_torch(kf, vf, 5), _as_jax(kf, vf, 5)
    for mask in ([False, True, False, False, True],
                 [True, False, False, False, False]):
        same = TD.compact_kv_pages(got, torch.tensor(mask))
        assert same is got
        want = JD.compact_kv_pages(want, jnp.asarray(mask))
        _same(got, want)
    assert got[2].tolist() == [True, True, False, False, True]
    chain = TD.export_quant_pages(got, [1, 2, 4])
    _same(chain, JD.export_quant_pages(want, [1, 2, 4]))
    fresh_t, fresh_j = _as_torch(*_pools(1, P=5), 5), \
        _as_jax(*_pools(1, P=5), 5)
    TD.import_quant_pages(fresh_t, [0, 3, 2], chain)
    _same(fresh_t, JD.import_quant_pages(fresh_j, [0, 3, 2],
                                         JD.export_quant_pages(
                                             want, [1, 2, 4])))
    assert fresh_t[2].tolist() == [True, False, True, False, False]


def test_pressure_transcode_is_bit_equal():
    kf, vf = _pools(2)
    got = TD.transcode_kv_data((torch.tensor(kf), torch.tensor(vf)), None,
                               "pressure")
    _same(got, JD.transcode_kv_data((kf, vf), None, "pressure"))
    assert got[2].dtype == torch.bool and bool(got[2].all())


@pytest.fixture(scope="module")
def tiny():
    """The reference tests' tiny f32 Llama (vocab 97, hidden 32, 2
    layers, 4 / 2 heads, seed 0) and the port's on its weights."""
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny(vocab=97, hidden=32, layers=2, heads=4,
                                 kv_heads=2))
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = load_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(vocab=97, hidden=32, layers=2,
                                          heads=4, kv_heads=2),
                         device="cpu"), state)
    return {"jax": jm, "torch": tm}


def _factory(tiny, pkg, n_pages=41, **kw):
    build = dict(max_len=64, page_size=8, n_pool_pages=n_pages,
                 batch_capacity=4, chunked_prefill=8, **kw)
    if pkg == "jax":
        return JD.llama_serving_decode_factory(tiny["jax"], **build)
    return TD.llama_serving_decode_factory(tiny["torch"], device="cpu",
                                           **build)


def _both(tiny, make_trace, fac_kw, eng_kw):
    """The same engine over each package's tiny factory."""
    out = {}
    for pkg, (S, O) in PKG.items():
        kw = {k: (v(S) if callable(v) else v) for k, v in eng_kw.items()}
        srv = _factory(tiny, pkg, **fac_kw)
        if "kv_quant_budget" in kw:
            kw["kv_quant_budget"] *= srv.page_bytes_[0]
        out[pkg] = S.ServingEngine(serving=srv, slots=kw.pop("slots", 4),
                                   policy="paged", clock="fixed",
                                   **kw).run(make_trace(S))
    return out["jax"], out["torch"]


def _real_trace(S):
    return S.synthesize_trace(seed=3, n_requests=10, arrival="poisson",
                              mean_interarrival=0.5, prompt_len=(8, 16),
                              output_len=(4, 8), vocab_size=97,
                              shared_prefix_frac=0.5, prefix_len=8,
                              churn_frac=0.2, rid_prefix="p")


def _assert_same_run(ref, got):
    assert got.outputs == ref.outputs
    assert got.slot_log == ref.slot_log
    assert got.cache_stats == ref.cache_stats
    assert got.kv_quant_stats == ref.kv_quant_stats
    assert json.dumps(got.report(), sort_keys=True) \
        == json.dumps(ref.report(), sort_keys=True)


def test_real_pressure_engine_matches_the_reference(tiny):
    """Budget-driven compaction on the two-tier pool (20 pages, a budget
    of 14 full-precision pages): the same compactions, censuses and
    tokens as the reference; and with no budget and no incident the
    tier stays off and the streams equal a full-precision engine's."""
    ref, got = _both(tiny, _real_trace, dict(kv_quant="pressure",
                                             n_pages=20),
                     dict(kv_quant_budget=14))
    _assert_same_run(ref, got)
    assert got.kv_quant_stats["compactions"] >= 1
    assert got.cache_stats["invariant_ok"]
    fp = T.ServingEngine(serving=_factory(tiny, "torch"), slots=4,
                         policy="paged", clock="fixed").run(_real_trace(T))
    idle = T.ServingEngine(serving=_factory(tiny, "torch",
                                            kv_quant="pressure"),
                           slots=4, policy="paged",
                           clock="fixed").run(_real_trace(T))
    assert idle.outputs == fp.outputs
    assert idle.kv_quant_stats["pages_compacted"] == 0


def _session_trace(S):
    return S.synthesize_session_trace(
        seed=0, n_sessions=4, turns=2, think_time=60.0,
        first_prompt_len=(8, 16), turn_prompt_len=(4, 8),
        output_len=(4, 8), vocab_size=97, mean_interarrival=1.0)


def test_real_hostmem_engine_matches_the_reference(tiny):
    """A 13-page pool under session turns: real page content spills to
    the arena and pages back in; the same spills, page-ins, censuses and
    tokens as the reference, and the tokens of an engine without the
    arena. The arena holds host tensors."""
    ref, got = _both(tiny, _session_trace, dict(n_pages=13),
                     dict(fixed_costs=dict(HM_COSTS), hostmem=1 << 22))
    _assert_same_run(ref, got)
    assert got.hostmem_stats == ref.hostmem_stats
    assert got.hostmem_stats["spills"] > 0
    plain = T.ServingEngine(serving=_factory(tiny, "torch", n_pages=13),
                            slots=4, policy="paged", clock="fixed",
                            fixed_costs=dict(HM_COSTS)).run(
        _session_trace(T))
    assert got.outputs == plain.outputs


def test_real_preempt_resume_matches_the_reference(tiny):
    lo = dict(rid="lo", prompt=tuple(range(1, 17)), max_new_tokens=20,
              arrival=0.0, priority=0)
    hi = dict(rid="hi", prompt=tuple(range(30, 46)), max_new_tokens=4,
              arrival=10.0, priority=9)
    ref, got = _both(tiny, lambda S: [S.Request(**lo), S.Request(**hi)],
                     {}, dict(slots=1, fixed_costs=dict(HM_COSTS),
                              hostmem=1 << 22,
                              scheduler=lambda S: S.QoSScheduler()))
    _assert_same_run(ref, got)
    assert got.hostmem_stats == ref.hostmem_stats
    assert got.hostmem_stats["preempts"] >= 1
    solo = T.ServingEngine(serving=_factory(tiny, "torch"), slots=1,
                           policy="paged", clock="fixed").run(
        [T.Request(**lo)])
    assert got.outputs["lo"] == solo.outputs["lo"]


def test_real_dispatch_ahead_matches_the_reference(tiny):
    kw = dict(decode_chunk=2, prefill_chunk_budget=1, ragged_prefill=True,
              dispatch_ahead=True)
    ref, got = _both(tiny, _real_trace, {}, kw)
    _assert_same_run(ref, got)
    off = T.ServingEngine(serving=_factory(tiny, "torch"), slots=4,
                          policy="paged", clock="fixed",
                          **{**kw, "dispatch_ahead": False}).run(
        _real_trace(T))
    assert got.outputs == off.outputs and got.slot_log == off.slot_log


def _refusals(S, srv, fac):
    """The reference's composition refusals of the three options."""
    sim = S.make_sim_serving
    return [
        lambda: S.ServingEngine(serving=sim(max_len=96, page_size=8,
                                            slots=8, vocab=97,
                                            spec_accept=0.9),
                                slots=8, policy="paged",
                                spec=S.SpecConfig(), dispatch_ahead=True),
        lambda: S.ServingEngine(serving=sim(max_len=96, page_size=8,
                                            slots=8, vocab=97,
                                            kv_quant="pressure"),
                                slots=8, policy="paged",
                                kv_quant="pressure", dispatch_ahead=True),
        lambda: S.ServingEngine(serving=sim(max_len=96, page_size=8,
                                            slots=8, vocab=97),
                                slots=8, policy="paged", hostmem=True),
        lambda: S.ServingEngine(serving=sim(max_len=96, page_size=8,
                                            slots=8, vocab=97),
                                slots=8, policy="paged", hostmem=ARENA,
                                dispatch_ahead=True),
        lambda: S.ServingEngine(serving=sim(max_len=96, page_size=8,
                                            slots=8, vocab=97,
                                            spec_accept=0.9),
                                slots=8, policy="paged", hostmem=ARENA,
                                spec=S.SpecConfig()),
        lambda: S.ServingEngine(serving=sim(max_len=96, page_size=8,
                                            slots=8, vocab=97,
                                            kv_quant="pressure",
                                            spec_accept=0.9),
                                slots=8, policy="paged",
                                spec=S.SpecConfig()),
        lambda: S.ServingEngine(serving=srv, slots=4, policy="paged",
                                kv_quant="int8"),
        lambda: S.ServingEngine(serving=srv, slots=4, policy="paged",
                                kv_quant_budget=0),
        lambda: fac(kv_quant="pressure", kv_cache_dtype="int8"),
        lambda: fac(kv_quant="fp4")]


def test_composition_refusals_match_the_reference(tiny):
    """Each option refuses what the reference's refuses, with its
    message."""
    msgs = {}
    for pkg, (S, O) in PKG.items():
        srv = _factory(tiny, pkg, kv_quant="pressure")

        def fac(**kw):
            return _factory(tiny, pkg, **kw)
        msgs[pkg] = []
        for make in _refusals(S, srv, fac):
            with pytest.raises(ValueError) as e:
                make()
            msgs[pkg].append(str(e.value))
    assert msgs["torch"] == msgs["jax"]
    assert any("dispatch_ahead" in m for m in msgs["torch"])


def test_pressure_factory_is_paged_only(tiny):
    """A pressure serving factory has no dense backend: ``pick`` gives
    the paged one whatever the batch, its dense stub refuses by the
    reference's reason, and it carries the engine's tier hooks."""
    srv = _factory(tiny, "torch", kv_quant="pressure")
    backend, parts = srv.pick([8, 8, 8, 8], capacity=4)
    assert backend == "paged" and parts is srv.paged_parts
    with pytest.raises(NotImplementedError, match="paged-only"):
        srv.dense(np.ones((1, 4), np.int32), 2)
    assert srv.compact_pages is TD.compact_kv_pages
    pools = srv.paged_parts[2]
    assert pools[2].dtype == torch.bool and pools[0][1].dtype == torch.int8
    assert srv.page_bytes_ == JD.kv_quant_page_bytes(
        tiny["jax"].config, 8, np.float32)
