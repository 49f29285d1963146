"""``ServingEngine`` in the port (``paddle_tpu_torch.serving``) against the
JAX package's, on the CPU.

* Over ``SimServing`` (the host-only factory) on the fixed clock, every
  trace kind gives byte-identical outputs, slot logs, ``report()``, saved
  logs and chrome traces (the trace's ``wall_s`` arguments, host wall
  time, set aside).
* Over the serving factory of the reference test's tiny f32 Llama (the
  same weights, loaded through ``load_numpy_state_dict``): the dense
  factory's greedy tokens equal the reference's and its logits lie within
  ``LOGIT_TOL``; the engine's outputs, slot logs and reports under the
  routed, dense and paged policies equal the reference's, and the three
  policies' outputs equal each other.
* The options of ROADMAP item 11 that are ported (adapters, grammar,
  speculative decoding, the ragged lane) are built and serve a request
  (the memory tiers and dispatch-ahead are held in
  ``test_torch_serving_tiers.py``); ``tp``, which is not ported yet,
  raises an error that names its ROADMAP item.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as J
import paddle_tpu_torch.serving as T
from paddle_tpu.models.nlp import LlamaConfig as JaxConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.nlp.llama_decode import (
    llama_decode_factory as jax_dense_factory,
    llama_serving_decode_factory as jax_serving_factory)
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_decode_factory,
                                         llama_serving_decode_factory,
                                         load_numpy_state_dict)

PKG = {"jax": J, "torch": T}
# f32 logits, port against reference: the port's dense step attends the
# written slots only, the reference all max_len slots with the rest
# masked to probability 0: the same terms, summed in another order
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


# --- SimServing: byte-identical bookkeeping ----------------------------------

def _poisson(S):
    return S.synthesize_trace(seed=3, n_requests=30, arrival="poisson",
                              mean_interarrival=0.5, prompt_len=(4, 40),
                              output_len=(3, 12), vocab_size=509,
                              shared_prefix_frac=0.3, prefix_len=16,
                              churn_frac=0.3)


def _bursty(S):
    return S.synthesize_trace(seed=9, n_requests=24, arrival="bursty",
                              burst_size=6, mean_interarrival=0.7,
                              prompt_len=(8, 30), output_len=(3, 9),
                              vocab_size=509)


def _recurring(S):
    return S.synthesize_recurring_prefix_trace(
        seed=0, n_cohorts=2, cohort_size=3, rounds=3, prefix_len=24,
        tail_len=(2, 6), output_len=(3, 5), vocab_size=509, round_gap=40.0)


def _overload(S):
    return S.synthesize_overload_trace(
        seed=0, n_requests=40, service_tokens_per_unit=4.0, overload=2.0,
        prompt_len=(4, 12), output_len=(4, 12), vocab_size=509)


def _prefill_heavy(S):
    return S.synthesize_prefill_heavy_trace(seed=3, n_short=24, n_long=8,
                                            vocab_size=509)


SIM_CASES = {
    "poisson_churn": (_poisson, dict(decode_chunk=2)),
    "poisson_eos": (_poisson, dict(eos_token_id=7)),
    "bursty": (_bursty, dict()),
    "recurring_prefix_on": (_recurring, dict(prefix_cache=True)),
    "recurring_prefix_off": (_recurring, dict(prefix_cache=False)),
    "overload_fifo": (_overload, dict()),
    "overload_qos": (_overload, dict(scheduler="qos")),
    "prefill_heavy_lane": (_prefill_heavy, dict(
        prefill_chunk_budget=2, decode_chunk=4,
        fixed_costs={"prefill_unit": 1.0, "decode": 1.0})),
    "poisson_int8_ledger_slo": (_poisson, dict(kv_quant="int8",
                                               ledger=True)),
}


def _strip_wall(chrome):
    """The chrome trace without its host wall-time arguments."""
    for e in chrome["traceEvents"]:
        e.get("args", {}).pop("wall_s", None)
    return json.dumps(chrome)


def _sim_run(pkg, case, tmp_path):
    S = PKG[pkg]
    make, kw = SIM_CASES[case]
    kw = dict(kw)
    kv_quant = kw.pop("kv_quant", None)
    srv = S.SimServing(max_len=96, page_size=8, slots=4, vocab=509,
                       n_pool_pages=4 * 12 + 9, kv_quant=kv_quant)
    tracer = S.engine.obs_trace.Tracer()
    slo = S.engine.obs_slo.default_serving_rules() \
        if "ledger" in kw else None
    eng = S.ServingEngine(serving=srv, slots=4, policy="paged",
                          clock="fixed", trace=tracer, slo=slo, **kw)
    res = eng.run(make(S))
    path = tmp_path / f"{pkg}.jsonl"
    res.save_log(str(path))
    return {"outputs": res.outputs, "slot_log": res.slot_log,
            "decisions": res.decisions, "shed": res.shed,
            "report": json.dumps(res.report()),
            "report_slo": json.dumps(res.report(slo_ttft=4.0,
                                                slo_tpot=2.0)),
            "prefix_cached": res.prefix_cached,
            "prefill_tokens": res.prefill_tokens,
            "cache_stats": res.cache_stats,
            "kv_quant_stats": res.kv_quant_stats,
            "cost_stats": json.dumps(res.cost_stats),
            "incidents": [(i.kind, i.rule, i.t_open, i.rids)
                          for i in res.incidents or []],
            "log": path.read_bytes(),
            "loaded": S.load_engine_log(str(path)),
            "chrome": _strip_wall(tracer.to_chrome())}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_engine_is_byte_identical(case, tmp_path):
    ref = _sim_run("jax", case, tmp_path)
    got = _sim_run("torch", case, tmp_path)
    for key in ref:
        assert ref[key] == got[key], key
    assert ref["outputs"] and ref["slot_log"]


def test_sim_session_matches_run():
    """``session()`` driven arrival by arrival gives what ``run()`` gives,
    in both packages."""
    out = {}
    for pkg, S in PKG.items():
        trace = _poisson(S)

        def engine():
            return S.ServingEngine(serving=S.SimServing(
                max_len=96, page_size=8, slots=4, vocab=509,
                n_pool_pages=57), slots=4, policy="paged", clock="fixed")

        res = engine().run(trace)
        s = engine().session(expect_churn=True)
        for r in sorted(trace, key=lambda r: (r.arrival, r.rid)):
            s.advance_until(r.arrival)
            s.submit(r)
        ses = s.finish()
        assert ses.outputs == res.outputs and ses.slot_log == res.slot_log
        out[pkg] = (ses.outputs, ses.slot_log, ses.decisions)
    assert out["jax"] == out["torch"]


def test_clock_modes_and_measured_overhead():
    """The fixed clock prices each action; the measured clock charges
    wall time and reports the host-overhead split, in both packages."""
    for S in PKG.values():
        clk = S.EngineClock("fixed", {"prefill": 3.0, "decode_unit": 0.5})
        clk.timed("prefill", lambda: None)
        clk.timed("decode", lambda: None, units=4)
        clk.timed("prefill", lambda: None, units=0)
        assert clk.now() == 5.0
        res = S.ServingEngine(serving=S.SimServing(max_len=96, page_size=8,
                                                   slots=4, vocab=509),
                              slots=4, policy="paged",
                              clock="measured").run(_bursty(S))
        assert set(res.overhead) == {"run_wall_s", "device_wall_s",
                                     "engine_host_frac"}
        assert 0.0 <= res.overhead["engine_host_frac"] <= 1.0


def test_measured_clock_waits_for_the_result():
    """The port's measured clock times a call up to its result: CPU
    tensors and host data wait for nothing, and a result's tensors are
    walked through tuples and dicts."""
    from paddle_tpu_torch.serving.engine import _block_until_ready, _host

    out = (torch.ones(2), {"a": np.zeros(3)}, [torch.zeros(1)], None)
    assert _block_until_ready(out) is out
    x = _host(torch.tensor([1.5, 2.5], dtype=torch.bfloat16))
    assert x.dtype == np.float32 and x.tolist() == [1.5, 2.5]
    assert _host([1, 2]).tolist() == [1, 2]


def test_pool_bytes_read_no_tensor_data():
    """The engine prices a pool from its tensors' sizes alone: a tensor
    whose data cannot reach numpy (on the card, or here on the meta
    device) is never converted."""
    from paddle_tpu_torch.models.nlp.llama_decode import tree_device_bytes

    pools = ((torch.empty((2, 3, 4), dtype=torch.int8, device="meta"),
              torch.empty((2, 3), device="meta")), np.zeros(5, np.int16))
    assert tree_device_bytes(pools) == 24 + 24 + 10


# --- the tiny f32 Llama ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The reference test's model and serving factory (vocab 97, hidden
    32, 2 layers, 4 / 2 heads; max_len 48, pages of 8, 25 pool pages,
    capacity 4, chunks of 8), and the port's on the same weights."""
    paddle.seed(0)
    jcfg = JaxConfig.tiny(vocab=97, hidden=32, layers=2, heads=4, kv_heads=2)
    jmodel = JaxLlama(jcfg)
    jmodel.eval()
    state = {k: np.asarray(v._value) for k, v in
             jmodel.state_dict().items()}
    cfg = LlamaConfig.tiny(vocab=97, hidden=32, layers=2, heads=4,
                           kv_heads=2)
    model = load_numpy_state_dict(LlamaForCausalLM(cfg, device="cpu"),
                                  state)
    build = dict(max_len=48, page_size=8, n_pool_pages=25, batch_capacity=4,
                 chunked_prefill=8)
    return {"jax_model": jmodel, "model": model, "cfg": cfg,
            "jax_srv": jax_serving_factory(jmodel, **build),
            "srv": llama_serving_decode_factory(model, device="cpu",
                                                **build)}


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_dense_factory_matches_the_reference(tiny, kv_cache_dtype):
    """Greedy tokens of ``generate`` and ``generate.compiled`` equal the
    reference's; prefill and decode-step logits within LOGIT_TOL; the EOS
    early stop pads the same rows."""
    ref = jax_dense_factory(tiny["jax_model"], max_len=48,
                            kv_cache_dtype=kv_cache_dtype)
    gen = llama_decode_factory(tiny["model"], max_len=48,
                               kv_cache_dtype=kv_cache_dtype, device="cpu")
    prompts = np.random.default_rng(5).integers(1, 97, (3, 9)) \
        .astype(np.int32)
    want = np.asarray(ref(prompts, 12))
    assert (gen(prompts, 12).numpy() == want).all()
    assert (gen.compiled(prompts, 12) == np.asarray(
        ref.compiled(prompts, 12))).all()
    assert (gen.compiled(prompts, 0) == prompts).all()
    eos = int(want[1, 12])
    assert (gen(prompts, 12, eos_token_id=eos).numpy()
            == np.asarray(ref(prompts, 12, eos_token_id=eos))).all()

    jp, tp = ref._parts, gen._parts
    jk = jp["init_caches"](3, tiny["jax_model"].config.dtype)
    jv = jp["init_caches"](3, tiny["jax_model"].config.dtype)
    dt = tp["outer"]["model.embed_tokens.weight"].dtype
    tk, tv = tp["init_caches"](3, dt), tp["init_caches"](3, dt)
    jl, jk, jv = jp["prefill"](jp["outer"], jp["layers"], prompts, jk, jv)
    tl, tk, tv = tp["prefill"](tp["outer"], tp["layers"], prompts, tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    tok = np.asarray(jl).argmax(-1)
    jl, _, _ = jp["decode_step"](jp["outer"], jp["layers"], tok, 9, jk, jv)
    tl, _, _ = tp["decode_step"](tp["outer"], tp["layers"], tok, 9, tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_dense_sampling_draws_from_the_generator(tiny):
    """temperature > 0 samples from an explicit ``torch.Generator``: the
    same seed gives the same tokens, top-k 1 is greedy."""
    gen = llama_decode_factory(tiny["model"], max_len=48, device="cpu")
    prompts = np.random.default_rng(6).integers(1, 97, (2, 7))
    draws = [gen(prompts, 8, generator=torch.Generator().manual_seed(3),
                 temperature=0.8, top_k=20, top_p=0.9) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < 97
    assert torch.equal(gen(prompts, 8, temperature=1.0, top_k=1,
                           generator=torch.Generator().manual_seed(0)),
                       gen(prompts, 8))


def _mixed_trace(S):
    """The reference test's cross-policy trace: Poisson singles with
    churn merged with one uniform burst."""
    ragged = S.synthesize_trace(seed=3, n_requests=5, arrival="poisson",
                                mean_interarrival=0.5, prompt_len=(4, 14),
                                output_len=(3, 6), vocab_size=97,
                                churn_frac=0.3, rid_prefix="r")
    burst = S.synthesize_trace(seed=9, n_requests=4, arrival="bursty",
                               burst_size=4, mean_interarrival=0.7,
                               prompt_len=(8, 12), output_len=(3, 5),
                               vocab_size=97, rid_prefix="b")
    return S.merge_traces(ragged, burst)


def _real_run(tiny, pkg, policy, **kw):
    srv = tiny["jax_srv" if pkg == "jax" else "srv"]
    res = PKG[pkg].ServingEngine(serving=srv, slots=4, policy=policy,
                                 clock="fixed", **kw).run(
        _mixed_trace(PKG[pkg]))
    return res


@pytest.mark.parametrize("policy", ["routed", "dense", "paged"])
def test_engine_matches_the_reference(tiny, policy):
    ref = _real_run(tiny, "jax", policy)
    got = _real_run(tiny, "torch", policy)
    assert got.outputs == ref.outputs
    assert got.slot_log == ref.slot_log
    assert got.decisions == ref.decisions
    assert json.dumps(got.report()) == json.dumps(ref.report())
    assert got.cache_stats == ref.cache_stats
    assert got.pages_free_end == got.pages_total
    backends = {d["backend"] for d in got.decisions}
    assert backends == ({"dense"} if policy == "dense" else {"paged"})


def test_engine_policies_agree(tiny):
    outs = [_real_run(tiny, "torch", p).outputs
            for p in ("routed", "dense", "paged")]
    assert outs[0] == outs[1] == outs[2]
    assert len(outs[0]) == 9


def test_engine_routes_a_uniform_burst_dense(tiny):
    """expect_churn=False: routing reads each wave; a uniform full burst
    arriving alone goes dense, the ragged singles paged; the outputs equal
    the reference's."""
    res = {}
    for pkg, S in PKG.items():
        burst = S.synthesize_trace(seed=9, n_requests=4, arrival="bursty",
                                   burst_size=4, prompt_len=(8, 12),
                                   output_len=(3, 5), vocab_size=97,
                                   rid_prefix="b")
        singles = S.synthesize_trace(seed=3, n_requests=5,
                                     mean_interarrival=0.5,
                                     prompt_len=(4, 14), output_len=(3, 6),
                                     vocab_size=97, churn_frac=0.3,
                                     start=burst[0].arrival + 1.0)
        srv = tiny["jax_srv" if pkg == "jax" else "srv"]
        res[pkg] = S.ServingEngine(
            serving=srv, slots=4, policy="routed", clock="fixed",
            expect_churn=False, eos_token_id=5).run(
            S.merge_traces(burst, singles))
    assert res["torch"].outputs == res["jax"].outputs
    assert res["torch"].decisions == res["jax"].decisions
    assert {d["backend"] for d in res["torch"].decisions} == {"dense",
                                                              "paged"}


def test_engine_int8_pages_match_the_reference(tiny):
    """kv_quant="int8" through the model path of the constructor: both
    backends store the int8 codec; outputs and the stored-byte census
    equal the reference's."""
    res = {}
    for pkg, S in PKG.items():
        model = tiny["jax_model" if pkg == "jax" else "model"]
        kw = {} if pkg == "jax" else {"device": "cpu"}
        eng = S.ServingEngine(model, slots=4, max_len=48, page_size=8,
                              policy="routed", clock="fixed",
                              kv_quant="int8", **kw)
        res[pkg] = eng.run(_mixed_trace(S))
    assert res["torch"].outputs == res["jax"].outputs
    assert res["torch"].cache_stats == res["jax"].cache_stats
    assert res["torch"].kv_quant_stats == res["jax"].kv_quant_stats


def test_engine_kv_page_export_round_trips(tiny):
    """export_kv_pages gathers the page axis of every pool leaf;
    import_kv_pages writes it back in place."""
    eng = T.ServingEngine(serving=tiny["srv"], slots=4, policy="paged",
                          clock="fixed")
    eng.run(_mixed_trace(T))
    data = eng.export_kv_pages([3, 1])
    k, v = eng._pools
    assert torch.equal(data[0], k[:, :, [3, 1]])
    eng.import_kv_pages([5, 6], data)
    assert torch.equal(k[:, :, [5, 6]], data[0])
    assert torch.equal(v[:, :, [5, 6]], data[1])


# --- the options of ROADMAP item 11 that are ported, and the refusals ------

def _one_request(S, **kw):
    return S.synthesize_trace(seed=4, n_requests=1, prompt_len=(5, 9),
                              output_len=(8, 10), vocab_size=97, **kw)


def _served(tiny):
    """Each option refused until ROADMAP item 11's first four were
    ported: the engine options (through a prebuilt factory or the
    constructor's model path) and the serving factory's, each built and
    serving one request."""
    m, cfg = tiny["model"], tiny["cfg"]
    deltas = {"a": T.synthesize_lora_deltas(cfg, 1, seed=1)}
    schema = {"s": {"type": "boolean"}}
    model_path = dict(max_len=48, page_size=8, device="cpu")

    def fac(**kw):
        return llama_serving_decode_factory(
            m, device="cpu", max_len=48, page_size=8, n_pool_pages=25,
            batch_capacity=4, chunked_prefill=8, **kw)

    return {
        "adapters": (dict(serving=fac(lora=(2, 1)), adapters=deltas),
                     dict(adapter="a")),
        "lora": (dict(model=m, lora=(2, 1), adapters=deltas, **model_path),
                 dict(adapter="a")),
        "spec": (dict(serving=fac(draft=m), spec=True), {}),
        "spec_draft": (dict(model=m, spec=T.SpecConfig(n_draft=2),
                            spec_draft=m, **model_path), {}),
        "grammar": (dict(serving=fac(grammar=(2, 16)), grammar=schema),
                    dict(schema="s")),
        "grammar_config": (dict(model=m, grammar_config=(2, 16),
                                grammar=schema, **model_path),
                           dict(schema="s")),
        "adapter_schemas": (dict(serving=fac(lora=(2, 1), grammar=(2, 16)),
                                 adapters=deltas, grammar=schema,
                                 adapter_schemas={"a": "s"}),
                            dict(adapter="a")),
        "ragged_prefill": (dict(serving=fac(), ragged_prefill=True,
                                prefill_chunk_budget=1), {}),
        "factory_lora": (dict(serving=fac(lora=(2, 1))), {}),
        "factory_draft": (dict(serving=fac(draft=m)), {}),
        "factory_grammar": (dict(serving=fac(grammar=(2, 16))), {}),
    }


SERVED = ("adapters", "lora", "spec", "spec_draft", "grammar",
          "grammar_config", "adapter_schemas", "ragged_prefill",
          "factory_lora", "factory_draft", "factory_grammar")


@pytest.mark.parametrize("name", SERVED)
def test_option_is_built_and_serves(tiny, name):
    kw, req = _served(tiny)[name]
    trace = [dataclasses.replace(r, **req) for r in _one_request(T)]
    res = T.ServingEngine(slots=4, policy="paged", clock="fixed",
                          **kw).run(trace)
    (rid, out), = res.outputs.items()
    assert rid == trace[0].rid and 1 <= len(out) <= trace[0].max_new_tokens
    if name.startswith("factory_") or name in ("spec", "ragged_prefill"):
        assert len(out) == trace[0].max_new_tokens
    if "schema" in req or name == "adapter_schemas":
        assert T.schema_accepts({"type": "boolean"}, T.TokenVocab
                                .ascii_default(97).decode(out))
    if name.startswith("spec"):
        assert res.spec_stats["rounds"] > 0


REFUSED = {"tp": dict(tp=2)}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_engine_refuses_what_is_not_ported(tiny, name):
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 11"):
        T.ServingEngine(serving=tiny["srv"], slots=4, **REFUSED[name])


def test_engine_refuses_unported_factories_and_transforms(tiny):
    """A ``tp`` factory and the ``kv_reshard`` data plane refuse, naming
    ROADMAP item 11. The ``kv_repage`` and ``kv_transcode`` data planes
    of an int8 engine of 16-token pages give the reference engine's bytes
    on a chain of the tiny factory's pool (3 pages of 8, 19 tokens):
    re-paged to 2 pages of 16, then to int8; and the chain transcoded to
    the pressure tier gives the reference's bits."""
    from paddle_tpu.models.nlp.llama_decode import (
        transcode_kv_data as jax_transcode)
    from paddle_tpu_torch.models.nlp.llama_decode import transcode_kv_data

    with pytest.raises(NotImplementedError, match=r"ROADMAP item 11"):
        T.ServingEngine(serving=T.SimServing(tp=2), slots=4, policy="paged")
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 11"):
        T.ServingEngine(serving=tiny["srv"], slots=4).reshard_kv_pages(None)
    src = T.ServingEngine(serving=tiny["srv"], slots=4, policy="paged",
                          clock="fixed")
    src.run([T.Request(rid="a", arrival=0.0, prompt=tuple(range(1, 20)),
                       max_new_tokens=4)])
    chain = src.export_kv_pages([1, 2, 3])
    build = dict(max_len=48, page_size=16, n_pool_pages=13, batch_capacity=4,
                 chunked_prefill=16, kv_quant="int8")
    got_eng = T.ServingEngine(serving=llama_serving_decode_factory(
        tiny["model"], device="cpu", **build), slots=4, policy="paged")
    ref_eng = J.ServingEngine(serving=jax_serving_factory(
        tiny["jax_model"], **build), slots=4, policy="paged")
    got = got_eng.repage_kv_pages(chain, 8, 19)
    ref = ref_eng.repage_kv_pages(tuple(c.numpy() for c in chain), 8, 19)
    assert [tuple(g.shape) for g in got] == [(2, 2, 2, 16, 8)] * 2
    for g, r in zip(got, ref):
        assert g.numpy().tobytes() == np.asarray(r).tobytes()
    got, ref = (got_eng.transcode_kv_pages(got, None),
                ref_eng.transcode_kv_pages(ref, None))
    for g, r in zip(got, ref):          # (int8 data, f32 scales) of k, v
        assert g[0].dtype == torch.int8
        for gl, rl in zip(g, r):
            assert gl.numpy().tobytes() == np.asarray(rl).tobytes()
    got = transcode_kv_data(chain, None, "pressure")
    want = jax_transcode(tuple(c.numpy() for c in chain), None, "pressure")
    for g, r in zip(got[0] + got[1] + (got[2],),
                    want[0] + want[1] + (want[2],)):
        assert g.numpy().tobytes() == np.asarray(r).tobytes()


@pytest.mark.parametrize("option", [dict(tp=2)])
def test_serving_factory_refuses_what_is_not_ported(tiny, option):
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 11"):
        llama_serving_decode_factory(tiny["model"], device="cpu",
                                     chunked_prefill=64, **option)

