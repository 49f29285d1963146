"""The serving engine's options in the port against the JAX package's, on
the CPU: multi-adapter LoRA (``adapters`` / ``lora``), constrained
decoding (``grammar``), speculative decoding (``spec``) and the fused
ragged prefill lane (``ragged_prefill``).

* Over ``SimServing`` on the fixed clock, each option gives outputs, slot
  logs, decisions, ``report()``, the option's stats, ``save_log`` bytes
  and the chrome trace (less its ``wall_s`` arguments, host wall time)
  byte-identical to the reference's.
* On the reference tests' tiny f32 Llama (vocab 97, hidden 32, 2 layers,
  4 / 2 heads; the draft hidden 16, 1 layer, 2 / 1 heads), loaded through
  ``load_numpy_state_dict``: ``_bgmv`` within ``F32_TOL``; the grammar
  mask's allowed set and the adapter and grammar banks exactly the
  reference's (a word with bit 31 set included); ``build_spec_step``'s
  ``(accepted, cand)`` and the greedy tokens of ``prefill`` /
  ``decode_step`` / ``decode_n`` with ``lora=`` and ``grammar=`` equal to
  the reference's; ``prefill_ragged`` logits within ``LOGIT_TOL``; and
  the engine with each option equal to the reference engine on the same
  trace, adapter-free and grammar-free rows equal to the plain factory's,
  the perfect draft accepting every proposal.
* The reference's composition errors, word for word.
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
from paddle_tpu.models.nlp import llama_decode as jd
from paddle_tpu.obs.slo import BurnRateRule as JaxBurnRateRule
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_paged_decode_factory,
                                         load_numpy_state_dict)
from paddle_tpu_torch.models.nlp import llama_decode as td
from paddle_tpu_torch.obs.slo import BurnRateRule

PKG = {"jax": J, "torch": T}
DEC = {"jax": jd, "torch": td}
# f32 products of the same terms summed in another order, on values of
# size up to ~10 (a few f32 ulps of that)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# f32 last-position logits through 2 layers, port against reference
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 97


# --- SimServing: byte-identical bookkeeping ----------------------------------

# one required property per schema, the key baked per schema id (the
# reference grammar tests' palette)
_KINDS = [{"type": "boolean"}, {"type": "integer", "maxDigits": 3},
          {"enum": ["lo", "mid", "hi"]}, {"type": "string", "maxLength": 6}]


def _schemas(n):
    return {f"s{k}": {"type": "object",
                      "properties": {f"k{k}": _KINDS[k % len(_KINDS)]},
                      "required": [f"k{k}"]}
            for k in range(n)}


def _sim_adapters(S, n=4):
    return S.AdapterStore({f"a{k}": {"salt": 7919 * (k + 1)}
                           for k in range(n)})


def _zipf(S, seed=0, n=60):
    return S.synthesize_zipf_adapter_trace(seed=seed, n_requests=n,
                                          n_adapters=4, base_frac=0.2,
                                          churn_frac=0.1)


def _churn(S, seed=0, n=60):
    return S.synthesize_trace(seed=seed, n_requests=n, arrival="poisson",
                              mean_interarrival=0.5, prompt_len=(4, 16),
                              output_len=(8, 24), vocab_size=509,
                              shared_prefix_frac=0.3, prefix_len=8,
                              churn_frac=0.2, rid_prefix="m")


def _priority_mix(S):
    return [dataclasses.replace(r, priority=1 if i % 3 == 0 else 0)
            for i, r in enumerate(_churn(S, seed=9, n=20))]


def _deadline_mix(S):
    return S.synthesize_deadline_mix_trace(
        seed=0, n_requests=220, service_tokens_per_unit=8.0,
        base_load=0.55, surge=(0.45, 0.2, 5.0), output_len=(6, 16))


def _schema_trace(S, seed=0, n=40, **kw):
    return S.synthesize_schema_trace(seed=seed, n_requests=n, n_schemas=4,
                                     vocab_size=509, overload=0.6, **kw)


def _burst(S, seed=0):
    return S.synthesize_admission_burst_trace(seed=seed, vocab_size=101,
                                              n_bursts=2, burst_size=6,
                                              n_background=4)


def _prefill_heavy(S):
    return S.synthesize_prefill_heavy_trace(seed=0, n_short=24, n_long=8,
                                            vocab_size=101)


def _mixed_ragged(S):
    return S.synthesize_trace(seed=0, n_requests=24, arrival="poisson",
                              mean_interarrival=2.0, prompt_len=(6, 40),
                              output_len=(4, 20), vocab_size=101,
                              shared_prefix_frac=0.3, prefix_len=16,
                              churn_frac=0.2, rid_prefix="m")


LORA_COSTS = {"prefill_unit": 1.0, "decode": 1.0, "adapter_upload": 1.0}
SPEC_COSTS = {"prefill_unit": 1.0, "decode": 1.0, "spec_decode": 1.25,
              "spec_prefill": 0.25}
GRAMMAR_COSTS = {"prefill_unit": 1.0, "decode": 1.0,
                 "grammar_compile": 1.0}
RAGGED_COSTS = {"prefill_unit": 1.0, "decode": 1.0}


def _burn_rule(S):
    rule = JaxBurnRateRule if S is J else BurnRateRule
    return rule(name="deadline_burn", objective=0.6,
                windows=((60.0, 1.5), (15.0, 1.5)), bad="deadline_missed",
                min_events=10, severity="page")


# name: (trace, sim build, engine options); each option's value may be a
# function of the package
SIM_CASES = {
    "lora_zipf_churning_bank": (_zipf, dict(max_len=64, lora_slots=3), dict(
        adapters=_sim_adapters, fixed_costs=LORA_COSTS, decode_chunk=4)),
    "lora_zipf_roomy_bank": (lambda S: _zipf(S, seed=2, n=50),
                             dict(max_len=64, lora_slots=5), dict(
        adapters=_sim_adapters, fixed_costs=LORA_COSTS, decode_chunk=4)),
    "lora_qos": (lambda S: _zipf(S, seed=4, n=40),
                 dict(max_len=64, lora_slots=3), dict(
        adapters=_sim_adapters, fixed_costs=LORA_COSTS, decode_chunk=4,
        scheduler=lambda S: S.QoSScheduler())),
    "spec_churn": (_churn, dict(max_len=64, n_pool_pages=8 * 8 + 1 + 16,
                                spec_accept=0.85), dict(
        spec=lambda S: S.SpecConfig(n_draft=4), fixed_costs=SPEC_COSTS,
        expect_churn=True)),
    "spec_priority_mix": (_priority_mix, dict(
        max_len=64, n_pool_pages=8 * 8 + 1 + 16, spec_accept=0.85), dict(
        spec=lambda S: S.SpecConfig(n_draft=4), fixed_costs=SPEC_COSTS,
        expect_churn=True)),
    "spec_floor_latches": (lambda S: _churn(S, seed=1, n=40), dict(
        max_len=64, n_pool_pages=8 * 8 + 1 + 16, spec_accept=0.1), dict(
        spec=lambda S: S.SpecConfig(n_draft=4, accept_floor=0.5,
                                    min_rounds=4),
        fixed_costs=SPEC_COSTS, expect_churn=True)),
    "spec_deadline_mix_overload": (_deadline_mix, dict(
        max_len=64, n_pool_pages=8 * 8 + 1 + 16, spec_accept=0.85), dict(
        spec=lambda S: S.SpecConfig(n_draft=4), fixed_costs=SPEC_COSTS,
        expect_churn=True, scheduler=lambda S: S.QoSScheduler(max_queue=64),
        slo=lambda S: [_burn_rule(S)])),
    "grammar_schemas": (_schema_trace, dict(max_len=96, grammar_slots=5),
                        dict(grammar=lambda S: S.GrammarStore(_schemas(4)),
                             fixed_costs=GRAMMAR_COSTS, decode_chunk=4)),
    "grammar_free_rows": (lambda S: _schema_trace(S, seed=2, n=50,
                                                  free_frac=0.4),
                          dict(max_len=96, grammar_slots=5),
                          dict(grammar=lambda S: S.GrammarStore(_schemas(4)),
                               fixed_costs=GRAMMAR_COSTS, decode_chunk=4)),
    "grammar_adapter_schemas": (
        lambda S: [dataclasses.replace(r, adapter=f"a{i % 2}")
                   if i % 3 else r for i, r in enumerate(
                       _schema_trace(S, seed=3, n=30, free_frac=0.5))],
        dict(max_len=96, grammar_slots=5, lora_slots=3),
        dict(grammar=lambda S: S.GrammarStore(_schemas(4)),
             adapters=lambda S: _sim_adapters(S, 2),
             adapter_schemas={"a1": "s1"},
             fixed_costs=dict(GRAMMAR_COSTS, adapter_upload=1.0),
             decode_chunk=4)),
    "ragged_admission_burst": (_burst, dict(max_len=96, vocab=101,
                                            n_pool_pages=8 * 12 + 1 + 16),
                               dict(ragged_prefill=True,
                                    prefill_chunk_budget=2,
                                    fixed_costs=RAGGED_COSTS,
                                    decode_chunk=4)),
    "ragged_prefill_heavy": (_prefill_heavy, dict(
        max_len=96, vocab=101, n_pool_pages=8 * 12 + 1 + 16), dict(
        ragged_prefill=True, prefill_chunk_budget=2,
        fixed_costs=RAGGED_COSTS, decode_chunk=4)),
    "ragged_mixed_churn_flat_cost": (_mixed_ragged, dict(
        max_len=96, vocab=101, n_pool_pages=8 * 12 + 1 + 16), dict(
        ragged_prefill=True, prefill_chunk_budget=2,
        fixed_costs={"prefill": 1.0, "decode": 1.0}, decode_chunk=4)),
    "ragged_lora": (lambda S: [dataclasses.replace(r, adapter=f"a{i % 3}")
                               for i, r in enumerate(_burst(S, seed=1))],
                    dict(max_len=96, vocab=101, n_pool_pages=8 * 12 + 1 + 16,
                         lora_slots=4),
                    dict(ragged_prefill=True, prefill_chunk_budget=2,
                         adapters=lambda S: _sim_adapters(S, 3),
                         fixed_costs=dict(RAGGED_COSTS, adapter_upload=1.0),
                         decode_chunk=4)),
}


def _strip_wall(chrome):
    """The chrome trace without its host wall-time arguments."""
    for e in chrome["traceEvents"]:
        e.get("args", {}).pop("wall_s", None)
    return json.dumps(chrome)


def _sim_run(pkg, case, tmp_path):
    S = PKG[pkg]
    make, build, opts = SIM_CASES[case]
    build = dict(dict(page_size=8, slots=8, vocab=509), **build)
    opts = {k: v(S) if callable(v) else v for k, v in opts.items()}
    tracer = S.engine.obs_trace.Tracer()
    eng = S.ServingEngine(serving=S.make_sim_serving(**build), slots=8,
                          policy="paged", clock="fixed", trace=tracer,
                          **opts)
    res = eng.run(make(S))
    path = tmp_path / f"{pkg}.jsonl"
    res.save_log(str(path))
    return {"outputs": res.outputs, "slot_log": res.slot_log,
            "decisions": res.decisions, "shed": res.shed,
            "report": json.dumps(res.report()),
            "prefix_cached": res.prefix_cached,
            "cache_stats": res.cache_stats,
            "adapter_stats": res.adapter_stats,
            "grammar_stats": res.grammar_stats,
            "spec_stats": json.dumps(res.spec_stats),
            "incidents": [(i.kind, i.rule, i.t_open, i.rids)
                          for i in res.incidents or []],
            "log": path.read_bytes(),
            "chrome": _strip_wall(tracer.to_chrome())}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_feature_is_byte_identical(case, tmp_path):
    ref = _sim_run("jax", case, tmp_path)
    got = _sim_run("torch", case, tmp_path)
    for key in ref:
        assert ref[key] == got[key], key
    assert ref["outputs"] and ref["slot_log"]
    feature = case.split("_")[0]
    if feature == "lora":
        assert ref["adapter_stats"]["invariant_ok"]
    if feature == "grammar":
        assert ref["grammar_stats"]["invariant_ok"]
    if feature == "spec":
        assert json.loads(ref["spec_stats"])["rounds"] > 0


# --- the tiny f32 Llama ------------------------------------------------------

def _pair(seed, **kw):
    """A reference Llama from ``paddle.seed(seed)`` and the port's on the
    same weights."""
    paddle.seed(seed)
    jmodel = JaxLlama(JaxConfig.tiny(**kw))
    jmodel.eval()
    state = {k: np.asarray(v._value) for k, v in
             jmodel.state_dict().items()}
    model = load_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu"), state)
    return jmodel, model


TARGET = dict(vocab=VOCAB, hidden=32, layers=2, heads=4, kv_heads=2)
DRAFT = dict(vocab=VOCAB, hidden=16, layers=1, heads=2, kv_heads=1)
BUILD = dict(max_len=48, page_size=8, n_pool_pages=25, batch_capacity=4,
             chunked_prefill=8)
SPEC_BUILD = dict(max_len=64, page_size=8, n_pool_pages=4 * 8 + 1 + 8,
                  batch_capacity=4, chunked_prefill=8)


@pytest.fixture(scope="module")
def tiny():
    """The reference tests' target (seed 0), its perfect twin (the same
    weights), an independent draft (seed 1), three LoRA delta sets of
    rank 2 and a 3-schema store."""
    jmodel, model = _pair(0, **TARGET)
    jdraft, draft = _pair(1, **DRAFT)
    deltas = {f"a{k}": td.synthesize_lora_deltas(model.config, 2, seed=k + 1,
                                                 init_scale=0.25)
              for k in range(3)}
    return {"jax": {"model": jmodel, "draft": jdraft, "twin": jmodel},
            "torch": {"model": model, "draft": draft, "twin": model},
            "deltas": deltas, "schemas": _schemas(3)}


def _factory(tiny, pkg, build=BUILD, **kw):
    """The serving factory of ``pkg`` over the tiny model; ``draft=`` and
    ``twin=`` name the fixture's draft models."""
    m = tiny[pkg]
    for name in ("draft", "twin"):
        if kw.pop(name, False):
            kw["draft"] = m[name]
    if pkg == "torch":
        kw["device"] = "cpu"
    return DEC[pkg].llama_serving_decode_factory(m["model"], **build, **kw)


def test_bgmv_matches_the_reference():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 5, 32)).astype(np.float32)
    A = rng.standard_normal((4, 32, 2)).astype(np.float32)
    B = rng.standard_normal((4, 2, 24)).astype(np.float32)
    A[0], B[0] = 0, 0                  # the identity slot
    ids = np.asarray([2, 0, 2], np.int32)
    want = np.asarray(jd._bgmv(h, A, B, ids))
    got = td._bgmv(*(torch.from_numpy(a) for a in (h, A, B, ids)))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert not got[1].any()            # a slot-0 row: exactly 0


def test_gmask_allows_exactly_the_set_bits():
    """Words with bit 31 set read negative as int32: the arithmetic shift
    keeps the bit for ``& 1``, so the allowed set is the uint32 bits."""
    rng = np.random.default_rng(1)
    V = 70
    words = rng.integers(0, 2 ** 32, (3, 3), dtype=np.uint64) \
        .astype(np.uint32)
    words[1] = [0x80000000, 0xFFFFFFFF, 0x80000001]
    words[2] = 0
    table = torch.from_numpy(words.view(np.int32))
    assert (table[1] < 0).all()
    logits = torch.from_numpy(rng.standard_normal((4, V)).astype(np.float32))
    gids = torch.tensor([1, 0, 2, 1])
    got = td._gmask(logits, (table, gids))
    bits = (words[:, np.arange(V) // 32] >> (np.arange(V) % 32)) & 1
    want = bits[gids.numpy()].astype(bool)
    assert ((got == -np.inf).numpy() == ~want).all()
    assert torch.equal(got[want], logits[want])
    # row 0 reads words[1]: bit 31 of word 0, all of word 1, bit 0 of 2
    assert want[0, 31] and not want[0, :31].any() and want[0, 32:65].all()
    assert not want[0, 65:].any() and not want[2].any()
    bf = td._gmask(logits.to(torch.bfloat16), (table, gids))
    assert bf.dtype == torch.bfloat16 and (bf.isinf() == got.isinf()).all()
    assert td._gmask(logits, None) is logits


def test_banks_match_the_reference(tiny):
    """The adapter bank after an upload and the grammar bank's words
    (read as uint32) equal the reference's; each hook validates the
    reference's way."""
    cfg, jcfg = tiny["torch"]["model"].config, tiny["jax"]["model"].config
    lc = td.LoRAConfig(3, 2)
    init, upload = td.lora_bank_hooks(cfg, lc, torch.float32, "cpu")
    jinit, jupload = jd.lora_bank_hooks(jcfg, jd.LoRAConfig(3, 2),
                                        np.float32)
    bank = upload(init(), 2, tiny["deltas"]["a1"])
    jbank = jupload(jinit(), 2, tiny["deltas"]["a1"])
    for k in td.LORA_KEYS:
        assert np.array_equal(bank[k].numpy(), np.asarray(jbank[k])), k
    assert not bank["q_A"][:, 0].any()
    for bad, msg in ((dict(tiny["deltas"]["a0"], q_A=np.zeros((2, 32, 1))),
                      "shape"),
                     ({k: v for k, v in tiny["deltas"]["a0"].items()
                       if k != "v_B"}, "missing")):
        with pytest.raises(ValueError, match=msg):
            upload(bank, 1, bad)
    assert not bank["q_A"][:, 1].any()         # nothing written

    vocab = T.TokenVocab.ascii_default(VOCAB)
    g = T.compile_schema(tiny["schemas"]["s1"], vocab)
    jg = J.compile_schema(tiny["schemas"]["s1"],
                          J.TokenVocab.ascii_default(VOCAB))
    init, upload = td.grammar_bank_hooks(VOCAB, td.GrammarConfig(3, 64),
                                         "cpu")
    jinit, jupload = jd.grammar_bank_hooks(VOCAB, jd.GrammarConfig(3, 64))
    gbank = upload(init(), 2, g)
    jgbank = np.asarray(jupload(jinit(), 2, jg))
    assert gbank.dtype == torch.int32
    assert np.array_equal(gbank.numpy().view(np.uint32), jgbank)
    assert (gbank[:64] == -1).all()            # all-allow: every bit set
    small = td.grammar_bank_hooks(VOCAB, td.GrammarConfig(3, 4), "cpu")
    with pytest.raises(ValueError, match="states"):
        small[1](small[0](), 1, g)


def _grammar_arg(pkg, tiny, state_rows):
    """A 2-slot grammar bank holding schema s0 in slot 1, and the flat
    ids ``state_rows``."""
    D = DEC[pkg]
    vocab = PKG[pkg].TokenVocab.ascii_default(VOCAB)
    g = PKG[pkg].compile_schema(tiny["schemas"]["s0"], vocab)
    init, upload = D.grammar_bank_hooks(VOCAB, D.GrammarConfig(2, 64),
                                        **({"device": "cpu"}
                                           if pkg == "torch" else {}))
    bank = upload(init(), 1, g)
    return bank, np.asarray(state_rows, np.int32), g


def _lora_arg(pkg, tiny, ids):
    D = DEC[pkg]
    m = tiny[pkg]["model"]
    if pkg == "torch":
        init, upload = D.lora_bank_hooks(m.config, D.LoRAConfig(3, 2),
                                         torch.float32, "cpu")
    else:
        init, upload = D.lora_bank_hooks(m.config, D.LoRAConfig(3, 2),
                                         np.float32)
    bank = init()
    for slot, name in ((1, "a0"), (2, "a2")):
        bank = upload(bank, slot, tiny["deltas"][name])
    return bank, np.asarray(ids, np.int32)


@pytest.mark.parametrize("emit", ["token", "logits"])
def test_paged_programs_with_lora_and_grammar(tiny, emit):
    """``prefill`` / ``decode_step`` / ``decode_n`` with ``lora=`` and
    ``grammar=``: greedy tokens equal to the reference's; with
    ``emit="logits"`` the masked set equal and the rest within
    LOGIT_TOL."""
    rng = np.random.default_rng(2)
    B, T_, ps = 3, 16, 8
    toks = rng.integers(1, VOCAB, (B, T_)).astype(np.int32)
    lens = np.asarray([16, 9, 13], np.int32)
    pt = np.asarray([[1, 2, 0, 0, 0, 0], [3, 4, 0, 0, 0, 0],
                     [5, 6, 0, 0, 0, 0]], np.int32)
    out = {}
    for pkg in ("jax", "torch"):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        fac = DEC[pkg].llama_paged_decode_factory(
            tiny[pkg]["model"], page_size=ps, n_pool_pages=8, emit=emit,
            lora=(3, 2), **kw)
        outer, layers, pools, prefill, step, decode_n = fac
        lora = _lora_arg(pkg, tiny, [1, 0, 2])
        bank, _, g = _grammar_arg(pkg, tiny, [])
        ids = np.asarray([64 + g.start, 0, 64 + g.start], np.int32)
        first, pools = prefill(outer, layers, toks, pt, lens, pools, lora,
                               (bank, ids))
        nxt = np.asarray(first if emit == "token" else
                         np.argmax(np.asarray(first), -1)).astype(np.int32)
        ids2 = np.asarray([64 + g.step(g.start, int(nxt[0])), 0,
                           64 + g.step(g.start, int(nxt[2]))], np.int32)
        second, pools = step(outer, layers, nxt, pt, lens, pools, lora,
                             (bank, ids2))
        emits, last, pools = decode_n(outer, layers, nxt, pt, lens, pools,
                                      3, lora)
        out[pkg] = [np.asarray(first), np.asarray(second),
                    np.asarray(emits), np.asarray(last)]
    for j, t in zip(out["jax"], out["torch"]):
        if emit == "token" or j.ndim == 1:
            assert np.array_equal(j, t)
        else:
            assert np.array_equal(np.isinf(j), np.isinf(t))
            fin = np.isfinite(j)
            np.testing.assert_allclose(t[fin], j[fin], **LOGIT_TOL)
    if emit == "logits":
        first = out["torch"][0]
        assert np.isinf(first[0]).sum() > 0 and np.isinf(first[1]).sum() == 0


def test_prefill_ragged_matches_the_reference(tiny):
    """One ragged call of rows at different chunk offsets: logits within
    LOGIT_TOL and greedy tokens equal, pool pages equal, the idle row
    writing only the reserved page 0; the entry point is offered only
    with the gather prefill."""
    rng = np.random.default_rng(3)
    C = 8
    pt = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    full = rng.integers(1, VOCAB, (3, 24)).astype(np.int32)
    lens = np.asarray([20, 11, C], np.int32)
    out = {}
    for pkg in ("jax", "torch"):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        outer, layers, pools, prefill, _, _ = \
            DEC[pkg].llama_paged_decode_factory(
                tiny[pkg]["model"], page_size=8, n_pool_pages=8,
                chunked_prefill=C, emit="logits", **kw)
        # rows 0 and 1 hold their first chunk(s) already
        _, pools = prefill(outer, layers, full[:2, :16], pt[:2],
                           np.asarray([16, 11], np.int32), pools)
        chunk = np.stack([full[0, 16:24], full[1, 8:16], full[2, :8]])
        starts = np.asarray([16, 8, 0], np.int32)
        logits, pools = prefill._ragged(outer, layers, chunk, starts, pt,
                                        lens, pools)
        out[pkg] = (np.asarray(logits), [np.asarray(p) for p in pools])
    np.testing.assert_allclose(out["torch"][0][:2], out["jax"][0][:2],
                               **LOGIT_TOL)
    assert np.array_equal(out["torch"][0][:2].argmax(-1),
                          out["jax"][0][:2].argmax(-1))
    for j, t in zip(out["jax"][1], out["torch"][1]):
        np.testing.assert_allclose(t[:, :, 1:6], j[:, :, 1:6], **F32_TOL)
    kernel = llama_paged_decode_factory(
        tiny["torch"]["model"], page_size=8, n_pool_pages=8,
        chunked_prefill=8, prefill_attention="kernel", device="cpu")
    assert not hasattr(kernel[3], "_ragged")
    assert not hasattr(_factory(tiny, "torch",
                                dict(BUILD, chunked_prefill=None)),
                       "prefill_ragged")


def test_spec_step_matches_the_reference(tiny):
    """``build_spec_step``'s ``(accepted, cand)`` after a prefill of both
    pools, for live rows at different depths and an idle row, equal to
    the reference's; a perfect draft accepts all k."""
    rng = np.random.default_rng(4)
    k = 3
    pt = np.asarray([[1, 2, 3, 0, 0, 0, 0, 0], [4, 5, 6, 0, 0, 0, 0, 0],
                     [0] * 8], np.int32)
    toks = rng.integers(1, VOCAB, (2, 16)).astype(np.int32)
    lens = np.asarray([13, 7], np.int32)
    got = {}
    for pkg in ("jax", "torch"):
        for draft in ("draft", "twin"):
            srv = _factory(tiny, pkg, SPEC_BUILD, **{draft: True})
            outer, layers, pools = srv.paged_parts[:3]
            d_outer, d_layers, d_pools, d_prefill, step = srv.spec_parts
            first, pools = srv.paged_parts[3](outer, layers, toks, pt[:2],
                                              lens, pools)
            _, d_pools = d_prefill(d_outer, d_layers, toks, pt[:2], lens,
                                   d_pools)
            first = np.append(np.asarray(first), 0).astype(np.int32)
            prev = np.asarray([toks[0, 12], toks[1, 6], 0], np.int32)
            n, cand, _, _ = step(outer, layers, d_outer, d_layers, prev,
                                 first, pt, np.append(lens, 0), pools,
                                 d_pools, k)
            got[pkg, draft] = (np.asarray(n), np.asarray(cand))
    for draft in ("draft", "twin"):
        for j, t in zip(got["jax", draft], got["torch", draft]):
            assert np.array_equal(j, t), draft
            assert t.dtype == np.int32
    assert (got["torch", "twin"][0][:2] == k).all()


def _lora_trace(S, seed=1, n=10):
    return S.synthesize_zipf_adapter_trace(
        seed=seed, n_requests=n, n_adapters=3, base_frac=0.3,
        churn_frac=0.0, prompt_len=(5, 12), output_len=(3, 6),
        vocab_size=VOCAB)


def _spec_trace(S, seed=0, n=8):
    return S.synthesize_trace(seed=seed, n_requests=n, arrival="poisson",
                              mean_interarrival=0.5, prompt_len=(4, 12),
                              output_len=(4, 10), vocab_size=VOCAB,
                              churn_frac=0.2, rid_prefix="q")


def _grammar_trace(S, seed=1, n=6):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = tuple(int(t) for t in rng.integers(1, VOCAB,
                                                    int(rng.integers(4, 9))))
        reqs.append(S.Request(rid=f"R{i:02d}", arrival=float(i),
                              prompt=prompt, max_new_tokens=20,
                              schema=None if i % 3 == 2 else f"s{i % 3}"))
    return reqs


def _ragged_trace(S):
    return S.synthesize_trace(seed=5, n_requests=8, arrival="poisson",
                              mean_interarrival=2.0, prompt_len=(4, 20),
                              output_len=(3, 8), vocab_size=VOCAB,
                              shared_prefix_frac=0.25)


def _engine_case(tiny, pkg, feature, trace=None):
    """(result, trace) of the engine of ``pkg`` with ``feature`` on, on
    the fixed clock."""
    S = PKG[pkg]
    eng = dict(slots=4, policy="paged", clock="fixed")
    if feature == "lora":
        srv = _factory(tiny, pkg, lora=S.LoRAConfig(3, 2))
        eng["adapters"] = S.AdapterStore(tiny["deltas"])
        trace = trace or _lora_trace(S)
    elif feature == "grammar":
        srv = _factory(tiny, pkg, grammar=S.GrammarConfig(3, 64))
        eng["grammar"] = S.GrammarStore(tiny["schemas"])
        trace = trace or _grammar_trace(S)
    elif feature in ("spec", "spec_twin"):
        srv = _factory(tiny, pkg, SPEC_BUILD,
                       **{"twin" if feature == "spec_twin" else "draft":
                          True})
        eng["spec"] = S.SpecConfig(n_draft=3, accept_floor=0.0)
        trace = trace or _spec_trace(S, seed=2 if feature == "spec_twin"
                                     else 0)
    elif feature == "ragged":
        srv = _factory(tiny, pkg)
        eng.update(ragged_prefill=True, prefill_chunk_budget=2,
                   decode_chunk=4, fixed_costs=RAGGED_COSTS)
        trace = trace or _ragged_trace(S)
    else:
        raise ValueError(feature)
    return S.ServingEngine(serving=srv, **eng).run(trace), trace


@pytest.mark.parametrize("feature", ["lora", "grammar", "spec",
                                     "spec_twin", "ragged"])
def test_engine_feature_matches_the_reference(tiny, feature):
    ref, _ = _engine_case(tiny, "jax", feature)
    got, trace = _engine_case(tiny, "torch", feature)
    assert got.outputs == ref.outputs
    assert got.slot_log == ref.slot_log
    assert got.decisions == ref.decisions
    assert json.dumps(got.report()) == json.dumps(ref.report())
    assert got.cache_stats == ref.cache_stats
    assert got.adapter_stats == ref.adapter_stats
    assert got.grammar_stats == ref.grammar_stats
    assert json.dumps(got.spec_stats) == json.dumps(ref.spec_stats)
    assert got.pages_free_end == got.pages_total
    assert len(got.outputs) == len(trace)
    if feature == "lora":
        assert got.adapter_stats["invariant_ok"]
    if feature == "grammar":
        assert got.grammar_stats["invariant_ok"]
        vocab = T.TokenVocab.ascii_default(VOCAB)
        for r in trace:
            if r.schema is not None:
                assert T.schema_accepts(tiny["schemas"][r.schema],
                                        vocab.decode(got.outputs[r.rid]))
                assert len(got.outputs[r.rid]) < r.max_new_tokens
    if feature.startswith("spec"):
        assert got.spec_stats["rounds"] > 0
    if feature == "spec_twin":
        assert got.spec_stats["acceptance_rate"] >= 0.99


@pytest.mark.parametrize("feature", ["lora", "grammar", "spec",
                                     "spec_twin", "ragged"])
def test_engine_feature_equals_the_plain_engine(tiny, feature):
    """Adapter-free rows through the identity slot, grammar-free rows
    through the all-allow row, speculative rows and the fused lane all
    give the plain factory's streams."""
    S = T
    if feature == "lora":
        trace = [dataclasses.replace(r, adapter=None)
                 for r in _lora_trace(S, seed=3, n=8)]
    elif feature == "grammar":
        trace = [dataclasses.replace(r, schema=None)
                 for r in _grammar_trace(S, seed=3)]
    elif feature == "ragged":
        trace = _ragged_trace(S)
    else:
        trace = _spec_trace(S, seed=2 if feature == "spec_twin" else 0)
    got, _ = _engine_case(tiny, "torch", feature, trace)
    kw = dict(decode_chunk=4, fixed_costs=RAGGED_COSTS) \
        if feature == "ragged" else {}
    plain = T.ServingEngine(
        serving=_factory(tiny, "torch", SPEC_BUILD if "spec" in feature
                         else BUILD),
        slots=4, policy="paged", clock="fixed", **kw).run(trace)
    assert got.outputs == plain.outputs
    if feature in ("lora", "grammar"):
        assert got.slot_log == plain.slot_log
        assert got.decisions == plain.decisions
        assert got.metrics.request_rows() == plain.metrics.request_rows()


def test_adapters_change_the_streams(tiny):
    """A delta that changed nothing would make the parity vacuous: some
    adapter streams differ from the base model's."""
    got, trace = _engine_case(tiny, "torch", "lora")
    base = T.ServingEngine(serving=_factory(tiny, "torch"), slots=4,
                           policy="paged", clock="fixed").run(
        [dataclasses.replace(r, adapter=None) for r in trace])
    assert any(got.outputs[r.rid] != base.outputs[r.rid]
               for r in trace if r.adapter is not None)


# --- the reference's composition errors, word for word -----------------------

def _raises_like_the_reference(tiny, build, match):
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match=match):
            build(pkg)


def test_draft_with_lora_is_refused(tiny):
    _raises_like_the_reference(
        tiny, lambda pkg: _factory(tiny, pkg, SPEC_BUILD, draft=True,
                                   lora=(3, 2)),
        r"speculative serving does not compose with lora= yet — the draft "
        r"has no adapter bank")


def test_draft_vocabulary_mismatch_is_refused(tiny):
    def build(pkg):
        other = _pair(2, vocab=53, hidden=16, layers=1, heads=2,
                      kv_heads=1)[0 if pkg == "jax" else 1]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        return DEC[pkg].llama_serving_decode_factory(
            tiny[pkg]["model"], draft=other, **SPEC_BUILD, **kw)
    _raises_like_the_reference(tiny, build,
                               "target and draft must share a vocabulary")


def test_pressure_with_draft_is_refused(tiny):
    _raises_like_the_reference(
        tiny, lambda pkg: _factory(tiny, pkg, SPEC_BUILD, draft=True,
                                   kv_quant="pressure"),
        r"kv_quant='pressure' does not compose with draft= yet")


def test_spec_with_adapters_is_refused(tiny):
    def build(pkg):
        S = PKG[pkg]
        return S.ServingEngine(
            serving=S.make_sim_serving(lora_slots=3, spec_accept=0.8),
            slots=4, policy="paged", spec=S.SpecConfig(n_draft=2),
            adapters=_sim_adapters(S, 2))
    _raises_like_the_reference(
        tiny, build, r"spec= does not compose with adapters= yet — the "
                     r"draft has no adapter bank")


def test_prebuilt_factory_conflicts_are_refused(tiny):
    """A prebuilt factory's lora / grammar layout is fixed at its build."""
    for pkg in ("jax", "torch"):
        S = PKG[pkg]
        srv = _factory(tiny, pkg, lora=S.LoRAConfig(3, 2))
        with pytest.raises(ValueError, match="conflicts"):
            S.ServingEngine(serving=srv, slots=4, policy="paged",
                            lora=S.LoRAConfig(5, 2),
                            adapters=S.AdapterStore(tiny["deltas"]))
        srv = _factory(tiny, pkg, grammar=S.GrammarConfig(3, 64))
        with pytest.raises(ValueError, match="conflicts"):
            S.ServingEngine(serving=srv, slots=4, policy="paged",
                            grammar_config=S.GrammarConfig(5, 64),
                            grammar=S.GrammarStore(tiny["schemas"]))
