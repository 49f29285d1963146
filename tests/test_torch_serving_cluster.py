"""The multi-replica serving layer in the port (``paddle_tpu_torch.serving``:
``ClusterRouter``, its placements, drain and join, disaggregated
prefill/decode with the page and int8 handoff transforms, the autoscaler)
against the JAX package's, on the CPU.

* Seeded ``SimServing`` fleets on the fixed clock give byte-identical
  results in both packages: ``outputs()``, ``census()``, ``report()``, the
  replicas' slot logs, the router's ledger and event log, the saved cost
  and action logs and the chrome trace (less its ``wall_s`` arguments,
  host wall time), for every placement, for drain and join, for an
  autoscaled flash crowd and for the heterogeneous fleets whose handoffs
  are re-paged and transcoded to int8 or to the pressure tier, and for
  fleets of pressure replicas (a twin adopts the chain with its tier
  bits; another page geometry cannot). A ``tp`` fleet is refused by name
  in the port (ROADMAP item 11).
* The reference tests' tiny f32 Llama, carried across with
  ``load_numpy_state_dict``, serves through both packages' serving
  factories: the port's clusters equal its lone engine and the reference
  cluster's streams.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.obs as JO
import paddle_tpu.serving as J
import paddle_tpu_torch.obs as TO
import paddle_tpu_torch.serving as T
from paddle_tpu.models.nlp import LlamaConfig as JaxConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.nlp.llama_decode import (
    llama_serving_decode_factory as jax_serving_factory)
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_serving_decode_factory,
                                         load_numpy_state_dict)

PKG = {"jax": (J, JO), "torch": (T, TO)}
COSTS = {"prefill_unit": 1.0, "decode": 1.0}
HETERO_COSTS = {"prefill_unit": 1.0, "decode": 1.0, "kv_reshard_unit": 0.3,
                "kv_repage_unit": 0.2, "kv_transcode_unit": 0.1}


def _strip_wall(chrome):
    for e in chrome["traceEvents"]:
        e.get("args", {}).pop("wall_s", None)
    return json.dumps(chrome)


def fingerprint(res, tracer, tmp_path):
    """Everything a cluster replay records, as bytes or plain values."""
    out = {"outputs": res.outputs(), "census": json.dumps(res.census()),
           "report": json.dumps(res.report()),
           "slot_logs": {n: r.slot_log for n, r in res.results.items()},
           "ledger": json.dumps(res.ledger),
           "events": json.dumps(res.events), "failed": res.failed,
           "salvaged": res.salvaged, "handoffs": res.handoffs,
           "hours": json.dumps(res.replica_hours),
           "chrome": _strip_wall(tracer.to_chrome())}
    for name, save, armed in (("costs", res.save_costs, res.cost_ledger),
                              ("actions", res.save_actions, res.autoscale),
                              ("incidents", res.save_incidents,
                               res.slo_log)):
        if armed is not None:
            path = tmp_path / f"{name}.jsonl"
            save(str(path))
            out[name] = path.read_bytes()
    return out


def both(run, tmp_path):
    """``run(S, O, tracer)`` in each package; their fingerprints."""
    got = {}
    for pkg, (S, O) in PKG.items():
        tracer = O.Tracer()
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = fingerprint(run(S, O, tracer), tracer, d)
    return got["jax"], got["torch"]


def assert_identical(ref, got):
    assert ref.keys() == got.keys()
    for key in ref:
        assert ref[key] == got[key], key


def _sim_engine(S, slots=4, page_size=8, max_len=64, extra=8, costs=COSTS,
                kv_quant=None, tp=None, **kw):
    return S.ServingEngine(
        serving=S.make_sim_serving(
            max_len=max_len, page_size=page_size, slots=slots, vocab=211,
            kv_quant=kv_quant, tp=tp,
            n_pool_pages=slots * (max_len // page_size) + 1 + extra,
            chunked_prefill=max(8, page_size)),
        slots=slots, policy="paged", clock="fixed", fixed_costs=costs, **kw)


# --- placements, drain and join ----------------------------------------------

@pytest.mark.parametrize("placement", ["round_robin", "least_loaded",
                                       "prefix_aware"])
def test_sim_placement_is_byte_identical(placement, tmp_path):
    """200 requests of the cluster trace over 3 QoS replicas, with the
    cost ledger armed."""
    def run(S, O, tracer):
        trace = S.synthesize_cluster_trace(seed=0, n_requests=200,
                                           vocab_size=211)

        def spawn(name):
            return _sim_engine(S, max_len=256,
                               scheduler=S.QoSScheduler(max_queue=16))
        return S.ClusterRouter(spawn, 3, placement=placement, trace=tracer,
                               cost_ledger=True).run(trace)
    ref, got = both(run, tmp_path)
    assert_identical(ref, got)
    assert len(got["outputs"]) > 100 and "costs" in got


def test_sim_drain_and_join_are_byte_identical(tmp_path):
    """A replica joins and another drains mid-trace under overload: the
    drained backlog is requeued and counted once, the removal census
    balances with zero resident pages."""
    def run(S, O, tracer):
        trace = S.synthesize_trace(seed=3, n_requests=40, arrival="poisson",
                                   mean_interarrival=0.3,
                                   prompt_len=(4, 20), output_len=(3, 10),
                                   vocab_size=211, shared_prefix_frac=0.4,
                                   prefix_len=8, rid_prefix="m")

        def spawn(name):
            return _sim_engine(S, scheduler=S.QoSScheduler(max_queue=6))
        return S.ClusterRouter(spawn, 2, placement="prefix_aware",
                               trace=tracer).run(
            trace, events=[(4.0, "join", "rj"), (4.0, "drain", "r0")])
    ref, got = both(run, tmp_path)
    assert_identical(ref, got)
    census = json.loads(got["census"])
    events = json.loads(got["events"])
    assert census["conserved"] and census["requeued"] > 0
    removed = [e for e in events if e["event"] == "remove"]
    assert removed[0]["replica"] == "r0" \
        and removed[0]["resident_pages"] == 0


def test_make_placement_matches_the_reference():
    for name in ("round_robin", "least_loaded", "prefix_aware",
                 "disaggregated"):
        assert type(T.make_placement(name)).__name__ \
            == type(J.make_placement(name)).__name__
    for S in (J, T):
        with pytest.raises(ValueError):
            S.make_placement("random")


# --- disaggregated prefill/decode and the heterogeneous handoffs -------------

def test_sim_disaggregated_is_byte_identical(tmp_path):
    """2 prefill + 2 decode replicas on the prefill-heavy trace: every KV
    chain exported once and imported once."""
    roles = {"r0": "prefill", "r1": "prefill", "r2": "decode",
             "r3": "decode"}

    def run(S, O, tracer):
        trace = S.synthesize_prefill_heavy_trace(seed=0, n_short=32,
                                                 n_long=12, vocab_size=211)

        def spawn(name):
            return _sim_engine(S, slots=8, max_len=96, extra=16,
                               decode_chunk=4, prefill_chunk_budget=2)
        return S.ClusterRouter(spawn, 4, placement="disaggregated",
                               roles=roles, kv_transfer_unit=0.05,
                               trace=tracer, cost_ledger=True).run(trace)
    ref, got = both(run, tmp_path)
    assert_identical(ref, got)
    ho = json.loads(got["census"])["handoffs"]
    assert ho["balanced"] and ho["exported"] == ho["imported"] == 44


HETERO = {"page": (16, None, None), "codec": (8, "int8", None),
          "page+codec": (16, "int8", None), "tp": (8, None, 2),
          "tp+page+codec": (16, "int8", 2),
          "pressure": (8, "pressure", None),
          "page+pressure": (16, "pressure", None)}
# the census names a transcode to either codec "codec"
AXIS = {"pressure": "codec"}


def _hetero_fleet(S, tracer, page, quant, tp):
    trace = [S.Request(rid=f"h{i}", arrival=float(i),
                       prompt=tuple(range(1, 11 + i)), max_new_tokens=4)
             for i in range(4)]

    def spawn(name):
        if name == "r0":
            return _sim_engine(S, slots=8, max_len=96, extra=16,
                               costs=HETERO_COSTS, decode_chunk=4)
        return _sim_engine(S, slots=8, max_len=96, extra=16,
                           costs=HETERO_COSTS, decode_chunk=4,
                           page_size=page, kv_quant=quant, tp=tp)
    return S.ClusterRouter(spawn, 2, placement="disaggregated",
                           roles={"r0": "prefill", "r1": "decode"},
                           kv_transfer_unit=0.05, trace=tracer,
                           cost_ledger=True).run(trace)


@pytest.mark.parametrize("axes", sorted(HETERO))
def test_sim_hetero_fleet(axes, tmp_path):
    """The hetero grid of the reference: a page or codec mismatch adopts
    with the reference's ``resharded`` census, byte for byte; a ``tp``
    decode replica is refused by name."""
    page, quant, tp = HETERO[axes]
    if tp is not None:
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 11"):
            _hetero_fleet(T, TO.Tracer(), page, quant, tp)
        return
    ref, got = both(lambda S, O, tracer: _hetero_fleet(S, tracer, page,
                                                       quant, tp), tmp_path)
    assert_identical(ref, got)
    ho = json.loads(got["census"])["handoffs"]
    assert ho["resharded"] == {AXIS.get(a, a): 4 for a in axes.split("+")}
    assert ho["imported"] == 4 and ho["failed"] == 0


@pytest.mark.parametrize("decode_page", [8, 16])
def test_sim_pressure_fleet(decode_page, tmp_path):
    """A pressure prefill replica hands its chains (tier bits with them)
    to a pressure decode replica: a twin adopts every one; across page
    geometries none can be re-paged, and each fails as untransformable,
    as in the reference."""
    def run(S, O, tracer):
        trace = [S.Request(rid=f"q{i}", arrival=float(i),
                           prompt=tuple(range(1, 11 + i)), max_new_tokens=4)
                 for i in range(4)]

        def spawn(name):
            return _sim_engine(S, slots=8, max_len=96, extra=16,
                               costs=HETERO_COSTS, decode_chunk=4,
                               kv_quant="pressure",
                               page_size=8 if name == "r0" else decode_page)
        return S.ClusterRouter(spawn, 2, placement="disaggregated",
                               roles={"r0": "prefill", "r1": "decode"},
                               kv_transfer_unit=0.05, trace=tracer,
                               cost_ledger=True).run(trace)
    ref, got = both(run, tmp_path)
    assert_identical(ref, got)
    ho = json.loads(got["census"])["handoffs"]
    if decode_page == 8:
        assert ho["imported"] == 4 and ho["failed"] == 0
        assert "resharded" not in ho
    else:
        assert ho["failed"] == 4
        assert all("untransformable" in m for m in got["failed"].values())


# --- the autoscaler ------------------------------------------------------------

SLOTS, PS, ML, CHUNK = 8, 8, 64, 4
CAP6 = 6 * 8.0 / (1.5 + 8.0 / (SLOTS * CHUNK))
RULES = dict(long_window=200.0, short_window=40.0, min_events=60,
             burn_threshold=2.5)


def test_autoscaled_flash_crowd_is_byte_identical(tmp_path):
    """The reference test's flash crowd (2000 requests) over 4 QoS
    replicas with 3 standbys: the same joins, degrades and action log,
    no oscillation."""
    def run(S, O, tracer):
        def spawn(name):
            return S.ServingEngine(
                serving=S.make_sim_serving(max_len=ML, page_size=PS,
                                           slots=SLOTS, vocab=509,
                                           n_pool_pages=SLOTS * (ML // PS)
                                           + 9),
                slots=SLOTS, policy="paged", clock="fixed",
                fixed_costs=COSTS, decode_chunk=CHUNK,
                scheduler=S.QoSScheduler(
                    max_queue=4 * SLOTS,
                    tenant_weights={"intl": 2.0, "std": 1.0, "bulk": 0.5},
                    incident_degrade=0.75))
        trace = S.synthesize_flash_crowd_trace(
            seed=0, n_requests=2000, service_tokens_per_unit=CAP6,
            base_overload=0.55, spikes=((0.55, 0.08, 4.0),))
        asc = S.Autoscaler(S.AutoscaleConfig(
            standby=("s0", "s1", "s2"), min_replicas=4, max_replicas=7,
            interval=10.0, join_cooldown=30.0, drain_cooldown=120.0,
            hold_after_join=150.0, hold_after_drain=40.0,
            drain_sustain=120.0, drain_below=0.5, recover_sustain=120.0))
        return S.ClusterRouter(spawn, 4, placement="least_loaded",
                               slo=O.default_serving_rules(**RULES),
                               autoscale=asc, trace=tracer).run(trace)
    ref, got = both(run, tmp_path)
    assert_identical(ref, got)
    actions = [json.loads(line) for line in
               got["actions"].decode().splitlines()]
    report = json.loads(got["report"])
    assert report["autoscale"]["joins"] >= 1 \
        and report["autoscale"]["degrades"] >= 1
    for hold in (150.0, 30.0):
        assert T.count_oscillations(actions, hold) \
            == J.count_oscillations(actions, hold)
    assert T.count_oscillations(actions, 150.0) == 0


def test_count_oscillations_and_config_checks():
    acts = [{"t": 10.0, "action": "join"}, {"t": 50.0, "action": "drain"},
            {"t": 400.0, "action": "drain"}]
    for hold in (150.0, 30.0):
        assert T.count_oscillations(acts, hold) \
            == J.count_oscillations(acts, hold)
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(interval=0.0)):
        for S in (J, T):
            with pytest.raises(ValueError):
                S.AutoscaleConfig(**bad)


# --- the tiny f32 Llama ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The reference tests' model (vocab 97, hidden 32, 2 layers, 4 / 2
    heads) and the port's on the same weights; ``factory(pkg, **kw)``
    builds a serving factory (max_len 48, pages of 8, capacity 4, chunks
    of a page) of either."""
    paddle.seed(0)
    jmodel = JaxLlama(JaxConfig.tiny(vocab=97, hidden=32, layers=2, heads=4,
                                     kv_heads=2))
    jmodel.eval()
    state = {k: np.asarray(v._value) for k, v in
             jmodel.state_dict().items()}
    model = load_numpy_state_dict(LlamaForCausalLM(LlamaConfig.tiny(
        vocab=97, hidden=32, layers=2, heads=4, kv_heads=2), device="cpu"),
        state)

    def factory(pkg, page_size=8, n_pool_pages=25, kv_quant=None):
        build = dict(max_len=48, page_size=page_size,
                     n_pool_pages=n_pool_pages, batch_capacity=4,
                     chunked_prefill=page_size, kv_quant=kv_quant)
        if pkg == "jax":
            return jax_serving_factory(jmodel, **build)
        return llama_serving_decode_factory(model, device="cpu", **build)
    return factory


def _real_engine(S, srv, slots, **kw):
    return S.ServingEngine(serving=srv, slots=slots, policy="paged",
                           clock="fixed", fixed_costs=COSTS, **kw)


def test_cluster_matches_lone_engine_on_real_model(tiny):
    """2 replicas under least_loaded (each its own factory) against a
    lone engine: the port's streams equal its lone engine's and the
    reference cluster's; census and slot logs equal the reference's."""
    res = {}
    for pkg, (S, _) in PKG.items():
        trace = S.synthesize_trace(seed=5, n_requests=6, arrival="poisson",
                                   mean_interarrival=1.0, prompt_len=(4, 10),
                                   output_len=(2, 4), vocab_size=97,
                                   rid_prefix="rm")
        res[pkg] = S.ClusterRouter(
            lambda name: _real_engine(S, tiny(pkg, n_pool_pages=13), 2),
            2, placement="least_loaded").run(trace)
    lone = _real_engine(T, tiny("torch", n_pool_pages=13), 2).run(trace)
    assert res["torch"].outputs() == lone.outputs
    assert res["torch"].outputs() == res["jax"].outputs()
    assert res["torch"].census() == res["jax"].census()
    assert res["torch"].census()["conserved"]
    assert {n: r.slot_log for n, r in res["torch"].results.items()} \
        == {n: r.slot_log for n, r in res["jax"].results.items()}


@pytest.mark.parametrize("decode", ["twin", "int8_ps16"])
def test_disagg_cluster_real_model(tiny, decode):
    """1 prefill + 1 decode replica: the real factory's pages move through
    export and import. Over a twin decode replica the port's streams equal
    its lone engine's; over an int8 decode replica of 16-token pages every
    handoff is re-paged and transcoded, and the port's streams and census
    equal the reference cluster's."""
    build = {} if decode == "twin" else dict(page_size=16, kv_quant="int8")
    res = {}
    for pkg, (S, _) in PKG.items():
        trace = S.synthesize_trace(seed=4, n_requests=6, arrival="poisson",
                                   mean_interarrival=4.0, prompt_len=(5, 18),
                                   output_len=(3, 5), vocab_size=97,
                                   rid_prefix="rc")
        facs = {"r0": tiny(pkg), "r1": tiny(pkg, **build)}
        res[pkg] = S.ClusterRouter(
            lambda name: _real_engine(S, facs[name], 4, decode_chunk=2,
                                      prefill_chunk_budget=2),
            2, placement="disaggregated",
            roles={"r0": "prefill", "r1": "decode"},
            kv_transfer_unit=0.1).run(trace)
    cen = res["torch"].census()
    assert cen["conserved"] and cen["handoffs"]["balanced"]
    assert cen["handoffs"]["exported"] == len(trace)
    assert cen == res["jax"].census()
    assert res["torch"].outputs() == res["jax"].outputs()
    if decode == "twin":
        lone = _real_engine(T, tiny("torch"), 4, decode_chunk=2).run(trace)
        assert res["torch"].outputs() == lone.outputs
    else:
        assert cen["handoffs"]["resharded"] == {"page": len(trace),
                                                "codec": len(trace)}
