"""Fault injection and failover in the port's cluster router
(``paddle_tpu_torch.serving``: ``FaultEvent``, ``FaultPlan``,
``synthesize_fault_plan``, ``FailoverConfig``, the heartbeat detector,
retries with resume-from-prefix, the SLO monitor and flight recorder of a
cluster) against the JAX package's, on the CPU.

* ``synthesize_fault_plan`` draws the same events from the same seeds, and
  a plan saves to the same bytes.
* Seeded ``SimServing`` fleets under fault plans give byte-identical
  results in both packages (outputs with their salvaged prefixes,
  ``census()``, ``report()``, slot logs, ledger, event log, the saved
  incident and cost logs, the chrome trace less ``wall_s``), and the
  flight recorder's bundles hold the same incidents.
* On the reference tests' tiny f32 Llama, carried across with
  ``load_numpy_state_dict``: a resumed prefix continues the greedy stream
  exactly, and a crashed replica's work fails over with the streams of an
  undisturbed cluster, equal to the reference's.
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


def _strip_wall(chrome):
    for e in chrome["traceEvents"]:
        e.get("args", {}).pop("wall_s", None)
    return json.dumps(chrome)


def fingerprint(res, tracer, tmp_path):
    out = {"outputs": res.outputs(), "census": json.dumps(res.census()),
           "report": json.dumps(res.report()),
           "slot_logs": {n: r.slot_log for n, r in res.results.items()},
           "ledger": json.dumps(res.ledger),
           "events": json.dumps(res.events), "failed": res.failed,
           "salvaged": res.salvaged,
           "chrome": _strip_wall(tracer.to_chrome())}
    for name, save, armed in (("costs", res.save_costs, res.cost_ledger),
                              ("incidents", res.save_incidents,
                               res.slo_log)):
        if armed is not None:
            path = tmp_path / f"{name}.jsonl"
            save(str(path))
            out[name] = path.read_bytes()
    return out


# --- fault plans ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 4])
def test_synthesize_fault_plan_matches_the_reference(seed, tmp_path):
    kw = dict(replicas=["r0", "r1", "r2", "r3"], span=100.0, n_stalls=2,
              n_decode_errors=3)
    ref = J.synthesize_fault_plan(seed=seed, **kw)
    got = T.synthesize_fault_plan(seed=seed, **kw)
    assert [e.to_json() for e in got] == [e.to_json() for e in ref]
    assert len(got.crashes()) == 1
    ref.save(str(tmp_path / "ref.jsonl"))
    got.save(str(tmp_path / "got.jsonl"))
    assert (tmp_path / "got.jsonl").read_bytes() \
        == (tmp_path / "ref.jsonl").read_bytes()
    assert [e.to_json() for e in T.FaultPlan.load(
        str(tmp_path / "ref.jsonl"))] == [e.to_json() for e in got]


def test_fault_checks_match_the_reference():
    for S in (J, T):
        with pytest.raises(ValueError, match="kind"):
            S.FaultEvent(t=1.0, kind="explode", replica="r0")
        with pytest.raises(ValueError, match="dead replica"):
            S.FaultPlan([S.FaultEvent(t=1.0, kind="crash", replica="r0"),
                         S.FaultEvent(t=2.0, kind="stall", replica="r0",
                                      duration=1.0)])
        with pytest.raises(ValueError, match="survive"):
            S.synthesize_fault_plan(seed=0, replicas=["r0"], span=10.0)
        with pytest.raises(ValueError):
            S.FailoverConfig(retry_budget=-1)
    assert T.FailoverConfig() == T.FailoverConfig(
        **{k: getattr(J.FailoverConfig(), k) for k in (
            "heartbeat_interval", "heartbeat_timeout", "retry_budget",
            "backoff_base", "backoff_mult")})


# --- chaos on sim fleets -------------------------------------------------------

def _sim_engine(S, slots=4, qos=None):
    return S.ServingEngine(
        serving=S.make_sim_serving(max_len=64, page_size=8, slots=slots,
                                   vocab=211,
                                   n_pool_pages=slots * 8 + 9),
        slots=slots, policy="paged", clock="fixed", fixed_costs=COSTS,
        scheduler=S.QoSScheduler(max_queue=qos) if qos else None)


def _trace(S, n=40, gap=0.35):
    rng = np.random.default_rng(3)
    return [S.Request(rid=f"m{i}", arrival=i * gap,
                      prompt=tuple(int(t) for t in rng.integers(1, 211, 10)),
                      max_new_tokens=8) for i in range(n)]


def _plan2(S):
    return S.FaultPlan([
        S.FaultEvent(t=4.0, kind="stall", replica="r1", duration=2.5),
        S.FaultEvent(t=6.0, kind="crash", replica="r0"),
        S.FaultEvent(t=8.0, kind="decode_error", replica="r1")])


def _chaos_cluster_trace(S, O, tracer):
    """The reference's chaos replay: 400 cluster-trace requests, a seeded
    crash + stall + decode-error plan, prefix_aware over QoS replicas."""
    trace = S.synthesize_cluster_trace(seed=9, n_requests=400,
                                       service_tokens_per_unit=8.0,
                                       vocab_size=211)
    span = trace[-1].arrival - trace[0].arrival
    plan = S.synthesize_fault_plan(seed=1, replicas=["r0", "r1"], span=span,
                                   n_stalls=1, n_decode_errors=1)
    return S.ClusterRouter(
        lambda name: _sim_engine(S, qos=16), 2, placement="prefix_aware",
        faults=plan, failover=S.FailoverConfig(
            heartbeat_interval=1.0, heartbeat_timeout=3.0, backoff_base=0.5),
        slo=[], cost_ledger=True, trace=tracer).run(trace)


def _crash_stall_error(S, O, tracer):
    return S.ClusterRouter(
        lambda name: _sim_engine(S, qos=16), 2, placement="round_robin",
        faults=_plan2(S), failover=S.FailoverConfig(), slo=[],
        trace=tracer).run(_trace(S))


def _retry_exhausted(S, O, tracer):
    plan = S.FaultPlan([S.FaultEvent(t=6.0, kind="crash", replica="r0")])
    return S.ClusterRouter(
        lambda name: _sim_engine(S), 2, placement="least_loaded",
        faults=plan, failover=S.FailoverConfig(
            heartbeat_interval=1.0, heartbeat_timeout=3.0, retry_budget=0),
        slo=[], trace=tracer).run(_trace(S))


def _drain_join_under_faults(S, O, tracer):
    plan = S.FaultPlan([S.FaultEvent(t=9.0, kind="stall", replica="rj",
                                     duration=1.0),
                        S.FaultEvent(t=10.0, kind="crash", replica="r1")])
    return S.ClusterRouter(
        lambda name: _sim_engine(S, qos=16), 2, placement="least_loaded",
        faults=plan,
        slo=[O.ThresholdRule(name="deep", signal="queue_depth", bound=0.0)],
        trace=tracer).run(
            _trace(S), events=[(5.0, "join", "rj"), (6.0, "drain", "r0")])


CHAOS = {"cluster_trace": _chaos_cluster_trace,
         "crash_stall_error": _crash_stall_error,
         "retry_exhausted": _retry_exhausted,
         "drain_join_under_faults": _drain_join_under_faults}


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_sim_chaos_is_byte_identical(case, tmp_path):
    got = {}
    for pkg, (S, O) in PKG.items():
        tracer = O.Tracer()
        (tmp_path / pkg).mkdir()
        got[pkg] = fingerprint(CHAOS[case](S, O, tracer), tracer,
                               tmp_path / pkg)
    assert got["jax"].keys() == got["torch"].keys()
    for key in got["jax"]:
        assert got["jax"][key] == got["torch"][key], key
    census = json.loads(got["torch"]["census"])
    assert census["conserved"] and not census["lost"] \
        and not census["duplicated"]
    assert census["retried"] >= 1
    if case == "retry_exhausted":
        assert census["failed"] > 0
    assert got["torch"]["incidents"]


def test_crash_failover_keeps_the_fault_free_streams():
    """A crash at t=4 on r0: every stream, its salvaged prefix stitched
    in, equals the fault-free replay's, as in the reference."""
    trace = _trace(T, n=24, gap=0.7)

    def run(faults=None):
        return T.ClusterRouter(
            lambda name: _sim_engine(T), 2, placement="round_robin",
            faults=faults, failover=T.FailoverConfig(
                heartbeat_interval=1.0, heartbeat_timeout=3.0,
                backoff_base=0.5) if faults else None).run(trace)
    res = run(T.FaultPlan([T.FaultEvent(t=4.0, kind="crash",
                                        replica="r0")]))
    assert res.salvaged and res.outputs() == run().outputs()
    ev = {e["event"]: e for e in res.events}
    assert ev["remove"]["census_ok"] and ev["remove"]["resident_pages"] == 0


def test_cluster_flight_bundles_match_the_reference(tmp_path):
    """A crash under ``slo=[]`` and ``flight=<dir>``: one bundle an
    incident, and the same incidents in both packages."""
    bundles = {}
    for pkg, (S, O) in PKG.items():
        d = tmp_path / pkg
        plan = S.FaultPlan([S.FaultEvent(t=6.0, kind="crash",
                                         replica="r0")])
        res = S.ClusterRouter(
            lambda name: _sim_engine(S, qos=16), 2, placement="round_robin",
            faults=plan, failover=S.FailoverConfig(
                heartbeat_interval=1.0, heartbeat_timeout=3.0,
                backoff_base=0.5),
            slo=[], flight=str(d)).run(_trace(S))
        written = res.flight.bundles_written
        assert len(written) == len(res.incidents) >= 2
        bundles[pkg] = ([i.to_json() for i in res.incidents],
                        sorted(p.rsplit("/", 1)[-1] for p in written))
    assert bundles["torch"] == bundles["jax"]


# --- the tiny f32 Llama ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """``factory(pkg)``: a serving factory of the reference tests' model
    (vocab 97, hidden 32, 2 layers, 4 / 2 heads; max_len 48, pages of 8,
    13 pool pages, capacity 2, chunks of 8), in either package on the same
    weights."""
    paddle.seed(0)
    jmodel = JaxLlama(JaxConfig.tiny(vocab=97, hidden=32, layers=2, heads=4,
                                     kv_heads=2))
    jmodel.eval()
    state = {k: np.asarray(v._value) for k, v in
             jmodel.state_dict().items()}
    model = load_numpy_state_dict(LlamaForCausalLM(LlamaConfig.tiny(
        vocab=97, hidden=32, layers=2, heads=4, kv_heads=2), device="cpu"),
        state)
    build = dict(max_len=48, page_size=8, n_pool_pages=13, batch_capacity=2,
                 chunked_prefill=8)

    def factory(pkg):
        if pkg == "jax":
            return jax_serving_factory(jmodel, **build)
        return llama_serving_decode_factory(model, device="cpu", **build)
    return factory


def _real_engine(S, srv, policy="paged"):
    return S.ServingEngine(serving=srv, slots=2, policy=policy,
                           clock="fixed", fixed_costs=COSTS)


def test_real_model_resume_from_prefix_parity(tiny):
    """Prefilling prompt + the first e emitted tokens continues the greedy
    stream where decode left it, in the port, on the reference's
    tokens."""
    prompt = tuple(range(3, 13))
    full = {}
    for pkg, (S, _) in PKG.items():
        full[pkg] = _real_engine(S, tiny(pkg)).run([S.Request(
            rid="f", arrival=0.0, prompt=prompt,
            max_new_tokens=8)]).outputs["f"]
    assert full["torch"] == full["jax"]
    for e in (2, 5):
        resumed = _real_engine(T, tiny("torch")).run([T.Request(
            rid="r", arrival=0.0, prompt=prompt + tuple(full["torch"][:e]),
            max_new_tokens=8 - e)]).outputs["r"]
        assert resumed == full["torch"][e:], e


def test_real_model_crash_failover(tiny):
    """A crash of r0 under round_robin on the routed real engine: the
    queued and in-flight work fails over, a cancelled request counts once,
    and the streams equal an undisturbed cluster's and the reference's."""
    got = {}
    for pkg, (S, _) in PKG.items():
        trace = [S.Request(rid="k0", arrival=0.0,
                           prompt=tuple(range(3, 11)), max_new_tokens=6),
                 S.Request(rid="k1", arrival=0.2,
                           prompt=tuple(range(5, 13)), max_new_tokens=6,
                           cancel_after=2),
                 S.Request(rid="k2", arrival=0.4,
                           prompt=tuple(range(7, 15)), max_new_tokens=4),
                 S.Request(rid="k3", arrival=3.0,
                           prompt=tuple(range(9, 20)), max_new_tokens=5)]

        def spawn(name):
            return _real_engine(S, tiny(pkg), policy="routed")
        plan = S.FaultPlan([S.FaultEvent(t=0.1, kind="crash",
                                         replica="r0")])
        res = S.ClusterRouter(spawn, 2, placement="round_robin", faults=plan,
                              failover=S.FailoverConfig(
                                  heartbeat_interval=1.0,
                                  heartbeat_timeout=2.0)).run(trace)
        free = S.ClusterRouter(spawn, 2, placement="round_robin").run(trace)
        got[pkg] = (res.outputs(), res.census(), free.outputs(), res.events)
    outs, cen, free, events = got["torch"]
    assert cen["conserved"] and not cen["lost"] and not cen["duplicated"]
    assert len(outs["k1"]) == 2 and outs == free
    assert any(e["event"] == "dead" for e in events)
    assert got["torch"] == got["jax"]
