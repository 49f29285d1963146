"""The host half of the serving stack in the port (``paddle_tpu_torch.
serving`` and ``paddle_tpu_torch.obs``) against the JAX package's, which
the port carries over as copies: every trace generator, the metrics
collector, the QoS scheduler, the observability spine, the router, and
the host surfaces of the grammar, host-memory and adapter layers give the
same results, field for field and byte for byte, on the same inputs."""
import dataclasses
import json

import pytest

import paddle_tpu.models.nlp.llama_decode as jax_decode
import paddle_tpu.obs as jax_obs
import paddle_tpu.serving as jax_serving
import paddle_tpu_torch.models.nlp.llama_decode as torch_decode
import paddle_tpu_torch.obs as torch_obs
import paddle_tpu_torch.serving as torch_serving

SERVING = {"jax": jax_serving, "torch": torch_serving}
OBS = {"jax": jax_obs, "torch": torch_obs}

# every trace generator of serving/workload.py, at sizes a test can hold
GENERATORS = {
    "synthesize_trace": dict(n_requests=40, arrival="poisson",
                             shared_prefix_frac=0.4, churn_frac=0.3),
    "synthesize_trace/bursty": dict(n_requests=24, arrival="bursty",
                                    burst_size=6),
    "synthesize_overload_trace": dict(n_requests=48),
    "synthesize_recurring_prefix_trace": dict(rounds=3),
    "synthesize_cluster_trace": dict(n_requests=300),
    "synthesize_prefill_heavy_trace": dict(),
    "synthesize_admission_burst_trace": dict(),
    "synthesize_zipf_adapter_trace": dict(n_requests=200),
    "synthesize_schema_trace": dict(n_requests=200),
    "synthesize_session_trace": dict(n_sessions=6),
    "synthesize_diurnal_trace": dict(n_requests=300),
    "synthesize_flash_crowd_trace": dict(n_requests=300),
    "synthesize_deadline_mix_trace": dict(n_requests=120),
}


def _trace(pkg, name, seed):
    fn = getattr(SERVING[pkg], name.split("/")[0])
    return fn(seed=seed, **GENERATORS[name])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_trace_generators_match(name, seed, tmp_path):
    """The same Request fields, trace_stats and saved bytes; both
    loaders read either file back to the same requests."""
    ref, got = _trace("jax", name, seed), _trace("torch", name, seed)
    assert len(ref) == len(got) > 0
    assert [dataclasses.asdict(r) for r in ref] == \
        [dataclasses.asdict(r) for r in got]
    assert jax_serving.trace_stats(ref) == torch_serving.trace_stats(got)
    jax_serving.save_trace(str(tmp_path / "ref.jsonl"), ref)
    torch_serving.save_trace(str(tmp_path / "got.jsonl"), got)
    data = (tmp_path / "ref.jsonl").read_bytes()
    assert data == (tmp_path / "got.jsonl").read_bytes()
    back = torch_serving.load_trace(str(tmp_path / "ref.jsonl"))
    assert [dataclasses.asdict(r) for r in back] == \
        [dataclasses.asdict(r) for r in got]
    merged = [dataclasses.asdict(r) for r in torch_serving.merge_traces(
        got, torch_serving.synthesize_trace(seed=seed, rid_prefix="m"))]
    assert merged == [dataclasses.asdict(r) for r in jax_serving.merge_traces(
        ref, jax_serving.synthesize_trace(seed=seed, rid_prefix="m"))]


def test_jsonl_loader_tolerates_a_torn_tail(tmp_path):
    """A torn last line loads with a warning in both packages; a torn
    line earlier is an error in both."""
    path = tmp_path / "t.jsonl"
    torch_serving.save_trace(str(path), torch_serving.synthesize_trace(
        seed=2, n_requests=5))
    path.write_text(path.read_text() + '{"rid": "torn", "arr')
    loaded = {}
    for pkg, mod in (("jax", "paddle_tpu.serving.workload"),
                     ("torch", "paddle_tpu_torch.serving.workload")):
        workload = __import__(mod, fromlist=["iter_jsonl_tolerant"])
        with pytest.warns(UserWarning):
            loaded[pkg] = list(workload.iter_jsonl_tolerant(str(path)))
    assert loaded["jax"] == loaded["torch"] and len(loaded["jax"]) == 5
    lines = path.read_text().splitlines()
    path.write_text("\n".join([lines[0], "{torn", *lines[1:5]]) + "\n")
    for mod in (jax_serving, torch_serving):
        with pytest.raises(ValueError):
            mod.load_trace(str(path))


def _scripted_metrics(pkg):
    """A scripted event stream through a MetricsCollector: arrivals,
    admissions on both backends, a shed, a degrade, prefix hits, token
    bursts, an eviction, queue depths. Returns what it reports."""
    m = SERVING[pkg].MetricsCollector()
    m.on_arrival("a", 0.0, tenant="t0", deadline_ms=900.0)
    m.on_arrival("b", 0.5, tenant="t1", deadline_ms=300.0)
    m.on_arrival("c", 0.7, tenant="t0")
    m.on_arrival("d", 0.9, tenant="t1", deadline_ms=50.0)
    m.on_queue_depth(0.9, 3)
    m.on_admit("a", 1.0, "dense")
    m.on_admit("b", 1.0, "paged")
    m.on_degrade("b", 6, 8)
    m.on_prefix("b", 8, 8, 20)
    m.on_shed("d", 1.1, "deadline infeasible")
    m.on_tokens("a", 1.2, 1)
    m.on_tokens("b", 1.3, 1)
    m.on_admit("c", 1.4, "paged")
    for i in range(5):
        m.on_tokens("a", 1.5 + 0.1 * i, 1)
        m.on_tokens("b", 1.55 + 0.1 * i, 1)
    m.on_tokens("c", 2.2, 3)
    m.on_queue_depth(2.2, 0)
    m.on_finish("a", 2.0)
    m.on_finish("b", 2.1, evicted=True, reason="cancel")
    m.on_finish("c", 2.3)
    views = [m.request(r) for r in ("a", "b", "c", "d")]
    return {"report": m.report(), "report_slo": m.report(
        slo_ttft=0.5, slo_tpot=0.2), "rows": m.request_rows(),
        "views": views,
        "goodput": SERVING[pkg].goodput_tokens(views),
        "fairness": SERVING[pkg].jain_fairness([3.0, 1.0, 2.0]),
        "record": m.to_record("routed", seed=0)}


def test_metrics_collector_and_goodput_match():
    ref, got = _scripted_metrics("jax"), _scripted_metrics("torch")
    assert json.dumps(ref, sort_keys=True) == json.dumps(got, sort_keys=True)
    assert ref["report"]["completed"] == 3 and ref["goodput"] > 0


def _qos_decisions(pkg):
    """The QoS scheduler over the overload trace: enqueue each arrival,
    admit a wave of at most 2 each time unit (the queue holds 8, so
    the overload sheds), commit the wave; every decision
    (wave rids and budgets, sheds and reasons, degraded budgets)."""
    S = SERVING[pkg]
    sched = S.QoSScheduler(max_queue=8)
    est = S.ServiceEstimator(prefill=1.0, decode=0.25)
    trace = S.synthesize_overload_trace(seed=4, n_requests=60)
    out, i, now = [], 0, 0.0
    while i < len(trace) or sched.waiting():
        now += 1.0
        while i < len(trace) and trace[i].arrival <= now:
            out.append(("enqueue", [(r.rid, why) for r, why in
                                    sched.enqueue(trace[i], now)]))
            i += 1
        out.append(("expired", [(r.rid, why) for r, why in
                                sched.shed_expired(now)]))
        dec = sched.select(now, max_batch=2, est=est)
        out.append(("select", [(r.rid, r.max_new_tokens) for r in dec.wave],
                    [(r.rid, why) for r, why in dec.shed],
                    sorted(dec.degraded.items())))
        for r in dec.wave:
            sched.commit(r.rid, r.max_new_tokens)
    return out


def test_qos_scheduler_makes_the_same_decisions():
    ref, got = _qos_decisions("jax"), _qos_decisions("torch")
    assert ref == got
    shed = [s for s in ref if (s[2] if s[0] == "select" else s[1])]
    assert shed                    # the overload trace sheds


def _obs_outputs(pkg, root):
    """The observability spine on one scripted run: a tracer's chrome
    JSON, a fresh registry's exposition and snapshot, SLO incidents of
    every rule kind, a cost ledger's books, a flight bundle."""
    O = OBS[pkg]
    tick = iter(range(1000))
    tr = O.Tracer(clock=lambda: float(next(tick)))
    tr.add_span("prefill", 1.0, 2.5, track="engine", rid="r1", units=3)
    with O.trace_scope("r2"):
        with tr.span("decode", track="engine", n=4):
            tr.instant("admit", track="tenant:t0", backend="paged")
    tr.counter("queue_depth", 4, t=3.0)
    tr.async_begin("request", "r1", t=0.5, track="requests")
    tr.async_end("request", "r1", t=4.0, track="requests", outcome="ok")
    chrome = tr.to_chrome()
    tr.export(str(root / "trace.json"))

    reg = O.MetricsRegistry()
    reg.counter("served_total", "served", backend="paged").inc(3)
    reg.counter("served_total", "served", backend="dense").inc()
    g = reg.gauge("resident", "pages")
    g.set(7)
    g.dec(2)
    h = reg.histogram("ttft_seconds", "ttft", buckets=(0.1, 0.5, 1.0))
    for v in (0.05, 0.2, 0.7, 3.0):
        h.observe(v)
    # the wall stamp, overridden: the rest of the line is compared
    reg.write_jsonl(str(root / "metrics.jsonl"), run="x", ts=0.0)

    fr = O.FlightRecorder(bundle_dir=str(root / "bundles"))
    fr.attach(tr)
    log = O.IncidentLog()
    mon = O.SLOMonitor(
        [O.ThresholdRule(name="deep", signal="queue_depth", bound=5.0),
         O.BurnRateRule(name="burn", objective=0.9, windows=((10.0, 5.0),
                                                             (4.0, 5.0)),
                        min_events=4),
         O.HeartbeatRule(name="hb", timeout=5.0)],
        source="r0", log=log, flight=fr)
    for i, depth in enumerate((3, 7, 9, 2, 8)):
        mon.observe_value("queue_depth", depth, 1.0 + i)
        fr.sample("queue_depth", depth, 1.0 + i, source="r0")
    for i in range(6):
        mon.observe_request({"rid": f"q{i}", "deadline_met": i % 3 == 0,
                             "shed": False, "finish_reason": None,
                             "ttft": 0.1 * i, "tpot": 0.01}, 6.0 + i)
    mon.advance(30.0)
    mon.event("stall", 31.0, severity="warn", close_t=33.0)
    mon.advance(34.0)
    log.save(str(root / "incidents.jsonl"))

    led = O.CostLedger()
    led.open("a", tenant="acme", features=("prefix",))
    led.open("b", tenant="zeta")
    led.charge("e", "prefill", 2.0, rid="a")
    led.charge("e", "decode", 1.0, rids=["a", "b"], weights=[1.0, 3.0])
    led.idle("e", 0.5)
    led.note_outcome("a", "completed")
    led.note_estimate("b", 1.5)
    led.save_costs(str(root / "costs.json"))
    files = {p.relative_to(root).as_posix(): p.read_bytes()
             for p in sorted(root.rglob("*")) if p.is_file()}
    return {"chrome": chrome, "expose": reg.expose_text(),
            "snapshot": reg.snapshot(),
            "incidents": [dataclasses.asdict(i) for i in log],
            "by_kind": log.by_kind(), "audit": led.audit("e"),
            "cost_stats": led.cost_stats("e"), "rollup": led.rollup(),
            "census": (O.census_balanced(10, 4, 3, 3),
                       O.overlay_contained({1}, {1: 1}, {})),
            "files": files}


def test_obs_spine_matches(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = _obs_outputs("jax", tmp_path / "jax")
    got = _obs_outputs("torch", tmp_path / "torch")
    for key in ref:
        assert ref[key] == got[key], key
    assert ref["incidents"] and any(f.startswith("bundles/")
                                    for f in ref["files"])


LENGTH_TABLE = [
    ([], 8, False, False), ([16] * 8, 8, False, False),
    ([16] * 3, 8, False, False), ([16] * 4, 8, False, False),
    ([10, 16, 12, 14], 4, False, False), ([4, 16], 4, False, False),
    ([30, 31, 32, 29], 4, False, False), ([12] * 4, 4, True, False),
    ([12] * 4, 4, False, True), ([1], 1, False, False),
    ([512] * 8, 8, False, False), ([256, 384], 8, False, False)]


@pytest.mark.parametrize("lengths,capacity,shared,churn", LENGTH_TABLE)
def test_route_decode_explains_the_same_rule(lengths, capacity, shared,
                                             churn):
    ref = jax_decode.route_decode(lengths, capacity, shared, churn,
                                  explain=True)
    got = torch_decode.route_decode(lengths, capacity, shared, churn,
                                    explain=True)
    assert ref == got
    assert torch_decode.route_decode(lengths, capacity, shared,
                                     churn) == ref[0]


SCHEMAS = {
    "flag": {"type": "object", "properties": {"ok": {"type": "boolean"}},
             "required": ["ok"]},
    "level": {"type": "object",
              "properties": {"lvl": {"enum": ["lo", "mid", "hi"]},
                             "n": {"type": "integer", "maxDigits": 3}},
              "required": ["lvl", "n"]},
}


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_grammar_compiles_the_same_tables(schema):
    """One schema compiled against the ASCII vocabulary: the same DFA
    (masks, transitions, accepting states, token bounds) and the same
    verdicts."""
    tables = []
    for S in (jax_serving, torch_serving):
        vocab = S.TokenVocab.ascii_default(509)
        g = S.compile_schema(SCHEMAS[schema], vocab)
        tables.append(g)
    ref, got = tables
    assert (ref.n_states, ref.start, ref.min_tokens, ref.max_tokens) == \
        (got.n_states, got.start, got.min_tokens, got.max_tokens)
    for field in ("masks", "trans", "accepting", "allow_counts"):
        a, b = getattr(ref, field), getattr(got, field)
        assert a.dtype == b.dtype and (a == b).all(), field
    text = '{"ok":true}' if schema == "flag" else '{"lvl":"mid","n":42}'
    assert jax_serving.schema_accepts(SCHEMAS[schema], text) == \
        torch_serving.schema_accepts(SCHEMAS[schema], text) is True


def _arena_ops(pkg):
    """HostArena accounting through puts, pins, an LRU eviction, a
    refusal, takes and drops."""
    a = SERVING[pkg].HostArena(100)
    log = []
    a.put("old", "1", 30)
    a.put("pin", "2", 30, pin="rid-1")
    a.put("new", "3", 30, quant=True, epoch=2)
    a.put("in", "4", 40)           # evicts "old", never "pin"
    log.append(sorted(k for k in ("old", "pin", "new", "in") if k in a))
    try:
        a.put("big", "x", 90)
    except MemoryError as e:
        log.append(str(e))
    a.unpin("pin")
    log.append((a.pinned_bytes(), a.evictable_bytes(), a.free_bytes,
                a.stored_bytes()))
    log.append(a.take("new").nbytes)
    a.drop("in")
    log.append((a.stats(), a.census_ok(), len(a)))
    return log


def test_hostmem_arena_accounting_matches():
    assert _arena_ops("jax") == _arena_ops("torch")


def _adapter_ops(pkg):
    """An AdapterCache of 3 usable slots over 5 adapters: acquires,
    releases, and the LRU order in which parked adapters are reclaimed."""
    S = SERVING[pkg]
    store = S.AdapterStore({f"a{k}": {"salt": 7919 * (k + 1)}
                            for k in range(5)})
    sim = S.make_sim_serving(lora_slots=4)
    c = S.AdapterCache(store, 4, sim.init_adapter_bank, sim.upload_adapter)
    log = []
    for name, rid in (("a0", "r0"), ("a1", "r1"), ("a0", "r2"),
                      ("a2", "r3")):
        log.append(("acquire", name, c.acquire(name, rid)))
    for name, rid in (("a1", "r1"), ("a0", "r0"), ("a0", "r2"),
                      ("a2", "r3")):
        c.release(name, rid)
    for name, rid in (("a3", "r4"), ("a4", "r5"), ("a1", "r6")):
        log.append(("acquire", name, c.acquire(name, rid)))
        log.append({k: c.slot_of(k) for k in store.names()})
    log.append((c.cache_stats(), c.census_ok(), c.populations(),
                [int(x) for x in c.bank]))
    return log


def test_adapter_cache_lru_order_matches():
    ref = _adapter_ops("jax")
    assert ref == _adapter_ops("torch")
    assert ref[-1][0]["evictions"] > 0


def test_port_configs_match_the_reference():
    """The host configs the engine reads normalise their arguments as the
    reference's do; kv_quant_page_bytes prices a page and
    synthesize_lora_deltas draws the deltas the same."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.nlp import LlamaConfig

    for name, values in (("as_tp_config", (None, 2)),
                         ("as_lora_config", (None, (3, 2))),
                         ("as_spec_config", (None, True, False, 3)),
                         ("as_grammar_config", (None, (4, 16)))):
        for v in values:
            ref = getattr(jax_decode, name)(v)
            got = getattr(torch_decode, name)(v)
            assert (None if ref is None else dataclasses.asdict(ref)) == \
                (None if got is None else dataclasses.asdict(got)), (name, v)
    cfg = LlamaConfig.tiny(vocab=97, hidden=64, layers=2, heads=4,
                           kv_heads=2)
    for tdt, ndt in ((torch.float32, "float32"), (torch.int8, "int8")):
        assert torch_decode.kv_quant_page_bytes(cfg, 16, tdt) == \
            jax_decode.kv_quant_page_bytes(cfg, 16, ndt)
    ref = jax_decode.synthesize_lora_deltas(cfg, 2, seed=3)
    got = torch_decode.synthesize_lora_deltas(cfg, 2, seed=3)
    assert sorted(ref) == sorted(got)
    assert all(np.array_equal(ref[k], got[k]) for k in ref)
