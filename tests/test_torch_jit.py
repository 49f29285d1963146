"""``jit`` of the PyTorch port against the JAX package's.

* ``to_static``: the same calls on both packages give the same
  ``cache_stats`` after each call (hits, misses, compiles), the obs
  counters and the ``jit.compile`` trace instant move as the reference's,
  and the outputs agree within 1e-5 absolute + 1e-5 relative (float32 on
  both sides, the reference's weights carried by its ``state_dict`` as
  numpy into the port's ``set_state_dict``); a cached program reads the
  layer's current weights; a Python scalar is an input of the program.
* ``save`` / ``load``: the four artifacts, ``.pdmeta`` equal to the
  reference's, ``.pdiparams`` the reference's format (bfloat16 as the
  uint16 record of ``framework/io.py``); a symbolic batch (and, on a
  model without attention, a symbolic sequence) serves several sizes;
  the fallback warning; the exported classifier's graph holds its
  ``gqa_fwd`` operator nodes (their plain implementation on the CPU);
  a reference ``.pdexport`` is refused by name and its ``.pdiparams``
  loads.
* the reference's traps the port keeps, each named in a test.
"""
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu.obs import metrics as ref_metrics
from paddle_tpu_torch.core import place
from paddle_tpu_torch.obs import metrics as port_metrics
from paddle_tpu_torch.obs import trace as port_trace

TOL = dict(atol=1e-5, rtol=1e-5)
V, S, D, H, F, L, C = 97, 256, 64, 1, 128, 2, 3


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))


def _carry(ref, port):
    """The reference layer's weights into the port's."""
    port.set_state_dict({k: np.asarray(v._value)
                         for k, v in ref.state_dict().items()})
    return port


def _pair(make):
    ref = make(rp)
    return ref, _carry(ref, make(tp))


def _classifier(pkg):
    nn = pkg.nn

    class Classifier(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, D)
            layer = nn.TransformerEncoderLayer(D, H, F, dropout=0.0)
            self.encoder = nn.TransformerEncoder(layer, L)
            self.head = nn.Linear(D, C)

        def forward(self, ids):
            return self.head(pkg.mean(self.encoder(self.embed(ids)), axis=1))

    return Classifier()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stats(sf):
    st = sf.cache_stats()
    return st["hits"], st["misses"], st["compiles"]


def test_cache_stats_sequence_equals_the_references():
    ref, port = _pair(_mlp)
    rs = rp.jit.to_static(ref).forward_static
    ps = tp.jit.to_static(port).forward_static
    calls = [(_x(2, 4), "eval"), (_x(2, 4, seed=1), "eval"),
             (_x(4, 4), "eval"), (_x(2, 4, seed=2), "train"),
             (_x(2, 4, seed=3), "train"), (_x(4, 4, seed=4), "eval")]
    seq_r, seq_p = [], []
    for x, mode in calls:
        for m in (ref, port):
            getattr(m, mode)()
        want = rs(rp.to_tensor(x)).numpy()
        got = ps(torch.from_numpy(x))
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        seq_r.append(_stats(rs))
        seq_p.append(_stats(ps))
    assert seq_p == seq_r == [(0, 1, 1), (1, 1, 1), (1, 2, 2), (1, 3, 3),
                              (2, 3, 3), (3, 3, 3)]
    assert ps.cache_stats()["last_compile_s"] > 0
    assert ps._cache_info is ps._cache_info and ps._cache_info["hits"] == 3


def test_public_cache_stats_and_obs_counters():
    def f(x):
        return x * 2 + 1

    rf, pf = rp.jit.to_static(f), tp.jit.to_static(f)
    before = port_metrics.REGISTRY.counter("jit_cache_hits_total").value
    misses = port_metrics.REGISTRY.counter("jit_cache_misses_total").value
    rbefore = ref_metrics.REGISTRY.counter("jit_cache_hits_total").value
    for shape in ((2, 3), (2, 3), (2, 3), (4, 3)):
        x = np.ones(shape, np.float32)
        np.testing.assert_allclose(pf(torch.from_numpy(x)).numpy(),
                                   rf(rp.to_tensor(x)).numpy(), **TOL)
    assert _stats(pf) == _stats(rf) == (2, 2, 2)
    hits = port_metrics.REGISTRY.counter("jit_cache_hits_total").value
    assert hits - before == 2 == (ref_metrics.REGISTRY.counter(
        "jit_cache_hits_total").value - rbefore)
    assert port_metrics.REGISTRY.counter(
        "jit_cache_misses_total").value - misses == 2
    assert port_metrics.REGISTRY.histogram("jit_compile_seconds").count >= 2


def test_compile_instant_reaches_the_active_tracer():
    @tp.jit.to_static
    def g(x):
        return x + 1

    t = port_trace.Tracer(clock=lambda: 0.0)
    with port_trace.use(t):
        g(torch.ones(5))
        g(torch.ones(5))
    compiles = [e for e in t.events if e["name"] == "jit.compile"]
    assert len(compiles) == 1
    assert compiles[0]["args"]["wall_s"] > 0


def test_cached_program_reads_the_current_weights():
    ref, port = _pair(_mlp)
    ps = tp.jit.to_static(port).forward_static
    x = _x(3, 4)
    ps(torch.from_numpy(x))
    new = _mlp(rp)
    _carry(new, port)
    got = ps(torch.from_numpy(x))
    assert _stats(ps) == (1, 1, 1)
    np.testing.assert_allclose(got.numpy(), new(rp.to_tensor(x)).numpy(),
                               **TOL)


def test_python_scalar_is_a_program_input():
    def f(x, n):
        s = x * 0
        i = 0
        while i < n:
            s = s + x
            i = i + 1
        return s

    rf, pf = rp.jit.to_static(f), tp.jit.to_static(f)
    x = np.ones(2, np.float32)
    for n in (3, 5):
        np.testing.assert_allclose(pf(torch.from_numpy(x), n).numpy(),
                                   rf(rp.to_tensor(x), n).numpy(), **TOL)
    assert _stats(pf) == _stats(rf) == (1, 1, 1)


def test_save_writes_the_references_artifacts(tmp_path):
    ref, port = _pair(_mlp)
    spec = [None, 4]
    rp.jit.save(ref, str(tmp_path / "r"),
                input_spec=[rp.jit.InputSpec(spec)])
    tp.jit.save(port, str(tmp_path / "p"),
                input_spec=[tp.jit.InputSpec(spec)])
    for ext in (".pdmodel", ".pdiparams", ".pdexport", ".pdmeta"):
        assert os.path.getsize(tmp_path / f"p{ext}") > 0
    with open(tmp_path / "r.pdmeta", "rb") as f:
        rmeta = pickle.load(f)
    with open(tmp_path / "p.pdmeta", "rb") as f:
        pmeta = pickle.load(f)
    assert pmeta == rmeta
    with open(tmp_path / "r.pdiparams", "rb") as f:
        rstate = pickle.load(f)
    with open(tmp_path / "p.pdiparams", "rb") as f:
        pstate = pickle.load(f)
    assert list(pstate) == list(rstate)
    for k in rstate:
        assert pstate[k].dtype == rstate[k].dtype
        np.testing.assert_array_equal(pstate[k], rstate[k])
    assert "linear" in (tmp_path / "p.pdmodel").read_text()
    layer = tp.jit.load(str(tmp_path / "p"))
    rlayer = rp.jit.load(str(tmp_path / "r"))
    for b in (1, 3, 8):
        x = _x(b, 4, seed=b)
        np.testing.assert_allclose(
            layer(torch.from_numpy(x)).numpy(),
            np.asarray(rlayer(rp.to_tensor(x))._value), **TOL)
    assert sorted(layer.state_dict()) == sorted(rstate)


def test_bfloat16_params_are_uint16_records(tmp_path):
    port = _mlp(tp).to(dtype="bfloat16")
    tp.jit.save(port, str(tmp_path / "b"))
    with open(tmp_path / "b.pdiparams", "rb") as f:
        state = pickle.load(f)
    rec = state["0.weight"]
    assert rec["dtype"] == "bfloat16" and rec["data"].dtype == np.uint16
    np.testing.assert_array_equal(
        rec["data"], port[0].weight.detach().view(torch.int16).numpy()
        .view(np.uint16))
    back = tp.jit.load(str(tmp_path / "b")).state_dict()["0.weight"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16),
                       port[0].weight.detach().view(torch.int16))


def test_symbolic_batch_and_sequence_without_attention(tmp_path):
    class Seq(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tp.nn.Linear(4, 3)

        def forward(self, x):
            return tp.nn.functional.relu(self.fc(x)).sum(axis=1)

    class RSeq(rp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = rp.nn.Linear(4, 3)

        def forward(self, x):
            return rp.nn.functional.relu(self.fc(x)).sum(axis=1)

    ref = RSeq()
    port = _carry(ref, Seq())
    tp.jit.save(port, str(tmp_path / "s"),
                input_spec=[tp.jit.InputSpec([None, -1, 4])])
    layer = tp.jit.load(str(tmp_path / "s"))
    for b, s in ((1, 3), (5, 7), (2, 1)):
        x = _x(b, s, 4, seed=b * s)
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   ref(rp.to_tensor(x)).numpy(), **TOL)


def test_shape_dependent_capture_falls_back_with_the_warning(tmp_path):
    class Picky(tp.nn.Layer):
        def forward(self, x):
            if x.shape[0] == 2:
                return x * 2
            return x

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tp.jit.save(Picky(), str(tmp_path / "f"),
                    input_spec=[tp.jit.InputSpec([None, 4])])
    msgs = [str(m.message) for m in w]
    assert any(m.startswith("jit.save: symbolic-shape export failed")
               and "falling back to the concrete example shapes" in m
               for m in msgs), msgs
    layer = tp.jit.load(str(tmp_path / "f"))
    np.testing.assert_allclose(layer(torch.ones(1, 4)).numpy(),
                               np.ones((1, 4)))
    with pytest.raises(Exception):
        layer(torch.ones(3, 4))


def test_exported_classifier_holds_the_kernel_operator(tmp_path):
    """Each attention layer's forward is one ``gqa_fwd`` node of the
    loaded program (its plain implementation here); the predictions
    equal eager mode's and the reference's."""
    ref = _classifier(rp)
    port = _carry(ref, _classifier(tp))
    port.eval()
    tp.jit.save(port, str(tmp_path / "c"),
                input_spec=[tp.jit.InputSpec([None, S], "int64")])
    layer = tp.jit.load(str(tmp_path / "c"))
    nodes = [n for n in layer.program.graph.nodes
             if n.target is torch.ops.paddle_tpu_torch.gqa_fwd.default]
    assert len(nodes) == L
    ids = np.random.default_rng(1).integers(0, V, (3, S))
    got = layer(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, port(torch.from_numpy(ids))
                                  .detach().numpy())
    np.testing.assert_allclose(got, ref(rp.to_tensor(ids)).numpy(), **TOL)
    st = tp.jit.to_static(port).forward_static
    st(torch.from_numpy(ids))
    assert sum(n.target is torch.ops.paddle_tpu_torch.gqa_fwd.default
               for n in st.concrete_program.graph.nodes) == L


def test_reference_pdexport_is_refused_and_its_pdiparams_load(tmp_path):
    ref, port = _pair(_mlp)
    rp.jit.save(ref, str(tmp_path / "r"),
                input_spec=[rp.jit.InputSpec([2, 4])])
    with pytest.raises(ValueError, match="jax.export"):
        tp.jit.load(str(tmp_path / "r"))
    rp.jit.save(ref, str(tmp_path / "w"))
    layer = tp.jit.load(str(tmp_path / "w"))
    fresh = _mlp(tp)
    fresh.set_state_dict(layer.state_dict())
    x = _x(2, 4)
    np.testing.assert_allclose(fresh(torch.from_numpy(x)).detach().numpy(),
                               ref(rp.to_tensor(x)).numpy(), **TOL)


def test_trap_save_without_input_spec_writes_no_program(tmp_path):
    """Kept from the reference (ROADMAP Queue 3): without ``input_spec``
    ``save`` writes only the weights and the meta, and the loaded layer's
    forward raises."""
    ref, port = _pair(_mlp)
    tp.jit.save(port, str(tmp_path / "n"))
    rp.jit.save(ref, str(tmp_path / "rn"))
    assert not os.path.exists(tmp_path / "n.pdexport")
    assert not os.path.exists(tmp_path / "n.pdmodel")
    with open(tmp_path / "n.pdmeta", "rb") as f:
        meta = pickle.load(f)
    with open(tmp_path / "rn.pdmeta", "rb") as f:
        assert meta == pickle.load(f)
    assert meta["has_export"] is False
    for mod, path in ((tp, "n"), (rp, "rn")):
        with pytest.raises(RuntimeError, match="input_spec"):
            mod.jit.load(str(tmp_path / path))(np.ones((2, 4), np.float32))


def test_trap_traced_layer_ignores_feed_and_fetch(tmp_path):
    """Kept from the reference (ROADMAP Queue 3):
    ``TracedLayer.save_inference_model`` never reads ``feed`` / ``fetch``:
    the artifact takes every example input and returns every output."""
    class Two(tp.nn.Layer):
        def forward(self, x, y):
            return x + y, x * y

    x, y = torch.ones(2, 3), torch.full((2, 3), 2.0)
    out, traced = tp.jit.TracedLayer.trace(Two(), [x, y])
    assert torch.equal(out[0], x + y)
    traced.save_inference_model(str(tmp_path / "t"), feed=[0], fetch=[1])
    layer = tp.jit.load(str(tmp_path / "t"))
    got = layer(x, y)
    assert len(got) == 2 and torch.equal(got[1], x * y)
    assert isinstance(traced.program, torch.export.ExportedProgram)


def test_trap_to_static_returns_the_layer_itself():
    """Kept from the reference (ROADMAP Queue 3): ``to_static(layer)``
    returns the layer, its captured forward as ``forward_static``;
    calling the layer itself stays eager (no program is captured)."""
    ref, port = _pair(_mlp)
    assert rp.jit.to_static(ref) is ref
    st = tp.jit.to_static(port)
    assert st is port
    x = torch.from_numpy(_x(2, 4))
    port(x)
    assert _stats(port.forward_static) == (0, 0, 0)
    assert port._static_forward is port.forward_static
