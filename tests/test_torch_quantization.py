"""``quantization`` of the PyTorch port against the JAX package's.

Mirrors ``tests/test_quantization.py`` on the same seeded numpy inputs
and the same weights (the reference's ``state_dict`` as numpy into the
port's ``set_state_dict``):

* the observers' scales equal the reference's (the port keeps its own
  copy of the numpy observers);
* ``quantize_weight_per_channel`` equal; QAT's straight-through
  gradients within 1e-5 absolute + 1e-5 relative;
* PTQ per algorithm (abs_max / avg / hist / KL): calibrated scales equal,
  int8 outputs within 1e-6 relative of the reference's (the int32 sums
  are exact; the f32 rescale is the same product), and close to float;
* ``Int8Linear`` within 1e-6; ``convert_to_int8`` by dotted path; the
  int8 model exported with a symbolic batch;
* the traps and refusals, each named.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu import quantization as rq
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.core import place

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))


def _pair(make=_mlp):
    ref = make(rp)
    port = make(tp)
    port.set_state_dict({k: np.asarray(v._value)
                         for k, v in ref.state_dict().items()})
    return ref, port


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


class TestObservers:
    def test_abs_max(self):
        got, want = pq.AbsMaxObserver(), rq.AbsMaxObserver()
        for o in (got, want):
            o.update(np.array([1.0, -3.0]))
            o.update(np.array([2.0]))
        assert got.scale() == want.scale() == 3.0

    def test_hist_percentile_ignores_outlier(self):
        scales = []
        for mod in (pq, rq):
            obs = mod.HistObserver(bins=256, percentile=0.99)
            rng = np.random.default_rng(0)
            obs.update(rng.normal(0, 1.0, 10000))
            obs.update(np.array([50.0]))
            scales.append(obs.scale())
        assert scales[0] == scales[1] < 10.0

    def test_hist_range_stretch(self):
        scales = []
        for mod in (pq, rq):
            obs = mod.HistObserver(bins=64)
            obs.update(np.linspace(0, 1, 100))
            obs.update(np.linspace(0, 4, 100))
            scales.append(obs.scale())
        assert scales[0] == scales[1] and 0 < scales[0] <= 4.0

    def test_kl(self):
        scales = []
        for mod in (pq, rq):
            obs = mod.HistObserver(bins=512, algo="KL")
            obs.update(np.random.default_rng(1).normal(0, 1.0, 20000))
            scales.append(obs.scale())
        assert scales[0] == scales[1] and 0.5 < scales[0] < 6.0
        with pytest.raises(ValueError, match="abs_max"):
            pq.make_observer("mse")


class TestWeightQuant:
    def test_per_channel_equals_the_references(self):
        rng = np.random.default_rng(0)
        w = rng.normal(0, 1, (8, 4)).astype(np.float32)
        w[:, 2] *= 100.0  # one large-magnitude channel
        q, s = pq.quantize_weight_per_channel(w, axis=1)
        rq_, rs = rq.quantize_weight_per_channel(w, axis=1)
        assert q.dtype == np.int8 and s.shape == (1, 4)
        np.testing.assert_array_equal(q, rq_)
        np.testing.assert_array_equal(s, rs)


class TestQAT:
    def test_ste_gradients_equal_the_references(self):
        ref, port = _pair()
        rm = rq.ImperativeQuantAware().quantize(ref)
        pm = pq.ImperativeQuantAware().quantize(port)
        assert isinstance(pm[0], pq.QuantedLinear)
        rm.train()
        pm.train()
        x = np.random.default_rng(0).normal(0, 1, (4, 16)).astype(
            np.float32)
        rloss = rm(rp.to_tensor(x)).mean()
        rloss.backward()
        ploss = pm(torch.from_numpy(x)).mean()
        ploss.backward()
        np.testing.assert_allclose(float(ploss.detach()), float(rloss), **TOL)
        for i in (0, 2):
            g = pm[i].inner.weight.grad.numpy()
            assert np.isfinite(g).all() and np.abs(g).sum() > 0
            np.testing.assert_allclose(g, rm[i].inner.weight.grad.numpy(),
                                       **TOL)
            for name in ("act_quant", "w_quant"):
                np.testing.assert_allclose(
                    float(getattr(pm[i], name).scale),
                    float(getattr(rm[i], name).scale._value), **TOL)

    def test_trap_subclass_of_linear_is_not_quantized(self):
        """Kept from the reference (ROADMAP Queue 3): class names match
        exactly, so a subclass of ``Linear`` stays float."""
        class MyLinear(tp.nn.Linear):
            pass

        class RMyLinear(rp.nn.Linear):
            pass

        pm = pq.ImperativeQuantAware().quantize(
            tp.nn.Sequential(MyLinear(4, 4), tp.nn.Linear(4, 2)))
        rm = rq.ImperativeQuantAware().quantize(
            rp.nn.Sequential(RMyLinear(4, 4), rp.nn.Linear(4, 2)))
        assert type(pm[0]) is MyLinear and type(rm[0]) is RMyLinear
        assert isinstance(pm[1], pq.QuantedLinear)
        assert isinstance(rm[1], rq.QuantedLinear)


class TestPTQ:
    @pytest.mark.parametrize("algo", ["abs_max", "avg", "hist", "KL"])
    def test_int8_equals_the_references(self, algo):
        rng = np.random.default_rng(0)
        ref, port = _pair()
        ref.eval()
        port.eval()
        x = rng.normal(0, 1, (32, 16)).astype(np.float32)
        fp = port(torch.from_numpy(x)).detach().numpy()
        rptq = rq.PostTrainingQuantization(
            ref, [rp.to_tensor(x[i:i + 8]) for i in range(0, 32, 8)],
            algo=algo)
        pptq = pq.PostTrainingQuantization(
            port, [torch.from_numpy(x[i:i + 8]) for i in range(0, 32, 8)],
            algo=algo)
        rqm, pqm = rptq.quantize(), pptq.quantize()
        assert pptq.act_scales == rptq.act_scales
        assert isinstance(pqm[0], pq.Int8Linear)
        assert pqm[0].act_scale is not None
        out = pqm(torch.from_numpy(x)).detach().numpy()
        assert _rel(out, rqm(rp.to_tensor(x)).numpy()) < 1e-6
        mean_rel = np.abs(out - fp).mean() / (np.abs(fp).mean() + 1e-8)
        max_rel = np.abs(out - fp).max() / (np.abs(fp).max() + 1e-8)
        assert mean_rel < 0.1, f"{algo}: mean deviation {mean_rel:.3f}"
        assert max_rel < 0.5, f"{algo}: max deviation {max_rel:.3f}"

    def test_save_quantized_model(self, tmp_path):
        rng = np.random.default_rng(0)
        ref, port = _pair()
        x = rng.normal(0, 1, (8, 16)).astype(np.float32)
        rptq = rq.PostTrainingQuantization(ref, [rp.to_tensor(x)])
        pptq = pq.PostTrainingQuantization(port, [torch.from_numpy(x)])
        rptq.quantize()
        pptq.quantize()
        rstate = rptq.save_quantized_model(str(tmp_path / "r"))
        state = pptq.save_quantized_model(str(tmp_path / "q"))
        assert sorted(state) == sorted(rstate)
        int8_keys = [k for k in state if k.endswith("weight_int8")]
        assert len(int8_keys) == 2
        for k, v in state.items():
            np.testing.assert_array_equal(v, rstate[k])
        assert (tmp_path / "q.pdquant").exists()

    def test_dynamic_fallback(self):
        ref, port = _pair()
        x = np.random.default_rng(0).normal(0, 1, (4, 16)).astype(
            np.float32)
        fp = port(torch.from_numpy(x)).detach().numpy()
        qm = pq.convert_to_int8(port)
        assert qm[0].act_scale is None
        out = qm(torch.from_numpy(x)).detach().numpy()
        assert _rel(out, rq.convert_to_int8(ref)(rp.to_tensor(x))
                    .numpy()) < 1e-6
        assert _rel(out, fp) < 0.1

    def test_int8_model_exports_with_a_symbolic_batch(self, tmp_path):
        ref, port = _pair()
        x = np.random.default_rng(5).normal(0, 1, (8, 16)).astype(
            np.float32)
        pq.PostTrainingQuantization(port, [torch.from_numpy(x)]).quantize()
        tp.jit.save(port, str(tmp_path / "q8"),
                    input_spec=[tp.jit.InputSpec([None, 16])])
        layer = tp.jit.load(str(tmp_path / "q8"))
        assert any(n.target is torch.ops.aten._int_mm.default
                   for n in layer.program.graph.nodes)
        for b in (1, 3, 8):
            xb = torch.from_numpy(x[:b])
            assert torch.equal(layer(xb), port(xb))


def test_card_padding_exports_with_a_symbolic_row_count():
    """The card's padded product (``_int_mm_padded``; ``torch._int_mm``
    there takes > 16 rows and sizes that are multiples of 8) captured with
    a symbolic batch: one program, exact int32 sums at 1, 3 and 5 rows
    of 512 and at 9 odd-sized rows (run here on the CPU's
    ``torch._int_mm``, which takes the padded operands as they are)."""
    from paddle_tpu_torch.quantization import int8 as q8

    class Product(torch.nn.Module):
        def __init__(self, w):
            super().__init__()
            self.register_buffer("w", w)

        def forward(self, x):
            acc = q8._int_mm_padded(x.reshape(-1, x.shape[-1]), self.w)
            return acc.reshape(*x.shape[:-1], self.w.shape[1])

    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.integers(-127, 128, (36, 2)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-127, 128, (2, 512, 36))
                         .astype(np.int8))
    with torch.no_grad():
        ep = torch.export.export(
            Product(w), (x,), strict=False,
            dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    for b in (1, 3, 5):
        xb = torch.from_numpy(rng.integers(-127, 128, (b, 512, 36))
                              .astype(np.int8))
        want = xb.reshape(-1, 36).to(torch.int32) @ w.to(torch.int32)
        assert torch.equal(ep.module()(xb), want.reshape(b, 512, 2))
    odd = torch.from_numpy(rng.integers(-127, 128, (9, 36)).astype(np.int8))
    assert torch.equal(q8._int_mm_padded(odd, w),
                       odd.to(torch.int32) @ w.to(torch.int32))


class TestActScalePlumbing:
    def test_static_scale_matches_dynamic_at_absmax(self):
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, (4, 16)).astype(np.float32)
        w = rng.normal(0, 1, (16, 8)).astype(np.float32)
        q, s = pq.quantize_weight_per_channel(w, axis=1)
        args = (torch.from_numpy(x), torch.from_numpy(q),
                torch.from_numpy(s[0]))
        dyn = pq.int8_matmul(*args).numpy()
        sx = float(np.abs(x).max()) / pq.QMAX
        stat = pq.int8_matmul(*args, act_scale=sx).numpy()
        assert (dyn == stat).all()
        other = pq.int8_matmul(*args, act_scale=sx / 4).numpy()
        assert not (other == dyn).all()
        from paddle_tpu.quantization.int8 import int8_matmul
        want = np.asarray(int8_matmul(x, q, s[0], act_scale=sx / 4))
        assert _rel(other, want) < 1e-6

    def test_int8_linear_equals_the_references(self):
        ref, port = _pair(lambda pkg: pkg.nn.Linear(32, 16))
        x = np.random.default_rng(1).normal(0, 1, (8, 32)).astype(
            np.float32)
        got = pq.Int8Linear(port, act_scale=0.03)(torch.from_numpy(x))
        want = rq.Int8Linear(ref, act_scale=0.03)(rp.to_tensor(x))
        assert got.dtype == torch.float32
        assert _rel(got.detach().numpy(), want.numpy()) < 1e-6
        out = got.detach().numpy()
        fp = x @ np.asarray(ref.weight._value) + np.asarray(ref.bias._value)
        assert np.abs(out - fp).mean() / np.abs(fp).mean() < 0.02

    def test_convert_act_scales_nested_paths(self):
        def nested(pkg):
            nn = pkg.nn
            return nn.Sequential(nn.Linear(16, 8), nn.ReLU(),
                                 nn.Sequential(nn.Linear(8, 4)))
        ref, port = _pair(nested)
        x = np.random.default_rng(2).normal(0, 1, (4, 16)).astype(
            np.float32)
        qm = pq.convert_to_int8(port, act_scales={"2.0": 0.05})
        rqm = rq.convert_to_int8(ref, act_scales={"2.0": 0.05})
        assert qm[0].act_scale is None
        assert qm[2][0].act_scale == 0.05
        assert isinstance(qm[2][0], pq.Int8Linear)
        assert _rel(qm(torch.from_numpy(x)).detach().numpy(),
                    rqm(rp.to_tensor(x)).numpy()) < 1e-6


def test_model_parallel_linears_are_refused_by_name():
    class ColumnParallelLinear(tp.nn.Layer):
        pass

    model = tp.nn.Sequential(tp.nn.Linear(4, 4), ColumnParallelLinear())
    with pytest.raises(NotImplementedError, match="item 15"):
        pq.convert_to_int8(model)
