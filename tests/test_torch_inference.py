"""``inference`` of the PyTorch port against the JAX package's.

Mirrors ``tests/test_inference_ps.py::TestInference`` and
``::TestDynamicBatcher``: the same model (the reference's weights carried
by its ``state_dict`` as numpy into the port's ``set_state_dict``) saved
by each package's ``jit.save`` and run by each package's predictor on
the same numpy inputs, float32 within 1e-5 absolute + 1e-5 relative:
``Predictor`` at batch 1, 3 and 8, the handles, clones and
``PredictorPool`` sharing the loaded program and its weights, and
``DynamicBatcher``'s coalescing, lone-request flush, shared batch symbol
and malformed-request cases. The reference's traps the port keeps are
each named in a test.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu import inference as rinf
from paddle_tpu_torch import inference
from paddle_tpu_torch.core import place

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


def _saved(tmp_path, make, spec, name="m"):
    """(reference layer, port layer, reference path, port path), each
    saved by its own package with ``spec``."""
    ref = make(rp)
    ref.eval()
    port = make(tp)
    port.set_state_dict({k: np.asarray(v._value)
                         for k, v in ref.state_dict().items()})
    port.eval()
    rpath, ppath = str(tmp_path / f"r{name}"), str(tmp_path / f"p{name}")
    rp.jit.save(ref, rpath, input_spec=[rp.jit.InputSpec(s) for s in spec])
    tp.jit.save(port, ppath, input_spec=[tp.jit.InputSpec(s) for s in spec])
    return ref, port, rpath, ppath


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))


def _linear(n_in, n_out):
    return lambda pkg: pkg.nn.Linear(n_in, n_out)


class TestInference:
    def test_export_and_predict(self, tmp_path):
        _, _, rpath, ppath = _saved(tmp_path, _mlp, [[2, 4]])
        x = np.random.default_rng(0).standard_normal((2, 4)).astype(
            np.float32)
        out = inference.Predictor(ppath).run([x])
        np.testing.assert_allclose(out[0], rinf.Predictor(rpath).run([x])[0],
                                   **TOL)

    def test_handle_api(self, tmp_path):
        ref, _, _, ppath = _saved(tmp_path, _linear(3, 2), [[1, 3]])
        cfg = inference.Config(ppath)
        pred = inference.create_predictor(cfg)
        h = pred.get_input_handle("x0")
        h.copy_from_cpu(np.ones((1, 3), np.float32))
        pred.run()
        out = pred.get_output_handle("out0").copy_to_cpu()
        assert out.shape == (1, 2)
        np.testing.assert_allclose(
            out, ref(rp.to_tensor(np.ones((1, 3), np.float32))).numpy(),
            **TOL)

    def test_clone_and_pool_share_weights(self, tmp_path):
        _, _, rpath, ppath = _saved(tmp_path, _linear(3, 2), [[1, 3]])
        cfg = inference.Config(ppath)
        cfg.enable_memory_optim()
        cfg.disable_glog_info()
        pred = inference.Predictor(cfg)
        clone = pred.clone()
        assert clone._layer is pred._layer  # shared program + weights
        x = np.random.default_rng(1).standard_normal((1, 3)).astype(
            np.float32)
        np.testing.assert_allclose(pred.run([x])[0], clone.run([x])[0],
                                   rtol=1e-6)
        pool = inference.PredictorPool(cfg, size=3)
        assert len(pool) == 3
        assert pool.retrieve(2)._layer is pool.retrieve(0)._layer
        a = dict(pool.retrieve(1)._layer._program.named_parameters())
        b = dict(pool.retrieve(2)._layer._program.named_parameters())
        assert all(a[k].data_ptr() == b[k].data_ptr() for k in a)
        np.testing.assert_allclose(pool.retrieve(1).run([x])[0],
                                   rinf.Predictor(rpath).run([x])[0], **TOL)
        # memory_optim keeps the outputs on the device until copy_to_cpu
        assert isinstance(pred._outputs[0], torch.Tensor)

    def test_signature_names_and_zero_copy(self, tmp_path):
        _, _, _, ppath = _saved(tmp_path, _linear(4, 2), [[2, 4]])
        pred = inference.Predictor(ppath)
        # input names derive from the exported signature, not a fixed pad
        assert pred.get_input_names() == ["x0"]
        h = pred.get_input_handle("x0")
        h.share_external_data(torch.ones(2, 4))  # no host copy
        out = pred.run()
        assert out[0].shape == (2, 2)
        assert pred.get_output_handle("out0").shape() == (2, 2)

    def test_config_summary(self):
        cfg = inference.Config("some/model")
        cfg.set_cpu_math_library_num_threads(4)
        assert cfg.cpu_math_library_num_threads() == 4
        s = cfg.summary()
        assert "some/model" in s and "cpu_math_threads" in s
        cfg.switch_ir_optim(False)
        assert not cfg.ir_optim()
        assert not cfg.use_gpu()
        assert inference.get_version() == tp.__version__


def test_trap_output_names_before_the_first_run(tmp_path):
    """Kept from the reference (ROADMAP Queue 3): before the first
    ``run`` the output names are ``["out0"]`` whatever the program
    returns."""
    class Two(tp.nn.Layer):
        def forward(self, x):
            return x + 1, x * 2

    class RTwo(rp.nn.Layer):
        def forward(self, x):
            return x + 1, x * 2

    tp.jit.save(Two(), str(tmp_path / "t"),
                input_spec=[tp.jit.InputSpec([2, 3])])
    rp.jit.save(RTwo(), str(tmp_path / "r"),
                input_spec=[rp.jit.InputSpec([2, 3])])
    pred = inference.Predictor(str(tmp_path / "t"))
    rpred = rinf.Predictor(str(tmp_path / "r"))
    assert pred.get_output_names() == rpred.get_output_names() == ["out0"]
    x = np.ones((2, 3), np.float32)
    pred.run([x])
    rpred.run([x])
    assert pred.get_output_names() == rpred.get_output_names() \
        == ["out0", "out1"]


def test_trap_handle_name_without_digits_is_index_0(tmp_path):
    """Kept from the reference (ROADMAP Queue 3): a handle name without
    digits maps to index 0, for inputs and outputs."""
    _, _, _, ppath = _saved(tmp_path, _linear(3, 2), [[1, 3]])
    pred = inference.Predictor(ppath)
    rpred = rinf.Predictor(str(tmp_path / "rm"))
    for p in (pred, rpred):
        assert p.get_input_handle("input").idx == 0
        assert p.get_output_handle("logits").idx == 0
    pred.get_input_handle("ids").copy_from_cpu(np.ones((1, 3), np.float32))
    pred.run()
    assert pred.get_output_handle("whatever").copy_to_cpu().shape == (1, 2)


class TestDynamicBatcher:
    def _artifact(self, tmp_path):
        # None batch dim -> symbolic export: one artifact, any batch size
        ref, port, rpath, ppath = _saved(tmp_path, _mlp, [[None, 4]],
                                         "batched")
        return ref, ppath, rpath

    def test_symbolic_export_serves_any_batch(self, tmp_path):
        ref, path, rpath = self._artifact(tmp_path)
        pred = inference.Predictor(path)
        rpred = rinf.Predictor(rpath)
        for b in (1, 3, 8):
            x = np.random.default_rng(b).standard_normal((b, 4)).astype(
                np.float32)
            np.testing.assert_allclose(pred.run([x])[0], rpred.run([x])[0],
                                       **TOL)
            np.testing.assert_allclose(pred.run([x])[0],
                                       ref(rp.to_tensor(x)).numpy(), **TOL)

    def test_concurrent_requests_coalesce(self, tmp_path):
        ref, path, _ = self._artifact(tmp_path)
        batcher = inference.DynamicBatcher(inference.Predictor(path),
                                           max_batch=16, max_delay_ms=30.0)
        rng = np.random.default_rng(0)
        xs = [rng.standard_normal((1, 4)).astype(np.float32)
              for _ in range(12)]
        results = [None] * 12

        def req(i):
            results[i] = batcher.infer([xs[i]])[0]

        threads = [threading.Thread(target=req, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i in range(12):
            np.testing.assert_allclose(
                results[i], ref(rp.to_tensor(xs[i])).numpy(), **TOL)
        # coalescing happened: fewer predictor runs than requests
        assert batcher._runs < 12, batcher._runs
        batcher.shutdown()

    def test_lone_request_flushes_at_max_delay(self, tmp_path):
        ref, path, _ = self._artifact(tmp_path)
        pred = inference.Predictor(path)
        cfg = inference.BatchingConfig(max_batch=16, max_delay_ms=40.0)
        batcher = inference.DynamicBatcher(pred, config=cfg)
        assert batcher.max_batch == 16
        assert abs(batcher.max_delay - 0.040) < 1e-9
        x = np.random.default_rng(2).standard_normal((1, 4)).astype(
            np.float32)
        _ = batcher.infer([x])
        t0 = time.perf_counter()
        out = batcher.infer([x])[0]
        waited = time.perf_counter() - t0
        np.testing.assert_allclose(out, ref(rp.to_tensor(x)).numpy(), **TOL)
        assert waited < 5.0, waited
        assert batcher._runs == 2  # two flushes of one request each
        b2 = inference.DynamicBatcher(pred, max_batch=4, max_delay_ms=1.0,
                                      config=cfg)
        assert b2.max_batch == 4 and b2.config.max_delay_ms == 1.0
        b2.shutdown()
        batcher.shutdown()

    def test_two_input_model_shares_batch_symbol(self, tmp_path):
        def two_in(pkg):
            class TwoIn(pkg.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.fc = pkg.nn.Linear(4, 2)

                def forward(self, x, y):
                    return self.fc(x + y)
            return TwoIn()

        ref, _, rpath, ppath = _saved(tmp_path, two_in,
                                      [[None, 4], [None, 4]], "twoin")
        pred = inference.Predictor(ppath)
        assert pred.get_input_names() == ["x0", "x1"]
        rpred = rinf.Predictor(rpath)
        for b in (1, 5):
            rng = np.random.default_rng(b)
            x = rng.standard_normal((b, 4)).astype(np.float32)
            y = rng.standard_normal((b, 4)).astype(np.float32)
            np.testing.assert_allclose(pred.run([x, y])[0],
                                       rpred.run([x, y])[0], **TOL)

    def test_malformed_request_does_not_poison_batch(self, tmp_path):
        ref, path, _ = self._artifact(tmp_path)
        batcher = inference.DynamicBatcher(inference.Predictor(path),
                                           max_batch=16, max_delay_ms=30.0)
        rng = np.random.default_rng(3)
        good = [rng.standard_normal((1, 4)).astype(np.float32)
                for _ in range(6)]
        results, errors = [None] * 6, [None]

        def bad():
            try:
                batcher.infer([rng.standard_normal((1, 5)).astype(
                    np.float32)])
            except Exception as e:  # expected: wrong trailing shape
                errors[0] = e

        def req(i):
            results[i] = batcher.infer([good[i]])[0]

        threads = [threading.Thread(target=req, args=(i,))
                   for i in range(6)] + [threading.Thread(target=bad)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert errors[0] is not None  # the bad request fails...
        for i in range(6):            # ...and every good one succeeds
            np.testing.assert_allclose(
                results[i], ref(rp.to_tensor(good[i])).numpy(), **TOL)
        batcher.shutdown()

    def test_pad_rows_are_dropped(self, tmp_path):
        """3 rows pad to a bucket of 4 (the last row repeated); each
        request gets its own rows back."""
        ref, path, _ = self._artifact(tmp_path)
        pred = inference.Predictor(path)
        seen = []
        run = pred.run
        pred.run = lambda xs: seen.append(xs[0].shape[0]) or run(xs)
        batcher = inference.DynamicBatcher(pred, max_batch=8,
                                           max_delay_ms=1000.0)
        x = np.random.default_rng(4).standard_normal((3, 4)).astype(
            np.float32)
        out = batcher.infer([x])[0]
        assert seen == [4] and out.shape == (3, 2)
        np.testing.assert_allclose(out, ref(rp.to_tensor(x)).numpy(), **TOL)
        assert inference.DynamicBatcher._bucket(5, 32) == 8
        assert inference.DynamicBatcher._bucket(40, 32) == 40
        batcher.shutdown()
