"""Static-graph mode of the PyTorch port against the JAX package's:
capture, ``Executor``, ``minimize``, gradients, passes, inference export
and hapi's ``StaticGraphAdapter``.

Each case builds the same program in both packages (``enable_static``,
``static.data``, the network), carries the reference's parameter values
into the port's (in program order, or by ``paddle.save`` /
``set_state_dict`` for a network), feeds the same seeded numpy arrays and
holds the port's fetches to the reference's within float32's 1e-5
relative + 1e-6 absolute. The cases mirror ``tests/test_static.py`` and
the static cases of ``tests/test_runtime_fillers.py``, and add:

* SGD and AdamW ``minimize`` over 3 steps (the parameters after each);
* ``op_stats`` of one program, equal across the packages;
* a 2-layer ``TransformerEncoder`` classifier fed batches of 2 and 3
  through one ``[-1, S]`` port program. The reference's capture of
  self-attention over a -1 batch raises (two -1 in one reshape: a trap
  the port does not copy), so its programs are built at each batch;
* the flash gate's shape (S=256, head_dim 64): the captured
  ``scaled_dot_product_attention`` replays ``flash_attention`` (its plain
  version on the CPU; the reference's Pallas kernel in interpret mode);
* ``save_inference_model`` -> ``load_inference_model`` and
  ``inference.Predictor`` at two batch sizes;
* a ``.pdparams`` written by the reference's ``static.save``, loaded by
  the port's ``static.load``;
* ``Model`` in static mode (``StaticGraphAdapter``): ``fit`` /
  ``evaluate`` / ``predict`` against the reference's static ``Model``;
* no fallback: ``Executor()`` on a default device of ``cuda`` without a
  card raises, and a replayed op that fails raises.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place
from paddle_tpu_torch.nn.functional import attention as port_attention

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev
    for pkg in (rp, tp):
        pkg.disable_static()


@contextlib.contextmanager
def static_mode(pkg):
    pkg.enable_static()
    try:
        yield
    finally:
        pkg.disable_static()


def _both(build):
    """``build(pkg)`` -> (main, startup, handles) in static mode, for each
    package; the reference's parameter values carried into the port's."""
    out = {}
    for pkg in (rp, tp):
        with static_mode(pkg):
            main, startup = pkg.static.Program(), pkg.static.Program()
            with pkg.static.program_guard(main, startup):
                handles = build(pkg)
        out[pkg] = (main, startup, handles)
    _carry(out[rp][0], out[tp][0])
    return out[rp], out[tp]


def _carry(ref_prog, port_prog):
    assert len(ref_prog._params) == len(port_prog._params)
    with torch.no_grad():
        for r, p in zip(ref_prog._params, port_prog._params):
            assert tuple(r._value.shape) == tuple(p.shape)
            p.copy_(torch.from_numpy(np.array(r._value)))


def _np(v):
    return np.asarray(v._value) if isinstance(v, rp.Tensor) else \
        v.detach().cpu().numpy()


def _run(pkg, prog, feed, fetch):
    with static_mode(pkg):
        return pkg.static.Executor().run(prog, feed=feed, fetch_list=fetch)


def _close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype("float32")


# ---- capture ------------------------------------------------------------------

def test_data_and_shapes():
    def build(pkg):
        x = pkg.static.data("x", [-1, 4], "float32")
        y = x * 2.0 + 1.0
        return x, y, pkg.sum(y, axis=1)

    (_, _, (rx, ry, rr)), (main, _, (x, y, r)) = _both(build)
    assert x.shape == [-1, 4] == rx.shape and list(x.shape) == [-1, 4]
    assert y.shape == [-1, 4] == ry.shape and y.dtype == torch.float32
    assert r.shape == [-1] == rr.shape
    assert main.var("x") is x and main.has_var("x")


def test_static_var_has_no_value():
    with static_mode(tp), tp.static.program_guard(tp.static.Program()):
        x = tp.static.data("x", [2, 2], "float32")
        for read in (x.numpy, x.item, lambda: bool(x), lambda: float(x)):
            with pytest.raises(RuntimeError, match="symbolic"):
                read()
        # a captured op makes a new variable: in place, or backward(),
        # would change nothing, and raises
        with pytest.raises(RuntimeError, match="in-place 'add_'"):
            x.add_(1.0)
        with pytest.raises(RuntimeError, match="append_backward"):
            tp.sum(x).backward()
    with static_mode(rp), rp.static.program_guard(rp.static.Program()):
        with pytest.raises(RuntimeError):
            rp.static.data("x", [2, 2], "float32").numpy()


def test_program_repr_and_vars():
    def build(pkg):
        x = pkg.static.data("x", [2, 3], "float32")
        return x, pkg.static.nn.fc(x, 5)

    (rmain, _, (_, rh)), (main, _, (x, h)) = _both(build)
    assert main.has_var("x") and main.var("x") is x
    assert len(main.all_parameters()) == len(rmain.all_parameters()) == 2
    assert h.shape == [2, 5] == rh.shape
    assert "params=2" in repr(main)


# ---- executor -----------------------------------------------------------------

def test_forward_matches_the_reference():
    def build(pkg):
        x = pkg.static.data("x", [-1, 3], "float32")
        return pkg.static.nn.fc(x, 2)

    (rmain, rstart, rh), (main, start, h) = _both(build)
    xs = _rand(5, 3)
    _close(_run(tp, main, {"x": xs}, [h]), _run(rp, rmain, {"x": xs}, [rh]))
    W, b = (_np(p) for p in main._params)
    np.testing.assert_allclose(_run(tp, main, {"x": xs}, [h])[0],
                               xs @ W + b, **TOL)


def test_one_build_per_batch_size():
    with static_mode(tp), tp.static.program_guard(tp.static.Program()):
        x = tp.static.data("x", [-1, 4], "float32")
        s = tp.sum(x)
        exe = tp.static.Executor()
        for bs in (2, 7, 2):
            sv, = exe.run(feed={"x": np.ones((bs, 4), "float32")},
                          fetch_list=[s])
            assert float(sv) == pytest.approx(bs * 4.0)
    assert len(exe._cache) == 2


def test_fetch_by_name_and_tensor():
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [2, 2], "float32")
            y = x + 1.0
        a, b = tp.static.Executor().run(
            main, feed={"x": np.zeros((2, 2), "float32")},
            fetch_list=[y, y.name])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, np.ones((2, 2), "float32"))


def test_bad_feed_key_and_unfed_slot_raise():
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [2, 2], "float32")
            z = tp.static.data("z", [2, 2], "float32")
            y = x + z
        exe = tp.static.Executor()
        with pytest.raises(KeyError):
            exe.run(main, feed={"nope": np.zeros((2, 2), "f4")},
                    fetch_list=[y])
        with pytest.raises(RuntimeError, match="'z' was not fed"):
            exe.run(main, feed={"x": np.zeros((2, 2), "f4")},
                    fetch_list=[y])


def test_no_fallback():
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [2, 3], "float32")
            h = tp.static.nn.fc(x, 2)
        # a replayed op that fails raises (a feed of the wrong width)
        with pytest.raises(RuntimeError):
            tp.static.Executor().run(main, feed={"x": np.ones((2, 4), "f4")},
                                     fetch_list=[h])
        if not torch.cuda.is_available():
            place._default = torch.device("cuda")
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tp.static.Executor()


# ---- training -----------------------------------------------------------------

def test_sgd_minimize_converges_as_the_reference():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(4, 1)).astype("float32")
    xs = rng.normal(size=(64, 4)).astype("float32")
    ys = xs @ W

    def build(pkg):
        x = pkg.static.data("x", [-1, 4], "float32")
        y = pkg.static.data("y", [-1, 1], "float32")
        pred = pkg.static.nn.fc(x, 1)
        loss = pkg.mean((pred - y) ** 2)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    losses = {}
    for pkg, (main, start, loss) in zip((rp, tp), _both(build)):
        with static_mode(pkg):
            exe = pkg.static.Executor()
            exe.run(start)
            losses[pkg] = [float(exe.run(main, feed={"x": xs, "y": ys},
                                         fetch_list=[loss])[0])
                           for _ in range(30)]
    np.testing.assert_allclose(losses[tp], losses[rp], **TOL)
    assert losses[tp][-1] < losses[tp][0] * 0.01


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_minimize_three_steps_against_the_reference(opt):
    xs, ys = _rand(6, 3, seed=1), _rand(6, 2, seed=2)

    def build(pkg):
        x = pkg.static.data("x", [-1, 3], "float32")
        y = pkg.static.data("y", [-1, 2], "float32")
        h = pkg.static.nn.fc(x, 4, activation="tanh")
        loss = pkg.mean((pkg.static.nn.fc(h, 2) - y) ** 2)
        kw = {"weight_decay": 0.01} if opt == "AdamW" else {}
        getattr(pkg.optimizer, opt)(learning_rate=0.05, **kw).minimize(loss)
        return loss

    (rmain, _, rloss), (main, _, loss) = _both(build)
    for _ in range(3):
        got = _run(tp, main, {"x": xs, "y": ys}, [loss])
        want = _run(rp, rmain, {"x": xs, "y": ys}, [rloss])
        _close(got, want)
        _close([_np(p) for p in main._params],
               [_np(p) for p in rmain._params])


def test_static_matches_eager_training():
    """One Adam step on the same weights: the port's static program, the
    port's eager step and the reference's static program."""
    W0, xs, ys = _rand(3, 2, seed=3), _rand(6, 3, seed=4), _rand(6, 2, seed=5)

    def build(pkg):
        x = pkg.static.data("x", [6, 3], "float32")
        y = pkg.static.data("y", [6, 2], "float32")
        lin = pkg.nn.Linear(3, 2, bias_attr=False)
        lin.weight.set_value(W0)
        loss = pkg.mean((lin(x) - y) ** 2)
        pkg.optimizer.Adam(learning_rate=0.01,
                           parameters=lin.parameters()).minimize(loss)
        return loss, lin

    (rmain, _, (rloss, rlin)), (main, _, (loss, lin)) = _both(build)
    lv, = _run(tp, main, {"x": xs, "y": ys}, [loss])
    rlv, = _run(rp, rmain, {"x": xs, "y": ys}, [rloss])
    lin2 = tp.nn.Linear(3, 2, bias_attr=False)
    lin2.weight.set_value(W0)
    opt2 = tp.optimizer.Adam(learning_rate=0.01, parameters=lin2.parameters())
    loss2 = tp.mean((lin2(torch.from_numpy(xs)) - torch.from_numpy(ys)) ** 2)
    loss2.backward()
    opt2.step()
    np.testing.assert_allclose(lv, float(loss2.detach()), **TOL)
    np.testing.assert_allclose(lv, rlv, **TOL)
    np.testing.assert_allclose(_np(lin.weight), _np(lin2.weight), **TOL)
    np.testing.assert_allclose(_np(lin.weight), _np(rlin.weight), **TOL)


def test_startup_reinitializes():
    with static_mode(tp):
        main, start = tp.static.Program(), tp.static.Program()
        with tp.static.program_guard(main, start):
            x = tp.static.data("x", [4, 2], "float32")
            loss = tp.mean(tp.static.nn.fc(x, 1) ** 2)
            tp.optimizer.SGD(learning_rate=0.5).minimize(loss)
        exe = tp.static.Executor()
        exe.run(start)
        p = main._params[0]
        w_init = _np(p).copy()
        exe.run(main, feed={"x": _rand(4, 2)}, fetch_list=[loss])
        assert not np.allclose(_np(p), w_init)
        exe.run(start)  # restore
        np.testing.assert_array_equal(_np(p), w_init)


# ---- gradients ----------------------------------------------------------------

def test_append_backward_and_gradients_against_the_reference():
    def build(pkg):
        x = pkg.static.data("x", [8, 3], "float32")
        h = pkg.static.nn.fc(x, 2)
        loss = pkg.sum(h * h)
        (_, gw), (_, gb) = pkg.static.append_backward(loss)
        gx, = pkg.static.gradients(loss, [x])
        return loss, gw, gb, gx

    (rmain, _, rf), (main, _, f) = _both(build)
    xs = _rand(8, 3, seed=1)
    got = _run(tp, main, {"x": xs}, list(f))
    _close(got, _run(rp, rmain, {"x": xs}, list(rf)), **TOL)
    W, b = (_np(p) for p in main._params)
    # and the closed forms, at tests/test_static.py's own tolerance
    np.testing.assert_allclose(got[1], 2 * xs.T @ (xs @ W + b), atol=1e-4)
    np.testing.assert_allclose(got[3], 2 * (xs @ W + b) @ W.T, atol=1e-4)


def test_gradients_wrt_data_only():
    def build(pkg):
        x = pkg.static.data("x", [8, 3], "float32")
        loss = pkg.sum(pkg.static.nn.fc(x, 2) ** 2)
        return pkg.static.gradients(loss, [x])[0]

    (rmain, _, rgx), (main, _, gx) = _both(build)
    xs = _rand(8, 3, seed=1)
    _close(_run(tp, main, {"x": xs}, [gx]), _run(rp, rmain, {"x": xs}, [rgx]),
           **TOL)


# ---- inference io -------------------------------------------------------------

def _fc_program(pkg, shape):
    x = pkg.static.data("x", shape, "float32")
    return x, pkg.static.nn.fc(x, 2)


def test_save_load_inference_model(tmp_path):
    (rmain, _, (rx, rh)), (main, _, (x, h)) = _both(
        lambda pkg: _fc_program(pkg, [4, 3]))
    for pkg, prog, xv, hv, d in ((rp, rmain, rx, rh, "ref"),
                                 (tp, main, x, h, "port")):
        with static_mode(pkg):
            pkg.static.save_inference_model(
                str(tmp_path / d / "m"), [xv], [hv], program=prog)
    assert sorted(os.listdir(tmp_path / "port")) == [
        "m.pdexport", "m.pdiparams", "m.pdmeta", "m.pdmodel"]
    layer, feeds, fetches = tp.static.load_inference_model(
        str(tmp_path / "port" / "m"))
    rlayer, rfeeds, _ = rp.static.load_inference_model(
        str(tmp_path / "ref" / "m"))
    assert feeds == rfeeds == ["x"] and fetches == [h.name]
    xs = _rand(4, 3)
    out = layer(xs)
    rout = rlayer(xs)
    np.testing.assert_allclose(_np(out[0]), _np(rout[0]), **TOL)


def test_dynamic_batch_export_serves_the_predictor(tmp_path):
    (rmain, _, (rx, rh)), (main, _, (x, h)) = _both(
        lambda pkg: _fc_program(pkg, [-1, 3]))
    with static_mode(tp):
        tp.static.save_inference_model(str(tmp_path / "poly"), [x], [h],
                                       program=main)
    cfg = tp.inference.Config(str(tmp_path / "poly"))
    cfg.disable_gpu()
    pred = tp.inference.create_predictor(cfg)
    layer, _, _ = tp.static.load_inference_model(str(tmp_path / "poly"))
    for n in (1, 4, 7):
        xs = _rand(n, 3, seed=n)
        want, = _run(rp, rmain, {"x": xs}, [rh])
        np.testing.assert_allclose(pred.run([xs])[0], want, **TOL)
        np.testing.assert_allclose(_np(layer(xs)[0]), want, **TOL)


def test_reference_pdparams_load_into_the_port(tmp_path):
    """The reference's ``static.save``, the port's ``static.load`` by the
    parameters' names: the reference's fetches."""
    def build(pkg):
        x = pkg.static.data("x", [-1, 3], "float32")
        return pkg.static.nn.fc(pkg.static.nn.fc(x, 4, activation="relu"), 2)

    (rmain, _, rh), (main, _, h) = _both(build)
    with torch.no_grad():
        for rpar, ppar in zip(rmain._params, main._params):
            ppar.param_name = rpar.name   # the same names, other values
            ppar.zero_()
    path = str(tmp_path / "ref_model")
    rp.static.save(rmain, path)
    tp.static.load(main, path)
    xs = _rand(5, 3)
    _close(_run(tp, main, {"x": xs}, [h]), _run(rp, rmain, {"x": xs}, [rh]))
    # and the port's own round trip through serialize / deserialize
    blob = tp.static.serialize_persistables(program=main)
    with torch.no_grad():
        for ppar in main._params:
            ppar.zero_()
    tp.static.deserialize_persistables(main, blob)
    _close(_run(tp, main, {"x": xs}, [h]), _run(rp, rmain, {"x": xs}, [rh]))


# ---- static.nn / mode ---------------------------------------------------------

def test_conv_bn_pipeline():
    def build(pkg):
        im = pkg.static.data("im", [-1, 3, 8, 8], "float32")
        c = pkg.static.nn.conv2d(im, 4, 3, padding=1, act="relu")
        return c, pkg.mean(pkg.static.nn.batch_norm(c))

    (rmain, _, rf), (main, _, f) = _both(build)
    ims = _rand(2, 3, 8, 8, seed=2)
    _close(_run(tp, main, {"im": ims}, list(f)),
           _run(rp, rmain, {"im": ims}, list(rf)), **TOL)


def test_embedding():
    def build(pkg):
        ids = pkg.static.data("ids", [-1, 5], "int64")
        return pkg.static.nn.embedding(ids, size=[10, 4])

    (rmain, _, remb), (main, _, emb) = _both(build)
    idv = np.array([[1, 2, 3, 4, 5]], dtype=np.int64)
    ev, = _run(tp, main, {"ids": idv}, [emb])
    _close([ev], _run(rp, rmain, {"ids": idv}, [remb]))
    np.testing.assert_array_equal(ev[0], _np(main._params[0])[idv[0]])


def test_mode_flags():
    assert tp.in_dynamic_mode() and not tp.static.in_static_mode()
    tp.enable_static()
    try:
        assert not tp.in_dynamic_mode() and tp.static.in_static_mode()
    finally:
        tp.disable_static()
    assert tp.in_dynamic_mode()


# ---- passes -------------------------------------------------------------------

def test_dce():
    for pkg in (rp, tp):
        with static_mode(pkg):
            prog = pkg.static.Program()
            with pkg.static.program_guard(prog, pkg.static.Program()):
                x = pkg.static.data("x", [2, 2], "float32")
                live = pkg.add(x, x)
                pkg.exp(pkg.multiply(x, x))   # never fetched
            n_before = len(prog._vars)
            assert pkg.static.apply_pass(prog, "dead_code_elimination",
                                         fetch_vars=[live]) == 2
            assert len(prog._vars) == n_before - 2
            out = pkg.static.Executor().run(
                prog, feed={"x": np.ones((2, 2), np.float32)},
                fetch_list=[live])
            np.testing.assert_allclose(out[0], 2 * np.ones((2, 2)))


def test_capture_folds_pure_constants():
    with static_mode(tp):
        prog = tp.static.Program()
        with tp.static.program_guard(prog, tp.static.Program()):
            c = tp.ones([2])
            folded = tp.exp(tp.add(c, c))
        assert prog._n_ops == 0
        assert not isinstance(folded, tp.static.StaticVar)
        np.testing.assert_allclose(_np(folded), np.exp(2.0) * np.ones(2),
                                   rtol=1e-6)


def test_constant_folding_after_freeze():
    from paddle_tpu_torch.static.passes import freeze_feed
    with static_mode(tp):
        prog = tp.static.Program()
        with tp.static.program_guard(prog, tp.static.Program()):
            x = tp.static.data("x", [2], "float32")
            y = tp.static.data("y", [2], "float32")
            frozen_branch = tp.exp(tp.add(x, x))
            out = tp.add(y, frozen_branch)
        freeze_feed(x, np.ones(2, np.float32))
        assert tp.static.apply_pass(prog, "constant_folding") >= 2
        assert getattr(frozen_branch, "_const_value", None) is not None
        # runs WITHOUT feeding x: its subtree is now constant
        res = tp.static.Executor().run(
            prog, feed={"y": np.zeros(2, np.float32)}, fetch_list=[out])
    np.testing.assert_allclose(res[0], np.exp(2.0) * np.ones(2), rtol=1e-6)


def test_op_stats_and_registry():
    with static_mode(tp):
        prog = tp.static.Program()
        with tp.static.program_guard(prog, tp.static.Program()):
            x = tp.static.data("x", [2], "float32")
            tp.add(tp.add(x, x), x)
        assert tp.static.apply_pass(prog, "op_stats").get("add") == 2
        with pytest.raises(KeyError):
            tp.static.apply_pass(prog, "not_a_pass")

        @tp.static.register_pass("custom_noop")
        def custom(prog):
            return "ran"
        assert tp.static.apply_pass(prog, "custom_noop") == "ran"
        stats = tp.static.passes.apply_build_strategy(prog, fetch_vars=[x])
    assert set(stats) == {"dead_ops_removed", "ops_folded"}


def _classifier(pkg, d, heads, layers, vocab=50, classes=3):
    nn = pkg.nn

    class Classifier(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, d)
            layer = nn.TransformerEncoderLayer(d, heads, 2 * d, dropout=0.0)
            self.encoder = nn.TransformerEncoder(layer, layers)
            self.head = nn.Linear(d, classes)

        def forward(self, ids):
            return self.head(pkg.mean(self.encoder(self.embed(ids)), axis=1))

    return Classifier()


def _twin_classifiers(tmp_path, d, heads, layers):
    rp.seed(0)
    ref_net = _classifier(rp, d, heads, layers)
    rp.save(ref_net.state_dict(), str(tmp_path / "init.pdparams"))
    port_net = _classifier(tp, d, heads, layers)
    assert port_net.set_state_dict(
        tp.load(str(tmp_path / "init.pdparams"))) == ([], [])
    return ref_net, port_net


def _encoder_program(pkg, net, batch, S):
    with static_mode(pkg):
        main, start = pkg.static.Program(), pkg.static.Program()
        with pkg.static.program_guard(main, start):
            ids = pkg.static.data("ids", [batch, S], "int64")
            logits = net(ids)
            label = pkg.static.data("label", [batch, 1], "int64")
            loss = pkg.nn.CrossEntropyLoss()(logits, label)
            gx = pkg.static.append_backward(loss)[0][1]
    return main, logits, loss, gx


def test_dynamic_batch_flows_into_reshape(tmp_path):
    """One ``[-1, S]`` port program at batches 2 and 3 against reference
    programs built at each batch; ``op_stats`` equal across the
    packages."""
    S = 8
    ref_net, port_net = _twin_classifiers(tmp_path, 64, 2, 2)
    main, logits, loss, gw = _encoder_program(tp, port_net, -1, S)
    assert logits.shape == [-1, 3]
    with static_mode(rp), rp.static.program_guard(rp.static.Program()):
        with pytest.raises(TypeError, match="one unknown axis"):
            ref_net(rp.static.data("ids", [-1, S], "int64"))
    with static_mode(tp):
        exe = tp.static.Executor()
        for batch in (2, 3):
            rng = np.random.default_rng(batch)
            feed = {"ids": rng.integers(0, 50, (batch, S)),
                    "label": rng.integers(0, 3, (batch, 1))}
            got = exe.run(main, feed=feed, fetch_list=[logits, loss, gw])
            rmain, rlogits, rloss, rgw = _encoder_program(rp, ref_net, batch,
                                                          S)
            want = _run(rp, rmain, feed, [rlogits, rloss, rgw])
            _close(got, want, **TOL)
    assert tp.static.apply_pass(main, "op_stats") == \
        rp.static.apply_pass(rmain, "op_stats")


def test_flash_gate_replays_flash_attention(tmp_path, monkeypatch):
    """S=256, head_dim 64: each layer's captured op replays
    ``flash_attention`` (the plain version here), against the reference's
    Pallas kernel."""
    S = 256
    # one head of 64 (the parameter shapes of the test above: the
    # reference's initializers are compiled once)
    ref_net, port_net = _twin_classifiers(tmp_path, 64, 1, 2)
    ref_net.eval()
    port_net.eval()
    calls = []
    real = port_attention.flash_attention

    def spy(*a, **k):
        calls.append((type(a[0]).__name__, tuple(a[0].shape)))
        return real(*a, **k)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    progs = {}
    for pkg, net in ((rp, ref_net), (tp, port_net)):
        with static_mode(pkg):
            main = pkg.static.Program()
            with pkg.static.program_guard(main):
                ids = pkg.static.data("ids", [1, S], "int64")
                progs[pkg] = (main, net(ids))
    # the capture infers shapes on fake tensors; the replay runs the op
    assert calls == [("FakeTensor", (1, 1, S, 64))] * 2
    feed = {"ids": np.random.default_rng(0).integers(0, 50, (1, S))}
    got = _run(tp, progs[tp][0], feed, [progs[tp][1]])
    assert calls[2:] == [("Tensor", (1, 1, S, 64))] * 2
    _close(got, _run(rp, progs[rp][0], feed, [progs[rp][1]]),
           **TOL)


def test_train_from_dataset():
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((8, 1)).astype("f4")
    feats = rng.standard_normal((16, 4, 8)).astype("f4")
    batches = [(f, f @ w_true) for f in feats]

    def build(pkg):
        x = pkg.static.data("x", [4, 8], "float32")
        y = pkg.static.data("y", [4, 1], "float32")
        loss = pkg.mean(pkg.pow(pkg.static.nn.fc(x, 1) - y, 2.0))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    outs = {}
    for pkg, (main, start, loss) in zip((rp, tp), _both(build)):
        with static_mode(pkg):
            exe = pkg.static.Executor()
            exe.run(start)
            outs[pkg] = [exe.train_from_dataset(main, batches,
                                                fetch_list=[loss])[0]
                         for _ in range(5)]
    np.testing.assert_allclose(outs[tp], outs[rp], **TOL)
    assert outs[tp][-1] < 1.0


# ---- hapi's StaticGraphAdapter ------------------------------------------------

def _rows(pkg, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = rng.integers(0, 3, (n, 1))

    class Rows(pkg.io.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return n

    return Rows()


def test_static_model_fit_evaluate_predict_against_the_reference(tmp_path):
    results = {}
    rp.seed(0)
    ref_net = rp.nn.Sequential(rp.nn.Linear(6, 8), rp.nn.ReLU(),
                               rp.nn.Linear(8, 3))
    rp.save(ref_net.state_dict(), str(tmp_path / "mlp.pdparams"))
    port_net = tp.nn.Sequential(tp.nn.Linear(6, 8), tp.nn.ReLU(),
                                tp.nn.Linear(8, 3))
    port_net.set_state_dict(tp.load(str(tmp_path / "mlp.pdparams")))
    for pkg, net in ((rp, ref_net), (tp, port_net)):
        with static_mode(pkg):
            spec = pkg.static.InputSpec
            model = pkg.Model(net, inputs=[spec([-1, 6], "float32", "x")],
                              labels=[spec([-1, 1], "int64", "label")])
            assert model._adapter is not None
            opt = pkg.optimizer.AdamW(learning_rate=1e-2,
                                      parameters=net.parameters())
            model.prepare(opt, pkg.nn.CrossEntropyLoss(),
                          pkg.metric.Accuracy())
            steps = []

            class Record(pkg.callbacks.Callback):
                def on_train_batch_end(self, step, logs=None):
                    steps.append((logs["loss"], float(logs["acc"])))

            model.fit(_rows(pkg, 15, 1), batch_size=5, shuffle=False,
                      verbose=0, callbacks=[Record()])
            ev = model.evaluate(_rows(pkg, 10, 2), batch_size=5, verbose=0)
            pred = model.predict(_rows(pkg, 10, 2), batch_size=5,
                                 stack_outputs=True)[0]
        results[pkg] = (steps, ev, pred)
    (got_steps, got_ev, got_pred), (want_steps, want_ev, want_pred) = \
        results[tp], results[rp]
    assert len(got_steps) == len(want_steps) == 3
    np.testing.assert_allclose(np.asarray(got_steps), np.asarray(want_steps),
                               **TOL)
    np.testing.assert_allclose(got_ev["loss"], want_ev["loss"], **TOL)
    assert float(got_ev["acc"]) == float(want_ev["acc"])
    np.testing.assert_allclose(got_pred, np.asarray(want_pred), **TOL)


def test_reference_traps_the_port_keeps():
    """Kept as the reference has them (ROADMAP Queue 3), in both
    packages: a real extent equal to the probe extent (97) is reported
    as -1 after an op on a -1 input; ``clone(for_test=True)`` drops only
    the optimizer steps (a captured dropout stays in training mode);
    ``static.nn.prelu(mode="channel")`` reshapes its alpha eagerly, so
    the program holds no alpha parameter and ``minimize`` never moves
    it; ``Print`` reads a value, which a StaticVar has not."""
    for pkg in (rp, tp):
        with static_mode(pkg):
            main = pkg.static.Program()
            with pkg.static.program_guard(main):
                x = pkg.static.data("x", [-1, 97], "float32")
                y = x * 2.0
                assert list(y.shape) == [-1, -1]
                im = pkg.static.data("im", [2, 3, 4, 4], "float32")
                pkg.static.nn.prelu(im, mode="channel")
                assert main.all_parameters() == []
                d = pkg.nn.functional.dropout(y, p=0.5, training=True)
                loss = pkg.mean(d)
                pkg.optimizer.SGD(learning_rate=0.1,
                                  parameters=[]).minimize(loss)
                with pytest.raises(RuntimeError):
                    pkg.static.Print(x)
            test = main.clone(for_test=True)
            assert test._opts == [] and len(main._opts) == 1
            assert pkg.static.apply_pass(test, "op_stats")["dropout"] == 1
