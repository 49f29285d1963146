"""``static.nn``, the sequence ops and ``static``'s other names of the
PyTorch port against the JAX package's.

Mirrors ``tests/test_static_nn_parity.py`` but its distributed cases (the
dataset entries and ``ParallelMode`` are ROADMAP item 15): each
``static.nn`` layer function builds the same program in both packages,
the reference's parameter values are carried into the port's in program
order, and the fetches agree within float32's 1e-5 relative + 1e-6
absolute (a tolerance stated otherwise says why). The sequence ops run
eagerly on the same arrays. The refusals are tested by name: the
transposed and deformable convolutions (item 16) and a ZeRO optimizer in
the Executor (item 15).
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place

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


def _np(v):
    return np.asarray(v._value) if isinstance(v, rp.Tensor) else \
        v.detach().cpu().numpy()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype("float32")


def _both(build, feed, carry=True):
    """The fetches of ``build(pkg)`` (a list of variables) in each
    package, the reference's parameters carried into the port's."""
    progs = {}
    for pkg in (rp, tp):
        with static_mode(pkg):
            main = pkg.static.Program()
            with pkg.static.program_guard(main, pkg.static.Program()):
                fetches = build(pkg)
        progs[pkg] = (main, fetches)
    if carry:
        (rmain, _), (main, _) = progs[rp], progs[tp]
        assert len(rmain._params) == len(main._params)
        with torch.no_grad():
            for r, p in zip(rmain._params, main._params):
                p.copy_(torch.from_numpy(np.array(r._value)))
    out = {}
    for pkg, (main, fetches) in progs.items():
        with static_mode(pkg):
            out[pkg] = pkg.static.Executor().run(main, feed=feed,
                                                 fetch_list=fetches)
    return out[tp], out[rp], progs[tp][0]


def _close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).shape == np.asarray(w).shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


# ---- layer functions ----------------------------------------------------------

def test_conv_norm_stack():
    def build(pkg):
        x = pkg.static.data("x", [4, 1, 8, 8], "float32")
        h = pkg.static.nn.conv2d(x, 4, 3, padding=1, act="relu")
        h = pkg.static.nn.batch_norm(h)
        gn = pkg.static.nn.group_norm(h, 2)
        ln = pkg.static.nn.layer_norm(h)
        inorm = pkg.static.nn.instance_norm(h)
        pr = pkg.static.nn.prelu(h, mode="channel")
        out = pkg.static.nn.fc(h, 10)
        return [pkg.mean(out), gn, ln, inorm, pr]

    got, want, _ = _both(build, {"x": _rand(4, 1, 8, 8)})
    assert got[0].shape == ()
    _close(got, want, **TOL)


def test_conv3d():
    def build(pkg):
        x = pkg.static.data("x", [2, 1, 4, 4, 4], "float32")
        return [pkg.static.nn.conv3d(x, 3, 3, padding=1)]

    got, want, _ = _both(build, {"x": _rand(2, 1, 4, 4, 4)})
    assert got[0].shape == (2, 3, 4, 4, 4)
    _close(got, want, **TOL)


@pytest.mark.parametrize("fn", ["conv2d_transpose", "conv3d_transpose"])
def test_transposed_convolutions_are_refused(fn):
    with static_mode(tp), tp.static.program_guard(tp.static.Program()):
        x = tp.static.data("x", [2, 1, 4, 4, 4][:4 if "2d" in fn else 5],
                           "float32")
        with pytest.raises(NotImplementedError, match="item 16"):
            getattr(tp.static.nn, fn)(x, 2, filter_size=3, padding=1)


def test_deform_conv2d_is_refused():
    with static_mode(tp), tp.static.program_guard(tp.static.Program()):
        x = tp.static.data("x", [1, 2, 4, 4], "float32")
        with pytest.raises(NotImplementedError, match="item 16"):
            tp.static.nn.deform_conv2d(x, x, x, 2, 3)


def test_zero_optimizer_is_refused_by_the_executor():
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main, tp.static.Program()):
            x = tp.static.data("x", [2, 3], "float32")
            loss = tp.mean(tp.static.nn.fc(x, 1))
            opt = tp.optimizer.Adam(learning_rate=0.1)
            opt._shard_states_axis = "dp"
            opt.minimize(loss)
        with pytest.raises(NotImplementedError, match="item 15"):
            tp.static.Executor().run(main, feed={"x": _rand(2, 3)},
                                     fetch_list=[loss])


def test_bilinear_and_row_conv():
    def build(pkg):
        a = pkg.static.data("a", [3, 5], "float32")
        b = pkg.static.data("b", [3, 4], "float32")
        seq = pkg.static.data("s", [2, 7, 5], "float32")
        return [pkg.static.nn.bilinear_tensor_product(a, b, 6, act="tanh"),
                pkg.static.nn.row_conv(seq, 2)]

    got, want, _ = _both(build, {"a": _rand(3, 5, seed=1),
                                 "b": _rand(3, 4, seed=2),
                                 "s": _rand(2, 7, 5, seed=3)})
    assert got[0].shape == (3, 6) and got[1].shape == (2, 7, 5)
    _close(got, want)


def test_nce_and_crf():
    """nce's negatives are drawn when the program is built: the
    reference's are set to the port's."""
    from paddle_tpu.onnx.exporter import closure_attrs

    def build(pkg):
        x = pkg.static.data("x", [6, 8], "float32")
        lab = pkg.static.data("y", [6, 1], "int64")
        emis = pkg.static.data("e", [2, 5, 4], "float32")
        return [pkg.static.nn.nce(x, lab, num_total_classes=20),
                pkg.static.nn.crf_decoding(emis)]

    progs = {}
    for pkg in (rp, tp):
        with static_mode(pkg):
            main = pkg.static.Program()
            with pkg.static.program_guard(main):
                progs[pkg] = (main, build(pkg))
    port_nce = progs[tp][1][0]._node
    ref_nce = progs[rp][1][0]._node
    cells = dict(zip(ref_nce.fn.__code__.co_freevars, ref_nce.fn.__closure__))
    import jax.numpy as jnp
    cells["neg"].cell_contents = jnp.asarray(
        port_nce.kwargs["neg"].numpy().astype(np.int32))
    assert set(closure_attrs(ref_nce.fn)) >= {"neg"}
    rmain, main = progs[rp][0], progs[tp][0]
    rng = np.random.default_rng(0)
    trans = rng.standard_normal((4, 4)).astype("f4")
    with torch.no_grad():
        for r, p in zip(rmain._params, main._params):
            p.copy_(torch.from_numpy(np.array(r._value)))
        # the transition matrix starts at zeros in both: give it values
        main._params[-1].copy_(torch.from_numpy(trans))
    rmain._params[-1]._value = jnp.asarray(trans)
    feed = {"x": _rand(6, 8), "y": rng.integers(0, 20, (6, 1)),
            "e": rng.standard_normal((2, 5, 4)).astype("f4")}
    out = {}
    for pkg in (rp, tp):
        with static_mode(pkg):
            out[pkg] = pkg.static.Executor().run(
                progs[pkg][0], feed=feed, fetch_list=progs[pkg][1])
    got, want = out[tp], out[rp]
    assert got[0].shape == (6, 1) and (got[0] > 0).all()
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].shape == (2, 5)


def test_the_other_layer_functions():
    def build(pkg):
        x = pkg.static.data("x", [3, 2, 4], "float32")
        ids = pkg.static.data("ids", [3, 2], "int64")
        im = pkg.static.data("im", [2, 3, 4, 4], "float32")
        return [pkg.static.nn.fc(x, 5, num_flatten_dims=1,
                                 activation="relu"),
                pkg.static.nn.fc(x, 5, num_flatten_dims=2),
                pkg.static.nn.layer_norm(x, scale=False, shift=False,
                                         begin_norm_axis=2),
                pkg.static.nn.data_norm(pkg.reshape(x, [3, 8]), act="tanh"),
                pkg.static.nn.prelu(x, mode="all"),
                pkg.static.nn.prelu(pkg.reshape(x, [3, 8]), mode="element"),
                pkg.static.nn.instance_norm(x),
                pkg.static.nn.batch_norm(x, is_test=True),
                pkg.static.nn.sparse_embedding(ids, [7, 3]),
                pkg.static.nn.conv2d(im, 2, 3, stride=2, padding=1,
                                     groups=1, act="sigmoid")]

    got, want, _ = _both(build, {"x": _rand(3, 2, 4, seed=4),
                                 "ids": np.array([[1, 2], [3, 4], [5, 6]]),
                                 "im": _rand(2, 3, 4, 4, seed=5)})
    _close(got, want, **TOL)


def test_multi_box_head():
    def build(pkg):
        f1 = pkg.static.data("f1", [1, 4, 4, 4], "float32")
        f2 = pkg.static.data("f2", [1, 4, 2, 2], "float32")
        img = pkg.static.data("img", [1, 3, 16, 16], "float32")
        locs, confs, box, var = pkg.static.nn.multi_box_head(
            [f1, f2], img, base_size=16, num_classes=3,
            aspect_ratios=[[2.0], [2.0, 3.0]], min_ratio=20, max_ratio=90)
        return [locs, confs], box, var

    progs = {}
    for pkg in (rp, tp):
        with static_mode(pkg):
            main = pkg.static.Program()
            with pkg.static.program_guard(main):
                progs[pkg] = (main,) + build(pkg)
    (rmain, rf, rbox, rvar), (main, f, box, var) = progs[rp], progs[tp]
    np.testing.assert_array_equal(_np(box), _np(rbox))
    np.testing.assert_array_equal(_np(var), _np(rvar))
    with torch.no_grad():
        for r, p in zip(rmain._params, main._params):
            p.copy_(torch.from_numpy(np.array(r._value)))
    feed = {"f1": _rand(1, 4, 4, 4, seed=1), "f2": _rand(1, 4, 2, 2, seed=2),
            "img": _rand(1, 3, 16, 16, seed=3)}
    got = tp.static.Executor().run(main, feed=feed, fetch_list=f)
    with static_mode(rp):
        want = rp.static.Executor().run(rmain, feed=feed, fetch_list=rf)
    _close(got, want, **TOL)


def test_spectral_norm_and_py_func():
    """``spectral_norm`` runs the port's ``nn.SpectralNorm`` (the
    reference's imports a function its ``nn`` lacks, and raises)."""
    w = _rand(4, 6, seed=7)
    with static_mode(rp), rp.static.program_guard(rp.static.Program()):
        with pytest.raises(ImportError):
            rp.static.nn.spectral_norm(rp.static.data("w", [4, 6]))
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            wv = tp.static.data("w", [4, 6], "float32")
            sn = tp.static.nn.spectral_norm(wv, power_iters=2)
            doubled = tp.static.nn.py_func(lambda v: v * 2.0, wv, None)
        layer = main._layers[0]
        u, v = layer.weight_u.clone(), layer.weight_v.clone()
        got, dbl = tp.static.Executor().run(main, feed={"w": w},
                                            fetch_list=[sn, doubled])
    eager = tp.nn.SpectralNorm([4, 6], power_iters=2)
    eager.weight_u.copy_(u)
    eager.weight_v.copy_(v)
    np.testing.assert_allclose(got, _np(eager(torch.from_numpy(w))), **TOL)
    np.testing.assert_array_equal(dbl, 2 * w)


# ---- sequence ops (eager, as the reference's tests run them) -----------------

def _eager(name, *arrays, **kw):
    """``static.nn.<name>`` on the same arrays in both packages."""
    outs = []
    for pkg, wrap in ((rp, rp.to_tensor), (tp, lambda a: torch.as_tensor(a))):
        args = [wrap(a) if isinstance(a, np.ndarray) else a for a in arrays]
        kwargs = {k: (wrap(v) if isinstance(v, np.ndarray) else v)
                  for k, v in kw.items()}
        outs.append(getattr(pkg.static.nn, name)(*args, **kwargs))
    return outs


def _same(ref, port, exact=False):
    refs = ref if isinstance(ref, (tuple, list)) else [ref]
    ports = port if isinstance(port, (tuple, list)) else [port]
    for r, p in zip(refs, ports):
        if exact:
            np.testing.assert_array_equal(_np(p), _np(r))
        else:
            np.testing.assert_allclose(_np(p), _np(r), **TOL)


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "last",
                                  "first"])
def test_sequence_pool(pool):
    x = _rand(3, 5, 4, seed=1)
    lens = np.array([2, 5, 3], np.int32)
    _same(*_eager("sequence_pool", x, pool, lens))
    _same(*_eager("sequence_pool", x, pool))


def test_first_last_softmax_reverse():
    x = _rand(2, 4, 3, seed=2)
    lens = np.array([2, 4], np.int32)
    _same(*_eager("sequence_first_step", x))
    _same(*_eager("sequence_last_step", x, lens))
    ref, port = _eager("sequence_softmax", x, lens)
    _same(ref, port)
    assert _np(port)[0, 2:].max() < 1e-6
    _same(*_eager("sequence_reverse", x, lens), exact=True)
    _same(*_eager("sequence_reverse", x), exact=True)


def test_pad_unpad_concat_reshape():
    x = _rand(2, 3, 4, seed=3)
    ref, port = _eager("sequence_pad", x, 0.0, maxlen=5)
    _same(ref, port, exact=True)
    assert list(port[0].shape) == [2, 5, 4]
    assert list(_np(port[1])) == [3, 3]
    lens = np.array([3, 2], np.int32)
    ref, port = _eager("sequence_unpad", _np(port[0]), lens)
    _same(ref, port, exact=True)
    assert list(port.shape) == [2, 3, 4]
    outs = []
    for pkg, wrap in ((rp, rp.to_tensor), (tp, torch.as_tensor)):
        outs.append(pkg.static.nn.sequence_concat([wrap(x), wrap(x)]))
    _same(*outs, exact=True)
    _same(*_eager("sequence_reshape", x, 2), exact=True)


def test_enumerate_slice_scatter_expand():
    ids = np.arange(8).reshape(2, 4)
    _same(*_eager("sequence_enumerate", ids, 2), exact=True)
    x = _rand(2, 4, 3, seed=4)
    _same(*_eager("sequence_slice", x, np.array([1, 0], np.int32),
                  np.array([2, 3], np.int32)))
    _same(*_eager("sequence_scatter", np.zeros((2, 6), np.float32),
                  np.array([[0, 2], [1, 3]], np.int32),
                  np.ones((2, 2), np.float32)), exact=True)
    _same(*_eager("sequence_expand", np.ones((2, 3), np.float32),
                  np.zeros((2, 5, 3), np.float32)), exact=True)
    _same(*_eager("sequence_expand_as", _rand(2, 1, 3, seed=5),
                  np.zeros((2, 4, 3), np.float32)), exact=True)


def test_sequence_conv():
    """Its weight is drawn from each package's generator: the port's
    output against the reference's formula run on the port's weight."""
    x = _rand(2, 6, 4, seed=6)
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            xv = tp.static.data("x", [2, 6, 4], "float32")
            out = tp.static.nn.sequence_conv(xv, 8, 3, act="relu")
        got, = tp.static.Executor().run(main, feed={"x": x},
                                        fetch_list=[out])
    assert got.shape == (2, 6, 8)
    with static_mode(rp):
        rmain = rp.static.Program()
        with rp.static.program_guard(rmain):
            rxv = rp.static.data("x", [2, 6, 4], "float32")
            rout = rp.static.nn.sequence_conv(rxv, 8, 3, act="relu")
        for r, p in zip(rmain._params, main._params):
            r._value = rp.to_tensor(_np(p))._value
        want, = rp.static.Executor().run(rmain, feed={"x": x},
                                         fetch_list=[rout])
    np.testing.assert_allclose(got, want, **TOL)


def test_sequence_erase():
    x = np.array([[2, 1, 3, 1, 5, 0], [1, 1, 2, 9, 0, 0]], np.int64)
    lens = np.array([5, 4], np.int32)
    for tokens in ([1], [1, 2]):
        ref, port = _eager("sequence_erase", x, tokens, length=lens)
        _same(ref, port, exact=True)
    np.testing.assert_array_equal(_np(port[1]), [2, 1])


def test_sequence_topk_avg_pooling():
    x = np.random.default_rng(0).normal(0, 1, (2, 3, 4, 6)).astype("f4")
    col = np.array([6, 4], np.int32)
    ref, port = _eager("sequence_topk_avg_pooling", x, [1, 3], col=col)
    assert tuple(port.shape) == (2, 4, 6)
    _same(ref, port)
    _same(*_eager("sequence_topk_avg_pooling", x, [2]))


# ---- static's other names -----------------------------------------------------

def test_program_state_roundtrip(tmp_path):
    with static_mode(tp):
        prog, start = tp.static.Program(), tp.static.Program()
        with tp.static.program_guard(prog, start):
            x = tp.static.data("x", [2, 4], "float32")
            tp.static.nn.fc(x, 3)
        tp.static.Executor().run(start)
    params = prog.all_parameters()
    before = [_np(p).copy() for p in params]
    path = str(tmp_path / "model")
    tp.static.save(prog, path)
    st = tp.static.load_program_state(path)
    assert sorted(st) == ["param_0", "param_1"]
    with torch.no_grad():
        for p in params:
            p.zero_()
    tp.static.set_program_state(prog, st)
    for p, b in zip(params, before):
        np.testing.assert_array_equal(_np(p), b)
    blob = tp.static.serialize_persistables(program=prog)
    tp.static.deserialize_persistables(prog, blob)
    f = str(tmp_path / "blob.bin")
    tp.static.save_to_file(f, blob)
    assert tp.static.load_from_file(f) == blob
    assert tp.static.deserialize_program(
        tp.static.serialize_program(program=prog))["datas"] == ["x"]
    # a bfloat16 parameter is the uint16 record, and loads back bit for bit
    with torch.no_grad():
        params[0].data = params[0].data.to(torch.bfloat16)
    bits = params[0].detach().clone()
    tp.static.save(prog, path)
    assert tp.static.load_program_state(path)["param_0"]["dtype"] == \
        "bfloat16"
    with torch.no_grad():
        params[0].zero_()
    tp.static.load(prog, path)
    assert torch.equal(params[0].view(torch.int16), bits.view(torch.int16))


def test_strategies_and_places():
    bs = tp.static.BuildStrategy()
    bs.reduce_strategy = tp.static.BuildStrategy.ReduceStrategy.Reduce
    assert bs.reduce_strategy == rp.static.BuildStrategy.ReduceStrategy.Reduce
    es = tp.static.ExecutionStrategy()
    es.num_threads = 4
    assert len(tp.static.cpu_places(3)) == 3
    assert len(tp.static.cuda_places()) == torch.cuda.device_count()
    assert tp.static.npu_places() == [] and tp.static.xpu_places() == []
    assert tp.static.WeightNormParamAttr(dim=0, name="wn").dim == 0
    assert isinstance(tp.static.CompiledProgram(tp.static.Program(), bs),
                      tp.static.CompiledProgram)
    with pytest.raises(RuntimeError):
        tp.static.IpuCompiledProgram()
    with tp.static.name_scope("block"), tp.static.ipu_shard_guard():
        pass


def test_ema_apply_restore():
    p = tp.static.create_parameter([2, 2], "float32", name="ema_p")
    rpar = rp.static.create_parameter([2, 2], "float32", name="ema_p")
    with torch.no_grad():
        p.copy_(torch.from_numpy(np.array(rpar._value)))
    inside = {}
    for pkg, par in ((rp, rpar), (tp, p)):
        ema = pkg.static.ExponentialMovingAverage(0.5)
        prog = pkg.static.default_main_program()
        ema.update()
        if pkg is rp:
            par._value = par._value + 100.0
        else:
            with torch.no_grad():
                par.add_(100.0)
        ema.update()
        with ema.apply():
            inside[pkg] = _np(par).copy()
        assert par in prog.all_parameters()
    np.testing.assert_allclose(inside[tp], inside[rp], **TOL)
    np.testing.assert_allclose(_np(p), _np(rpar), **TOL)


def test_accuracy_auc_print(capsys):
    logits = np.array([[9.0, 1.0], [1.0, 9.0], [2.0, 3.0]], np.float32)
    lab = np.array([[0], [1], [0]])
    got = tp.static.accuracy(torch.from_numpy(logits), torch.from_numpy(lab))
    want = rp.static.accuracy(rp.to_tensor(logits), rp.to_tensor(lab))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    probs = np.array([0.1, 0.8, 0.6, 0.3], np.float32)
    labels = np.array([0, 1, 1, 0])
    np.testing.assert_allclose(
        _np(tp.static.auc(torch.from_numpy(probs), labels)[0]),
        _np(rp.static.auc(rp.to_tensor(probs), rp.to_tensor(labels))[0]),
        **TOL)
    out = tp.static.Print(torch.ones(2), message="test")
    assert tuple(out.shape) == (2,) and "test" in capsys.readouterr().out


def test_device_guard_and_global_var():
    with tp.static.device_guard("cpu"):
        t = tp.ones([2])
    assert tuple(t.shape) == (2,) and t.device.type == "cpu"
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [2], "float32")
            with tp.static.device_guard("cpu"):
                y = tp.exp(x)
            g = tp.static.create_global_var([2], 3.0, "float32", name="g")
            z = y * g
        assert y._node.device == torch.device("cpu")
        assert z._node.device is None and g in main.all_parameters()
        out, = tp.static.Executor().run(main, feed={"x": np.zeros(2, "f4")},
                                        fetch_list=[z])
    np.testing.assert_array_equal(out, [3.0, 3.0])


def test_parallel_executor_and_normalize_program():
    with static_mode(tp):
        main = tp.static.Program()
        with tp.static.program_guard(main):
            x = tp.static.data("x", [2, 2], "float32")
            y = x + 1.0
        pe = tp.static.ParallelExecutor(main_program=main)
        out, = pe.run(fetch_list=[y], feed={"x": np.zeros((2, 2), "f4")})
        np.testing.assert_array_equal(out, np.ones((2, 2)))
        clone = tp.static.normalize_program(main, [x], [y])
        assert clone.id != main.id and clone._opts == []
    assert os.path.basename(tp.static.io.__file__) == "io.py"
