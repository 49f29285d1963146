"""hapi's ``Model``, the callbacks, ``summary`` / ``flops`` and
``paddle.metric`` of the PyTorch port against the JAX package's:

* ``Model.fit`` / ``evaluate`` / ``predict`` on a 2-layer
  ``nn.TransformerEncoder`` classifier (d = 64, one head, S = 256, so the
  flash gate is taken: the port's ``flash_attention`` entry is reached,
  its plain version on the CPU; the reference's Pallas kernel in
  interpret mode) from the reference's weights, carried by the
  reference's ``paddle.save`` and the port's ``paddle.load``, with
  ``shuffle=False``: each step's loss and accuracy, the evaluation and the
  predictions within 1e-5 absolute + 1e-5 relative (float32 on both
  sides); ``Model.save`` / ``Model.load`` into a fresh network gives the
  same logits, bit for bit;
* each callback's effect on a small MLP, the same in both packages
  (epochs run, scheduler steps, learning rates, files written, log lines);
* ``summary`` and ``flops`` of LeNet and ResNet-18 equal to the
  reference's;
* ``Accuracy`` (top-1 and top-2, one-hot labels), ``Precision``,
  ``Recall``, ``Auc`` and ``accuracy``, exact on the same inputs, on
  tensors and on numpy;
* the reference's traps that the port copies, each named in a test.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place
from paddle_tpu_torch.hapi import model as port_model
from paddle_tpu_torch.nn.functional import attention as port_attention

TOL = dict(atol=1e-5, rtol=1e-5)
V, S, D, H, F, L, C, B = 97, 256, 64, 1, 128, 2, 3, 4


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


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


def _token_dataset(pkg, n, seed):
    """Sequences whose ids come from their class's third of the
    vocabulary: a label the classifier can learn."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n)
    x = (rng.integers(0, V // C, (n, S)) + y[:, None] * (V // C))

    class Tokens(pkg.io.Dataset):
        def __getitem__(self, i):
            return x[i].astype(np.int64), np.int64(y[i])

        def __len__(self):
            return n

    return Tokens()


def _fit(pkg, net):
    model = pkg.Model(net)
    opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                              parameters=net.parameters())
    model.prepare(opt, pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
    steps = []

    class Record(pkg.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            steps.append((logs["loss"], float(logs["acc"])))

    model.fit(_token_dataset(pkg, 12, 1), batch_size=B, epochs=1,
              shuffle=False, verbose=0, callbacks=[Record()])
    ev = model.evaluate(_token_dataset(pkg, 8, 2), batch_size=B, verbose=0)
    pred = model.predict(_token_dataset(pkg, 8, 2), batch_size=B,
                         stack_outputs=True)[0]
    return model, steps, ev, pred


def test_model_fit_evaluate_predict_against_the_reference(tmp_path,
                                                          monkeypatch):
    rp.seed(0)
    ref_net = _classifier(rp)
    rp.save(ref_net.state_dict(), str(tmp_path / "init.pdparams"))
    port_net = _classifier(tp)
    assert port_net.set_state_dict(
        tp.load(str(tmp_path / "init.pdparams"))) == ([], [])
    flash_calls = []
    real = port_attention.flash_attention

    def spy(*a, **k):
        flash_calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    _, want_steps, want_ev, want_pred = _fit(rp, ref_net)
    model, got_steps, got_ev, got_pred = _fit(tp, port_net)
    assert len(got_steps) == len(want_steps) == 3
    np.testing.assert_allclose(np.asarray(got_steps), np.asarray(want_steps),
                               **TOL)
    assert got_ev.keys() == want_ev.keys() == {"loss", "acc"}
    np.testing.assert_allclose(got_ev["loss"], want_ev["loss"], **TOL)
    assert got_ev["acc"] == want_ev["acc"]
    assert got_pred.shape == (8, C)
    np.testing.assert_allclose(got_pred, np.asarray(want_pred), **TOL)
    # every forward took the flash gate: 2 layers x (3 train + 2 eval + 2
    # predict) batches of (B, heads, S, D)
    assert flash_calls == [(B, H, S, D // H)] * (L * 7)
    # Model.save / Model.load into a fresh network: the same logits
    model.save(str(tmp_path / "ckpt" / "final"))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["final.pdopt",
                                                     "final.pdparams"]
    fresh = tp.Model(_classifier(tp))
    fresh.load(str(tmp_path / "ckpt" / "final"))
    ids = torch.from_numpy(np.stack([_token_dataset(tp, 8, 2)[i][0]
                                     for i in range(B)]))
    assert torch.equal(fresh.predict_batch(ids), model.predict_batch(ids))
    # and the reference loads the port's checkpoint
    ref_fresh = _classifier(rp)
    ref_fresh.set_state_dict(rp.load(str(tmp_path / "ckpt" /
                                         "final.pdparams")))
    np.testing.assert_allclose(
        np.asarray(ref_fresh(rp.to_tensor(ids.numpy()))._value),
        model.predict_batch(ids).numpy(), **TOL)


# ---- callbacks --------------------------------------------------------------

def _mlp(pkg, seed=0):
    nn = pkg.nn
    pkg.seed(seed)
    return nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))


def _mlp_dataset(pkg, n=20, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = rng.integers(0, 3, n)

    class Rows(pkg.io.Dataset):
        def __getitem__(self, i):
            return x[i], np.int64(y[i])

        def __len__(self):
            return n

    return Rows()


def _same_weights(ref_net, port_net, tmp_path):
    path = str(tmp_path / "mlp.pdparams")
    rp.save(ref_net.state_dict(), path)
    port_net.set_state_dict(tp.load(path))


def _both(tmp_path, make_opt, callbacks, **fit_kw):
    """Fit the same MLP in both packages; returns, per package, the
    model, the epochs run and the learning rates seen at each epoch's
    end."""
    out = {}
    ref_net = _mlp(rp)
    port_net = _mlp(tp)
    _same_weights(ref_net, port_net, tmp_path)
    for pkg, net in ((rp, ref_net), (tp, port_net)):
        model = pkg.Model(net)
        opt = make_opt(pkg, net)
        model.prepare(opt, pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        seen = {"epochs": 0, "lrs": []}

        class Watch(pkg.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                seen["epochs"] += 1
                seen["lrs"].append(opt.get_lr())

        cbs = [c(pkg) for c in callbacks] + [Watch()]
        model.fit(_mlp_dataset(pkg), batch_size=5, shuffle=False,
                  verbose=0, callbacks=cbs, **fit_kw)
        out[pkg.__name__] = (model, seen, opt)
    return out["paddle_tpu"], out["paddle_tpu_torch"]


def test_early_stopping_stops_both_alike(tmp_path):
    ref, port = _both(
        tmp_path, lambda p, n: p.optimizer.SGD(learning_rate=0.0,
                                               parameters=n.parameters()),
        [lambda p: p.callbacks.EarlyStopping("loss", patience=1)],
        epochs=6, eval_data=None)
    # no evaluation, no stop
    assert ref[1]["epochs"] == port[1]["epochs"] == 6
    ref, port = _both(
        tmp_path, lambda p, n: p.optimizer.SGD(learning_rate=0.0,
                                               parameters=n.parameters()),
        [lambda p: p.callbacks.EarlyStopping("loss", patience=1)],
        epochs=6, eval_data=_mlp_dataset(rp, n=5))
    # the eval loss never moves: best at epoch 1, stop after epoch 2
    assert ref[1]["epochs"] == port[1]["epochs"] == 2
    assert port[0].stop_training and ref[0].stop_training


def test_lr_scheduler_is_stepped_each_batch_and_appended_twice(tmp_path):
    """The trap: fit always appends an LRScheduler(), so a user's own
    LRScheduler callback steps the scheduler a second time per batch."""
    def opt(pkg, net):
        return pkg.optimizer.SGD(
            learning_rate=pkg.optimizer.lr.StepDecay(0.1, step_size=3),
            parameters=net.parameters())

    ref, port = _both(tmp_path, opt, [], epochs=2)
    assert ref[2]._learning_rate.last_epoch == \
        port[2]._learning_rate.last_epoch == 8         # 4 batches x 2
    np.testing.assert_allclose(port[1]["lrs"], ref[1]["lrs"], rtol=1e-12)
    ref, port = _both(tmp_path, opt,
                      [lambda p: p.callbacks.LRScheduler()], epochs=2)
    assert ref[2]._learning_rate.last_epoch == \
        port[2]._learning_rate.last_epoch == 16
    ref, port = _both(tmp_path, opt, [lambda p: p.callbacks.LRScheduler(
        by_step=False, by_epoch=True)], epochs=2)
    assert ref[2]._learning_rate.last_epoch == \
        port[2]._learning_rate.last_epoch == 10


def test_reduce_lr_on_plateau(tmp_path):
    def sgd(pkg, net):
        return pkg.optimizer.SGD(learning_rate=1e-9,
                                 parameters=net.parameters())

    ref, port = _both(tmp_path, sgd, [
        lambda p: p.callbacks.ReduceLROnPlateau(patience=1, factor=0.5,
                                                verbose=0)], epochs=4)
    np.testing.assert_allclose(port[1]["lrs"], ref[1]["lrs"], rtol=1e-12)
    assert port[1]["lrs"] == pytest.approx([1e-9, 5e-10, 2.5e-10,
                                            1.25e-10], rel=1e-12)

    # the trap: with a scheduler, set_lr raises
    def sched(pkg, net):
        return pkg.optimizer.SGD(
            learning_rate=pkg.optimizer.lr.StepDecay(1e-9, 100),
            parameters=net.parameters())

    net = _mlp(tp)
    model = tp.Model(net)
    model.prepare(sched(tp, net), tp.nn.CrossEntropyLoss())
    with pytest.raises(RuntimeError, match="cannot set_lr"):
        model.fit(_mlp_dataset(tp), batch_size=5, epochs=3, verbose=0,
                  shuffle=False, callbacks=[
                      tp.callbacks.ReduceLROnPlateau(patience=1, verbose=0)])


def test_model_checkpoint_visualdl_and_progbar(tmp_path, capsys):
    def adam(pkg, net):
        return pkg.optimizer.Adam(learning_rate=1e-3,
                                  parameters=net.parameters())

    dirs = {}
    for name in ("paddle_tpu", "paddle_tpu_torch"):
        dirs[name] = tmp_path / name
    made = iter(dirs.values())
    logs = iter([tmp_path / "vdl_ref", tmp_path / "vdl_port"])

    def ckpt(pkg):
        return pkg.callbacks.ModelCheckpoint(save_freq=2,
                                             save_dir=str(next(made)))

    def vdl(pkg):
        return pkg.callbacks.VisualDL(str(next(logs)))

    ref, port = _both(tmp_path, adam, [ckpt, vdl], epochs=3)
    for d in dirs.values():                # epochs 0 and 2, then "final"
        assert sorted(os.listdir(d)) == [
            "0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams",
            "final.pdopt", "final.pdparams"]
    lines = {k: (tmp_path / k / "metrics.jsonl").read_text().splitlines()
             for k in ("vdl_ref", "vdl_port")}
    assert len(lines["vdl_port"]) == len(lines["vdl_ref"]) == 12
    import json
    got = [json.loads(x) for x in lines["vdl_port"]]
    want = [json.loads(x) for x in lines["vdl_ref"]]
    assert [g["step"] for g in got] == list(range(1, 13))
    np.testing.assert_allclose([[g["loss"], g["acc"]] for g in got],
                               [[w["loss"], w["acc"]] for w in want], **TOL)
    # the final checkpoints hold the same weights
    a = tp.load(str(dirs["paddle_tpu_torch"] / "final.pdparams"))
    b = tp.load(str(dirs["paddle_tpu"] / "final.pdparams"))
    for k in a:
        np.testing.assert_allclose(a[k].detach().numpy(),
                                   b[k].detach().numpy(), **TOL)
    # the optimizer's state goes back into an optimizer
    net = _mlp(tp)
    model = tp.Model(net)
    opt = adam(tp, net)
    model.prepare(opt, tp.nn.CrossEntropyLoss())
    model.load(str(dirs["paddle_tpu_torch"] / "final"))
    assert opt._step_count == 12
    capsys.readouterr()
    tp.Model(_mlp(tp)).prepare(adam(tp, _mlp(tp)),
                               tp.nn.CrossEntropyLoss())
    m = tp.Model(net)
    m.prepare(adam(tp, net), tp.nn.CrossEntropyLoss())
    m.fit(_mlp_dataset(tp), batch_size=5, epochs=2, verbose=2, log_freq=2)
    out = capsys.readouterr().out
    assert "Epoch 1/2" in out and "Epoch 2/2" in out
    assert "step 1/4 - loss:" in out and "step 3/4" in out
    assert "step 2/4" not in out


# ---- summary / flops --------------------------------------------------------

@pytest.mark.parametrize("arch", ["lenet", "resnet18"])
def test_summary_and_flops_equal_the_reference(arch, capsys, monkeypatch):
    """Both read only shapes: the reference's random initializers are
    swapped for zeros here (its truncated-normal draws compile once per
    shape, 14 s for ResNet-18)."""
    import jax.numpy as jnp
    from paddle_tpu.core import dtype as ref_dtype
    from paddle_tpu.nn import initializer as ref_init
    from paddle_tpu.vision import models as ref_models
    from paddle_tpu_torch.vision import models as port_models

    def zeros(self, shape, dtype=None):
        return jnp.zeros(tuple(int(s) for s in shape),
                         ref_dtype.convert_dtype(dtype))

    for cls in (ref_init.Normal, ref_init.Uniform):
        monkeypatch.setattr(cls, "__call__", zeros)
    if arch == "lenet":
        nets = (ref_models.LeNet(), port_models.LeNet())
        size = (1, 1, 28, 28)
    else:
        nets = (ref_models.resnet18(), port_models.resnet18())
        size = (1, 3, 32, 32)
    capsys.readouterr()
    want = rp.summary(nets[0])
    want_text = capsys.readouterr().out
    got = tp.summary(nets[1])
    got_text = capsys.readouterr().out
    assert got == want and got_text == want_text
    # the trap: input_size is ignored
    assert tp.summary(nets[1], input_size=(7, 7)) == got
    assert tp.Model(nets[1]).summary((1, 2)) == got
    capsys.readouterr()
    assert tp.flops(nets[1], size, print_detail=True) == rp.flops(
        nets[0], size, print_detail=True)
    text = capsys.readouterr().out
    half = len(text) // 2
    assert text[:half] == text[half:] and "Total FLOPs" in text


def test_flops_feeds_float32_zeros_and_leaves_sublayers_in_eval():
    """The traps: the input is float32 zeros whatever the network takes,
    and only the network itself gets its training flag back."""
    net = tp.nn.Sequential(tp.nn.Linear(4, 4), tp.nn.Dropout(0.5))
    seen = []
    net[0].register_forward_pre_hook(lambda layer, inp: seen.append(inp[0]))
    net.train()
    custom = {tp.nn.Dropout: lambda layer, x, out: 7}
    assert tp.flops(net, (3, 4), custom_ops=custom) == 3 * 16 + 7
    assert seen[0].dtype == torch.float32 and not seen[0].any()
    assert net.training and not net[0].training and not net[1].training


# ---- metrics ----------------------------------------------------------------

def _metric_inputs(seed=0, n=64, c=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, c)).astype(np.float32),
            rng.integers(0, c, (n, 1)).astype(np.int64),
            rng.random(n).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int64))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_metrics_exact_against_the_reference(as_tensor):
    pred, label, prob, binary = _metric_inputs()
    conv = (lambda a: torch.from_numpy(a)) if as_tensor else (lambda a: a)
    onehot = np.eye(5, dtype=np.float32)[label[:, 0]]
    for topk, lab in (((1,), label), ((1, 2), label), ((1, 3), onehot)):
        r, p = rp.metric.Accuracy(topk=topk), tp.metric.Accuracy(topk=topk)
        for half in (slice(0, 30), slice(30, 64)):
            rc = r.compute(rp.to_tensor(pred[half]), rp.to_tensor(lab[half]))
            pc = p.compute(conv(pred[half]), conv(lab[half]))
            assert isinstance(pc, torch.Tensor) and pc.dtype == torch.float32
            assert np.array_equal(pc.numpy(), np.asarray(rc))
            assert p.update(pc) == r.update(rc)
        assert p.accumulate() == r.accumulate()
        assert p.name() == r.name() == "acc"
        p.reset()
        assert p.accumulate() == ([0.0] * len(topk) if len(topk) > 1
                                  else 0.0)
    for cls in ("Precision", "Recall"):
        r, p = getattr(rp.metric, cls)(), getattr(tp.metric, cls)()
        for half in (slice(0, 30), slice(30, 64)):
            r.update(prob[half], binary[half])
            p.update(conv(prob[half]), conv(binary[half]))
        assert p.accumulate() == r.accumulate() and p.name() == r.name()
    for n_thr, two_col in ((4095, False), (63, True)):
        r = rp.metric.Auc(num_thresholds=n_thr)
        p = tp.metric.Auc(num_thresholds=n_thr)
        x = np.stack([1 - prob, prob], 1) if two_col else prob
        r.update(x, binary)
        p.update(conv(x), conv(binary))
        assert p.accumulate() == r.accumulate() and p.name() == "auc"
    for k in (1, 2):
        want = np.asarray(rp.metric.accuracy(rp.to_tensor(pred),
                                             rp.to_tensor(label), k=k)._value)
        got = tp.metric.accuracy(conv(pred), conv(label), k=k)
        assert got.dtype == torch.float32 and got.item() == want.item()


def test_auc_reads_no_curve():
    """The trap: ``curve`` is kept and never read: "PR" gives ROC's
    area."""
    _, _, prob, binary = _metric_inputs(seed=1)
    roc, pr = tp.metric.Auc("ROC"), tp.metric.Auc("PR")
    roc.update(prob, binary)
    pr.update(prob, binary)
    assert pr.accumulate() == roc.accumulate()


def test_metrics_read_bfloat16_tensors_as_float32():
    pred, label, _, _ = _metric_inputs(seed=2)
    b = torch.from_numpy(pred).to(torch.bfloat16)
    acc = tp.metric.Accuracy()
    got = acc.update(acc.compute(b, torch.from_numpy(label)))
    want = tp.metric.Accuracy()
    assert got == want.update(want.compute(b.float().numpy(), label))


# ---- the traps --------------------------------------------------------------

def _mlp_model(opt_cls=None):
    net = _mlp(tp)
    model = tp.Model(net)
    opt = (opt_cls or tp.optimizer.SGD)(learning_rate=0.1,
                                        parameters=net.parameters())
    model.prepare(opt, tp.nn.CrossEntropyLoss(), tp.metric.Accuracy(),
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    return model, net, opt


def test_prepare_ignores_amp_configs_and_fit_accumulate_grad_batches():
    model, net, opt = _mlp_model()
    model.fit(_mlp_dataset(tp), batch_size=5, epochs=1, verbose=0,
              shuffle=False, accumulate_grad_batches=4)
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert opt._step_count == 4               # one step a batch


def test_train_batch_without_update_accumulates_gradients():
    model, net, opt = _mlp_model()
    ds = _mlp_dataset(tp)
    x = np.stack([ds[i][0] for i in range(5)])
    y = np.asarray([ds[i][1] for i in range(5)])
    w0 = net[0].weight.detach().clone()
    model.train_batch([x], [y], update=False)
    g1 = net[0].weight.grad.clone()
    loss, metrics = model.train_batch([x], [y], update=False)
    assert torch.equal(net[0].weight, w0) and opt._step_count == 0
    torch.testing.assert_close(net[0].weight.grad, 2 * g1)
    assert isinstance(loss[0], float) and len(metrics) == 1


def test_evaluate_and_predict_read_no_callbacks():
    model, _, _ = _mlp_model()
    called = []

    class Spy(tp.callbacks.Callback):
        def __getattribute__(self, name):
            if name.startswith("on_"):
                called.append(name)
            return object.__getattribute__(self, name)

    logs = model.evaluate(_mlp_dataset(tp), batch_size=5, callbacks=[Spy()],
                          verbose=2, log_freq=1, num_samples=3)
    out = model.predict(_mlp_dataset(tp), batch_size=5, callbacks=[Spy()],
                        verbose=2)
    assert called == []
    assert set(logs) == {"loss", "acc"}
    assert len(out) == 1 and len(out[0]) == 4 and out[0][0].shape == (5, 3)


def test_static_graph_adapter_is_refused():
    """The adapter is no longer refused: a Model made in static mode
    drives it (the full parity test is tests/test_torch_static.py), one
    made in dynamic mode does not."""
    assert tp.Model(_mlp(tp))._adapter is None
    tp.enable_static()
    try:
        net = _mlp(tp)
        model = tp.Model(net, inputs=[tp.static.InputSpec([-1, 6], "float32",
                                                          "x")])
        assert isinstance(model._adapter, port_model.StaticGraphAdapter)
        x = np.ones((2, 6), np.float32)
        out = model.predict_batch([x])
    finally:
        tp.disable_static()
    np.testing.assert_allclose(out, net(torch.from_numpy(x)).detach().numpy(),
                               rtol=1e-6)
    assert tp.in_dynamic_mode()
