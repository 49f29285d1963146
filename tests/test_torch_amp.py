"""The port's op dispatch and amp against the JAX package's, on a tiny
BERT (``BertConfig.tiny()``, dropout 0) with the reference's weights and
the same numpy inputs:

* under ``auto_cast`` at O1 and at O2 (``decorate``'s bf16 parameters):
  every op the port dispatches is one the reference dispatches, and for
  each, call by call, the dtypes of its floating inputs after the cast
  and of its outputs are the reference's (integer inputs compared as
  "int": the reference's ids are int32, the port's int64); the logits
  and the loss within a bf16 tolerance;
* custom white and black lists (``linear`` black-listed, ``layer_norm``
  white-listed, at O1): the same dtypes as the reference's;
* a nested entry point (``F.linear`` calls ``matmul``) cast once and not
  recorded as an op of its own; the ``op::`` spans of the ``obs`` tracer;
  ``FLAGS_check_nan_inf``; ``enable_static``'s capture;
* ``GradScaler``: the scale sequence with an injected inf (the step
  skipped, ``update`` called by ``step`` itself, as the reference's),
  the gradients divided by the scale, ``decorate``'s masters retrofitted
  onto accumulators made before it.

Tolerance of the bf16 runs: both packages round the same values to bf16
at the same ops, but their matmuls accumulate in different orders, so a
rounding may fall either way and carry on: logits within 2^-6 of the
largest (bf16 keeps 8 bits; readings 0.0081 at O1 and at O2), the loss
within 1e-2 relative (readings 2.46e-3 at O1, 1.90e-3 at O2). The
reference's forward runs jitted (one compile, not one per eager op); its
census is recorded while it traces.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as ref_amp
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.models import nlp as ref_nlp
from paddle_tpu.ops import dispatch as ref_dispatch
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp as port_amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.models import nlp as port_nlp
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.obs import trace as port_trace
from paddle_tpu_torch.ops import dispatch as port_dispatch

LOGITS_REL = 2 ** -6
LOSS_REL = 1e-2


def _kind(dt):
    dt = str(dt).removeprefix("torch.")
    return "int" if dt.startswith(("int", "uint")) else dt


def _ref_census(monkeypatch):
    """{op name: [(input dtypes after the cast, output dtypes)]} of the
    reference's dispatched ops while the returned dict is live."""
    rec = collections.defaultdict(list)
    inner, cast = ref_dispatch._apply_op_inner, ref_amp._maybe_cast
    last = {}

    def spy_cast(name, vals):
        out = cast(name, vals)
        last["vals"] = out
        return out

    def spy(name, fn, args, kwargs, nondiff):
        last.pop("vals", None)
        out = inner(name, fn, args, kwargs, nondiff)
        vals = last.pop("vals", None)
        if vals is None:
            vals = [a._value if hasattr(a, "_value") else a for a in args]
        outs = out if isinstance(out, tuple) else (out,)
        rec[name].append((tuple(_kind(v.dtype) for v in vals
                                if hasattr(v, "dtype")),
                          tuple(_kind(o._value.dtype) for o in outs)))
        return out

    monkeypatch.setattr(ref_dispatch, "_apply_op_inner", spy)
    monkeypatch.setattr(ref_amp, "_maybe_cast", spy_cast)
    return rec


def _normal(census):
    return {n: [(tuple(_kind(d) for d in i), tuple(_kind(d) for d in o))
                for i, o in calls] for n, calls in census.items()}


@functools.lru_cache(maxsize=None)
def _state():
    """The reference's initial tiny BERT weights."""
    return {k: np.asarray(v._value) for k, v in
            _ref_bert().state_dict().items()}


@functools.lru_cache(maxsize=None)
def _ref_bert():
    paddle.seed(0)
    return ref_nlp.BertForPretraining(ref_nlp.BertConfig.tiny())


def _models():
    ref = _ref_bert().to(dtype="float32")
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in _state().items()})
    port = port_nlp.BertForPretraining(port_nlp.BertConfig.tiny(),
                                       device="cpu")
    tnn.load_numpy_state_dict(port, _state())
    return ref, port


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 16))
    types = (np.arange(16) >= 8).astype(np.int64)[None].repeat(2, 0)
    mlm = np.where(rng.random((2, 16)) < 0.3, rng.integers(0, 512, (2, 16)),
                   -100)
    nsp = rng.integers(0, 2, (2,))
    return ids, types, mlm, nsp


def _run_both(monkeypatch, level, **lists):
    ref, port = _models()
    if level == "O2":
        ref_amp.decorate(ref, level="O2")
        port_amp.decorate(port, level="O2")
    ids, types, mlm, nsp = _batch()
    rec = _ref_census(monkeypatch)
    params = dict(ref.named_parameters())

    @jax.jit                        # one compile, not one per eager op
    def forward(values, batch):
        saved = {k: p._value for k, p in params.items()}
        for k, v in values.items():
            params[k]._value = v
        try:
            with paddle.no_grad(), ref_amp.auto_cast(level=level, **lists):
                ids, types, mlm, nsp = (paddle.Tensor(a) for a in batch)
                logits, nsp_logits = ref(ids, types)
                loss = ref.loss(logits, nsp_logits, mlm, nsp)
        finally:
            for k, v in saved.items():
                params[k]._value = v
        return logits._value, loss._value

    r_logits, r_loss = forward({k: p._value for k, p in params.items()},
                               tuple(jnp.asarray(a) for a in
                                     (ids, types, mlm, nsp)))
    with port_dispatch.census() as census, \
            port_amp.auto_cast(level=level, **lists):
        t_logits, t_nsp = port(torch.from_numpy(ids),
                               torch.from_numpy(types))
        t_loss = port.loss(t_logits, t_nsp, torch.from_numpy(mlm),
                           torch.from_numpy(nsp))
    return (dict(rec), _normal(census), (r_logits, r_loss),
            (t_logits, t_loss))


def _assert_census(rec, census):
    assert census and set(census) <= set(rec), set(census) - set(rec)
    for name, calls in census.items():
        assert calls == rec[name], (name, calls, rec[name])


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_dtypes_by_op_name_match_jax(monkeypatch, level):
    rec, census, (r_logits, r_loss), (t_logits, t_loss) = _run_both(
        monkeypatch, level)
    _assert_census(rec, census)
    names = {"embedding", "layer_norm", "linear", "matmul", "gelu", "tanh",
             "scaled_dot_product_attention", "cross_entropy"}
    assert names <= set(census)
    ln_out = {o for _, o in census["layer_norm"]}
    assert ln_out == {("float32",)}
    assert {i for i, _ in census["cross_entropy"]} == {("float32", "int")}
    assert {o for _, o in census["linear"]} == {("bfloat16",)}
    want = np.asarray(r_logits, np.float32)
    got = t_logits.detach().float().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    loss_err = abs(float(t_loss.detach()) - float(r_loss)) \
        / abs(float(r_loss))
    print(f"{level}: logits {err:.3g} of the largest, loss {loss_err:.3g}")
    assert t_logits.dtype == torch.bfloat16
    assert err <= LOGITS_REL and loss_err <= LOSS_REL


@pytest.mark.parametrize("lists", [
    dict(custom_black_list={"linear"}),
    dict(custom_white_list={"layer_norm", "gelu"}),
    dict(custom_white_list={"cross_entropy"}, custom_black_list={"matmul"}),
], ids=["black_linear", "white_layer_norm_gelu", "white_ce_black_matmul"])
def test_custom_lists_match_jax(monkeypatch, lists):
    rec, census, _, (t_logits, t_loss) = _run_both(monkeypatch, "O1",
                                                   **lists)
    _assert_census(rec, census)
    assert np.isfinite(float(t_loss.detach()))


def test_nested_ops_are_cast_once_and_not_recorded():
    x = torch.randn(3, 4, dtype=torch.float32)
    w = torch.randn(4, 2, dtype=torch.float32)
    with port_dispatch.census() as census, \
            port_amp.auto_cast(custom_black_list={"matmul"}):
        out = TF.linear(x, w)
    # linear is white: its inputs are cast to bf16 once; the matmul inside
    # it is not dispatched again (a black matmul would have cast back)
    assert out.dtype == torch.bfloat16
    assert list(census) == ["linear"]
    assert census["linear"] == [(("bfloat16", "bfloat16"), ("bfloat16",))]
    # amp and the census end with their blocks; outside, nothing is cast
    assert port_amp.amp_state() is None
    assert TF.linear(x, w).dtype == torch.float32
    with port_amp.auto_cast(enable=False):
        assert TF.linear(x, w).dtype == torch.float32


def test_spans_nan_check_and_static_refusal():
    tracer = port_trace.Tracer()
    with port_trace.use(tracer):
        TF.gelu(TF.linear(torch.ones(2, 3), torch.ones(3, 3)))
    names = [e["name"] for e in tracer.events]
    assert names == ["op::linear", "op::gelu"]
    bad = torch.tensor([1.0, float("nan")])
    assert torch.isnan(TF.relu(bad)).any()
    port_flags.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="'tanh'"):
            TF.tanh(bad)
    finally:
        port_flags.set_flags({"check_nan_inf": False})
    assert ptt.get_flags("check_nan_inf") == {"check_nan_inf": False}
    with pytest.raises(KeyError):
        ptt.set_flags({"no_such_flag": 1})
    # static mode: an op on a StaticVar is captured (its span is not
    # recorded: nothing runs), and the eager path is back after it
    ptt.enable_static()
    try:
        prog = ptt.static.Program()
        with ptt.static.program_guard(prog), port_trace.use(tracer):
            x = ptt.static.data("x", [2, 3], "float32")
            y = TF.relu(x)
        assert isinstance(y, ptt.static.StaticVar)
        assert ptt.static.apply_pass(prog, "op_stats") == {"relu": 1}
        assert not ptt.in_dynamic_mode()
    finally:
        ptt.disable_static()
    assert ptt.in_dynamic_mode()
    assert [e["name"] for e in tracer.events] == names


def _scaler_run(pkg_amp, pkg_opt, make_param, set_grad, read_grad):
    p = make_param()
    opt = pkg_opt.SGD(learning_rate=0.5, parameters=[p])
    scaler = pkg_amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
    scales, values = [], []
    for i, g in enumerate([1.0, np.inf, 2.0, 4.0, 8.0, np.nan, 1.0]):
        set_grad(p, np.full((2,), g * scaler._scale, np.float32))
        scaler.minimize(opt, None)
        scales.append(scaler._scale)
        values.append(read_grad(p))
    return scales, values


def test_grad_scaler_matches_jax():
    from paddle_tpu.core.tensor import Parameter, Tensor

    def ref_set(p, g):
        p._grad = Tensor(jnp.asarray(g))

    def port_set(p, g):
        p.grad = torch.from_numpy(g)

    ref = _scaler_run(ref_amp, ref_opt,
                      lambda: Parameter(jnp.zeros(2)), ref_set,
                      lambda p: np.asarray(p._value).tolist())
    port = _scaler_run(port_amp, port_opt,
                       lambda: torch.nn.Parameter(torch.zeros(2)), port_set,
                       lambda p: p.detach().numpy().tolist())
    assert port == ref
    # an inf or a nan step leaves the parameter, halves the scale; two
    # good steps double it
    assert port[0] == [8.0, 4.0, 4.0, 8.0, 8.0, 4.0, 4.0]


def test_decorate_retrofits_masters_and_casts_buffers():
    model = tnn.Sequential(tnn.Linear(3, 2, device="cpu"),
                           tnn.BatchNorm1D(2, device="cpu"))
    opt = port_opt.Adam(learning_rate=0.1, parameters=model.parameters())
    model(torch.randn(4, 3)).sum().backward()
    opt.step()
    port_amp.decorate(model, opt, level="O2")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model[1]._mean.dtype == torch.bfloat16
    assert opt._multi_precision
    for p in model.parameters():
        master = opt._accumulators[id(p)]["_master"]
        assert master.dtype == torch.float32
        assert torch.equal(master.to(torch.bfloat16), p.detach())
    assert port_amp.decorate(model, level="O1") is model
