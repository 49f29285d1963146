"""``nn``'s recurrent layers and beam search in the PyTorch port, against
the JAX package on the CPU, on the reference's weights (its
``state_dict()`` through ``nn.load_numpy_state_dict``) and the same
numpy inputs:

* the three cells, ``RNN`` / ``BiRNN`` over a cell, and ``SimpleRNN`` /
  ``LSTM`` / ``GRU`` with initial states, 2 layers, bidirect and
  ``time_major``, dropout set but in ``eval()``: outputs, final states
  and the gradients of the input, the initial states and every weight
  under a fixed random cotangent, within 1e-5 abs + 1e-5 rel;
* ``F.gather_tree``, and ``BeamSearchDecoder`` + ``dynamic_decode`` over
  a tiny LM's two ``LSTMCell``s: ids and lengths equal;
* 3 steps of a tiny LSTM LM (2 layers, hidden 32, vocab 50: embedding,
  ``LSTM``, ``Linear``) with SGD and ``ClipGradByGlobalNorm``, against the
  reference's own eager loop: losses and parameters within 1e-5;
* the reference's traps, copied on purpose (ROADMAP Queue 3).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu import nn as rnn_
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.nn import functional as RF
import paddle_tpu_torch as port
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import dispatch as port_dispatch

jax.config.update("jax_platforms", "cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _carry(ref_layer, port_layer):
    tnn.load_numpy_state_dict(port_layer, _state(ref_layer))
    return port_layer


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _run_both(ref_layer, port_layer, x, states, call=None):
    """Outputs and gradients (input, states, parameters) of both layers
    on ``x`` and ``states`` (numpy pytrees) under one random cotangent."""
    call = call or (lambda layer, xx, st: layer(xx, st))
    rng = np.random.default_rng(0)

    def mk_ref(a):
        return ref.to_tensor(a, stop_gradient=False)

    def mk_port(a):
        return torch.from_numpy(a.copy()).requires_grad_(True)

    def tree(f, t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return type(t)(tree(f, s) for s in t)
        return f(t)

    rx, rs = mk_ref(x), tree(mk_ref, states)
    px, ps = mk_port(x), tree(mk_port, states)
    rout = _leaves(call(ref_layer, rx, rs))
    pout = _leaves(call(port_layer, px, ps))
    cots = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in rout]
    rloss = None
    for o, c in zip(rout, cots):
        term = (o * ref.to_tensor(c)).sum()
        rloss = term if rloss is None else rloss + term
    rloss.backward()
    ploss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(pout, cots))
    ploss.backward()
    for o, p in zip(rout, pout):
        np.testing.assert_allclose(p.detach().numpy(), o.numpy(), **TOL)
    rin = [rx] + _leaves(rs if rs is not None else [])
    pin = [px] + _leaves(ps if ps is not None else [])
    for r, p in zip(rin, pin):
        np.testing.assert_allclose(p.grad.numpy(), r.grad.numpy(), **TOL)
    rparams = dict(ref_layer.named_parameters())
    for name, p in port_layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   rparams[name].grad.numpy(), **TOL,
                                   err_msg=name)
    return rout, pout


@pytest.fixture(autouse=True)
def seeded():
    ref.seed(7)
    port.seed(7)
    prev = port_place._default
    port.set_device("cpu")
    yield
    port_place._default = prev


CELLS = {
    "simple_tanh": (lambda: rnn_.SimpleRNNCell(32, 32),
                    lambda: tnn.SimpleRNNCell(32, 32, device="cpu")),
    "simple_relu": (lambda: rnn_.SimpleRNNCell(32, 32, activation="relu"),
                    lambda: tnn.SimpleRNNCell(32, 32, "relu", device="cpu")),
    "lstm": (lambda: rnn_.LSTMCell(32, 32),
             lambda: tnn.LSTMCell(32, 32, device="cpu")),
    "gru": (lambda: rnn_.GRUCell(32, 32),
            lambda: tnn.GRUCell(32, 32, device="cpu")),
}


@pytest.mark.parametrize("kind,with_states", [
    (k, True) for k in sorted(CELLS)] + [("lstm", False), ("gru", False)])
def test_cell(kind, with_states):
    rl, pl = CELLS[kind][0](), CELLS[kind][1]()
    _carry(rl, pl)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    st = None
    if with_states:
        h = rng.standard_normal((4, 32)).astype(np.float32)
        st = (h, rng.standard_normal((4, 32)).astype(np.float32)) \
            if kind == "lstm" else h
    _run_both(rl, pl, x, st)


STACKS = {
    "lstm": (rnn_.LSTM, tnn.LSTM),
    "gru": (rnn_.GRU, tnn.GRU),
    "simple": (rnn_.SimpleRNN, tnn.SimpleRNN),
}


@pytest.mark.parametrize("kind", sorted(STACKS))
@pytest.mark.parametrize("time_major", [False, True])
def test_stack_bidirect_two_layers(kind, time_major):
    R, P = STACKS[kind]
    kw = dict(num_layers=2, direction="bidirect", time_major=time_major,
              dropout=0.5)
    rl, pl = R(32, 32, **kw), P(32, 32, device="cpu", **kw)
    rl.eval()
    pl.eval()
    _carry(rl, pl)
    assert sorted(dict(pl.named_parameters())) == sorted(
        dict(rl.named_parameters()))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 32) if time_major else (4, 3, 32)).astype(
        np.float32)
    h0 = rng.standard_normal((4, 4, 32)).astype(np.float32)
    st = (h0, rng.standard_normal((4, 4, 32)).astype(np.float32)) \
        if kind == "lstm" else h0
    _run_both(rl, pl, x, st)


def test_stack_one_layer_without_states():
    rl, pl = rnn_.LSTM(32, 32), tnn.LSTM(32, 32, device="cpu")
    _carry(rl, pl)
    x = np.random.default_rng(3).standard_normal((4, 4, 32)).astype(
        np.float32)
    _run_both(rl, pl, x, None)


@pytest.mark.parametrize("bi", [False, True])
def test_rnn_and_birnn_over_a_cell(bi):
    if bi:
        rl = rnn_.BiRNN(rnn_.GRUCell(32, 32), rnn_.GRUCell(32, 32))
        pl = tnn.BiRNN(tnn.GRUCell(32, 32, device="cpu"),
                       tnn.GRUCell(32, 32, device="cpu"))
    else:
        rl = rnn_.RNN(rnn_.LSTMCell(32, 32), is_reverse=True)
        pl = tnn.RNN(tnn.LSTMCell(32, 32, device="cpu"), is_reverse=True)
    _carry(rl, pl)
    x = np.random.default_rng(4).standard_normal((4, 3, 32)).astype(
        np.float32)
    _run_both(rl, pl, x, None)


def test_dropout_between_layers_in_training():
    """Training-mode dropout draws from the layer's generator: the same
    seed gives the same output, the eval output differs."""
    def make():
        return tnn.LSTM(4, 6, 2, dropout=0.5, device="cpu",
                        generator=port.core.Generator(3))
    x = torch.randn(2, 3, 4)
    a, b = make(), make()
    b.load_state_dict(a.state_dict())
    ya, yb = a(x)[0], b(x)[0]
    assert torch.equal(ya, yb)
    assert not torch.allclose(ya, a.eval()(x)[0])


# ---- gather_tree and beam search --------------------------------------------

def test_gather_tree():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 9, (6, 2, 3)).astype(np.int32)
    parents = rng.integers(0, 3, (6, 2, 3)).astype(np.int32)
    want = RF.gather_tree(ref.to_tensor(ids), ref.to_tensor(parents))
    got = TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


class _LM:
    """A tiny LSTM LM in either package: embedding, ``LSTM`` (2 layers),
    ``Linear``; ``forward(ids, states)`` -> (logits, states)."""

    def __init__(self, nn, vocab, hidden, layers=2, dropout=0.0, **kw):
        self.embedding = nn.Embedding(vocab, hidden, **kw)
        self.lstm = nn.LSTM(hidden, hidden, layers, dropout=dropout, **kw)
        self.fc = nn.Linear(hidden, vocab, **kw)
        self.layers = (self.embedding, self.lstm, self.fc)

    def state(self):
        return {f"{i}.{k}": v for i, layer in enumerate(self.layers)
                for k, v in _state(layer).items()}

    def load(self, state):
        for i, layer in enumerate(self.layers):
            tnn.load_numpy_state_dict(layer, {
                k.split(".", 1)[1]: v for k, v in state.items()
                if k.startswith(f"{i}.")})

    def parameters(self):
        return [p for layer in self.layers for p in layer.parameters()]


def _lm_pair(vocab=50, hidden=32):
    r = _LM(rnn_, vocab, hidden)
    p = _LM(tnn, vocab, hidden, device="cpu")
    p.load(r.state())
    return r, p


class _TwoCells:
    """A user's ``RNNCellBase`` over the LM's two ``LSTMCell``s."""

    def __init__(self, base, cells):
        self.base, self.cells = base, cells

    def make(self):
        cells = self.cells

        class Cell(self.base):
            def __init__(self):
                super().__init__()
                self.hidden_size = cells[0].hidden_size

            def forward(self, x, states):
                new = []
                for cell, st in zip(cells, states):
                    x, st = cell(x, st)
                    new.append(st)
                return x, new
        return Cell()


def test_beam_search_decoder_against_the_reference():
    r, p = _lm_pair()
    outs = {}
    for name, lm, nn, mk in (
            ("ref", r, rnn_, lambda a: ref.to_tensor(a)),
            ("port", p, tnn, torch.from_numpy)):
        cell = _TwoCells(nn.RNNCellBase, list(lm.lstm.cells)).make()
        dec = nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                   beam_size=4, embedding_fn=lm.embedding,
                                   output_fn=lm.fc)
        z = np.zeros((4, 32), np.float32)
        inits = [(mk(z), mk(z)), (mk(z), mk(z))]
        seqs, states, lengths = nn.dynamic_decode(
            dec, inits, max_step_num=5, return_length=True)
        outs[name] = (np.asarray(seqs.numpy()), np.asarray(
            lengths.numpy()), states)
    (rs, rlen, rst), (ps, plen, pst) = outs["ref"], outs["port"]
    assert ps.dtype == np.int32 and ps.shape == rs.shape == (4, 6, 4)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(plen, rlen)
    # the last step's log-probabilities and finished flags
    np.testing.assert_allclose(pst[1].numpy(), np.asarray(rst[1]), **TOL)
    np.testing.assert_array_equal(pst[2].numpy(), np.asarray(rst[2]))


# ---- 3 steps of the tiny LM against the reference's eager loop ---------------

def _lm_loss(lm, F, ids, labels, states):
    x = lm.embedding(ids)
    y, states = lm.lstm(x, states)
    logits = lm.fc(y)
    return F.cross_entropy(logits.reshape([-1, logits.shape[-1]]),
                           labels.reshape([-1])), states


def test_tiny_lm_three_steps_against_the_reference():
    r, p = _lm_pair()
    ropt = ref_opt.SGD(learning_rate=1.0, parameters=r.parameters(),
                       grad_clip=rnn_.ClipGradByGlobalNorm(0.5))
    popt = port_opt.SGD(learning_rate=1.0, parameters=p.parameters(),
                        grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    rng = np.random.default_rng(6)
    B, T = 4, 4
    stream = rng.integers(0, 50, 3 * B * T + 1).astype(np.int32)
    zeros = np.zeros((2, B, 32), np.float32)
    rst = (ref.to_tensor(zeros), ref.to_tensor(zeros))
    pst = (torch.from_numpy(zeros), torch.from_numpy(zeros))
    rl, pl = [], []
    for step in range(3):
        chunk = stream[:B * T + 1]                 # one batch, repeated
        ids, labels = chunk[:-1].reshape(B, T), chunk[1:].reshape(B, T)
        loss, rst = _lm_loss(r, RF, ref.to_tensor(ids), ref.to_tensor(labels),
                             rst)
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        rst = tuple(s.detach() for s in rst)
        rl.append(float(loss.numpy()))
        loss, pst = _lm_loss(p, TF, port.to_tensor(ids),
                             port.to_tensor(labels), pst)
        loss.backward()
        popt.step()
        popt.clear_grad()
        pst = tuple(s.detach() for s in pst)
        pl.append(float(loss))
    np.testing.assert_allclose(pl, rl, **TOL)
    assert pl[-1] < pl[0]
    want = r.state()
    for k, v in p.state().items():
        np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)


# ---- the reference's traps, copied on purpose ---------------------------------

def test_trap_sequence_length_is_not_read():
    pl = tnn.GRU(3, 4, 2, device="cpu")
    x = torch.randn(2, 5, 3)
    a = pl(x)[0]
    b = pl(x, sequence_length=torch.tensor([1, 2]))[0]
    assert torch.equal(a, b)
    bi = tnn.BiRNN(tnn.GRUCell(3, 4, device="cpu"),
                   tnn.GRUCell(3, 4, device="cpu"))
    assert torch.equal(bi(x)[0], bi(x, sequence_length=[1, 2])[0])
    one = tnn.RNN(tnn.GRUCell(3, 4, device="cpu"))
    assert torch.equal(one(x)[0], one(x, None, [1, 2])[0])


def test_trap_stacks_drop_the_weight_attrs():
    attr = tnn.ParamAttr(initializer=tnn.initializer.Constant(0.5))
    for P in (tnn.LSTM, tnn.GRU, tnn.SimpleRNN):
        layer = P(3, 4, weight_ih_attr=attr, bias_hh_attr=attr,
                  device="cpu")
        assert not torch.all(layer.cells[0].weight_ih == 0.5)
    cell = tnn.LSTMCell(3, 4, weight_ih_attr=attr, device="cpu")
    assert torch.all(cell.weight_ih == 0.5)        # a cell reads them
    ref_layer = rnn_.LSTM(3, 4, weight_ih_attr=rnn_.ParamAttr(
        initializer=rnn_.initializer.Constant(0.5)))
    assert not np.all(np.asarray(ref_layer.cells[0].weight_ih.numpy())
                      == 0.5)


def test_trap_initial_states_are_float32_and_promote_bf16():
    cell = tnn.LSTMCell(3, 4, device="cpu").to(torch.bfloat16)
    x = torch.randn(2, 3).to(torch.bfloat16)
    assert cell.get_initial_states(x).dtype == torch.float32
    with port_dispatch.census() as c:
        h, (h2, c2) = cell(x)
    assert h.dtype == c2.dtype == torch.float32
    assert c["lstm_cell"] == [(("bfloat16", "float32", "float32",
                                "bfloat16", "bfloat16", "bfloat16",
                                "bfloat16"), ("float32", "float32"))]
    rcell = rnn_.LSTMCell(3, 4)
    assert np.dtype(rcell.get_initial_states(
        ref.to_tensor(np.zeros((2, 3), np.float32)).astype(
            "bfloat16")).dtype) == np.float32


def test_trap_beam_ids_int32_and_max_step_num_plus_one():
    """initialize makes int32 ids; dynamic_decode runs max_step_num + 1
    steps (no beam ends: the end token can never win); impute_finished and
    is_test are not read; the states returned are the last step's,
    not reordered by finalize."""
    _, p = _lm_pair(vocab=12, hidden=8)
    with torch.no_grad():
        p.fc.bias[1] = -1e4                          # the end token
    cell = _TwoCells(tnn.RNNCellBase, list(p.lstm.cells)).make()
    dec = tnn.BeamSearchDecoder(cell, 0, 1, 3, embedding_fn=p.embedding,
                                output_fn=p.fc)
    z = torch.zeros(2, 8)
    ids, _ = dec.initialize([(z, z), (z, z)])
    assert ids.dtype == torch.int32
    runs = [tnn.dynamic_decode(dec, [(z, z), (z, z)], max_step_num=5,
                               return_length=True, **kw)
            for kw in ({}, {"impute_finished": True, "is_test": True})]
    for seqs, states, lengths in runs:
        assert seqs.shape == (2, 6, 3) and lengths.eq(6).all()
    assert torch.equal(runs[0][0], runs[1][0])
    cell_states, log_probs, finished = runs[0][1]
    assert log_probs.shape == (2, 3) and not finished.any()
    assert cell_states[0][0].shape == (6, 8)


def test_layers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    port_place._default = torch.device("cuda")
    for make in (lambda: tnn.LSTM(3, 4), lambda: tnn.GRUCell(3, 4),
                 lambda: tnn.SimpleRNN(3, 4, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_trap_the_time_loop_is_python_one_op_a_step(monkeypatch):
    """The reference's RNN docstring speaks of ``lax.scan``, but its loop
    is a Python loop with one cell op a layer, direction and step; the
    port's is too, so the dispatched ops agree name for name and count
    for count (the amp casts and the census read them)."""
    from paddle_tpu.ops import dispatch as ref_dispatch
    names = []
    inner = ref_dispatch._apply_op_inner

    def spy(name, fn, args, kwargs, nondiff):
        names.append(name)
        return inner(name, fn, args, kwargs, nondiff)
    monkeypatch.setattr(ref_dispatch, "_apply_op_inner", spy)
    for R, P, op in ((rnn_.LSTM, tnn.LSTM, "lstm_cell"),
                     (rnn_.GRU, tnn.GRU, "gru_cell"),
                     (rnn_.SimpleRNN, tnn.SimpleRNN, "simple_rnn_cell")):
        rl = R(32, 32, 2, direction="bidirect")
        pl = _carry(rl, P(32, 32, 2, direction="bidirect", device="cpu"))
        x = np.random.default_rng(8).standard_normal((4, 3, 32)).astype(
            np.float32)
        names.clear()
        rl(ref.to_tensor(x))
        with port_dispatch.census() as c:
            pl(torch.from_numpy(x))
        want = {n: names.count(n) for n in set(names)}
        assert want[op] == 2 * 2 * 3
        assert {n: len(v) for n, v in c.items()} == want


def test_chip_smoke_rnn_checks_put_the_default_device_back():
    """chip_smoke.py's RNN checks run card against CPU by switching the
    default device; the phases after them build on the default, so they
    leave it as they found it (here a sentinel CPU device, run on the
    CPU)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    port_place._default = torch.device("cpu", 0)
    readings = smoke._reference_rnn(torch.device("cpu"))
    assert readings["rnn_ok"]
    assert port_place._default == torch.device("cpu", 0)
