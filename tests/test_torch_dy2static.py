"""dy2static of the PyTorch port against the JAX package's.

Mirrors ``tests/test_dy2static.py`` case for case (21 cases): the same
functions go through both packages' ``convert_to_static`` and run on the
same numpy inputs, eagerly and captured (the reference under
``jax.jit``, the port under ``torch.export`` with the capture flag set),
float32 on both sides within 1e-5 absolute + 1e-5 relative. A tensor
``if`` / ``while`` under capture must hold ``torch.cond`` /
``while_loop`` in the exported graph; a concrete predicate runs
natively; a capture that cannot hold the control flow raises. The AST
pass is the reference's: ``code_of`` gives the reference's text for
every function here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu.core.tensor import Tensor as RTensor
from paddle_tpu.jit.dy2static import code_of as ref_code_of
from paddle_tpu.jit.dy2static import convert_to_static as ref_convert
from paddle_tpu.jit.dy2static import transformer as ref_transformer
from paddle_tpu_torch.core import place
from paddle_tpu_torch.jit.dy2static import capturing, code_of, \
    convert_to_static
from paddle_tpu_torch.jit.dy2static import transformer as port_transformer

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


def branchy(x):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def nested_if(x):
    if x.sum() > 0:
        if x.max() > 10:
            y = x * 100
        else:
            y = x * 2
    else:
        y = -x
    return y


def loopy(x, n):
    s = x
    i = 0
    while i < n:
        s = s + x
        i = i + 1
    return s


def for_range_loop(x):
    acc = x * 0
    for i in range(4):
        acc = acc + x * (i + 1)
    return acc


def logical_fn(x, flag):
    if flag and x.sum() > 0:
        r = x
    else:
        r = -x
    return r


def not_fn(x):
    if not (x.sum() > 0):
        r = x * 0
    else:
        r = x
    return r


def temp_in_loop(x, n):
    s = x * 0
    i = 0
    while i < n:
        t = x * 2          # pure temp, first defined inside the loop
        s = s + t
        i = i + 1
    return s


def early(x):
    if x.sum() > 0:
        return x
    return -x


def return_in_loop(x):
    for i in range(3):
        if i == 2:
            return x * i
    return x


def break_at_two(x):
    for i in range(5):
        if i == 2:
            break
    return x * i


def continue_odd(x):
    s = x * 0
    for i in range(5):
        if i % 2 == 1:
            continue
        s = s + x
    return s


def break_on_tensor(x):
    s = x * 0
    i = x.sum() * 0  # tensor counter -> captured while
    while i < 10:
        s = s + x
        if s.sum() >= 6:
            break
        i = i + 1
    return s


def nested_break_continue(x):
    s = x * 0
    for i in range(4):
        if i == 3:
            break
        for j in range(4):
            if j == 0:
                continue
            if j == 3:
                break
            s = s + x
    return s


def asserting(x):
    assert x.sum() > 0, "must be positive"
    return x * 2


def cast_and_len(x):
    n = len(x)          # static leading dim
    y = float(n) + x * 0
    z = int(x.sum())    # concrete eager -> python int
    return y, z


def cast_traced(x):
    return float(x > 0) * 2.0


def printing(x):
    print("value:", x)
    return x + 1


def to_static_loop(x):
    s = x * 0
    i = 0
    while i < 3:
        s = s + x
        i = i + 1
    if s.sum() > 100:
        s = s / 10
    return s


FUNCTIONS = [branchy, nested_if, loopy, for_range_loop, logical_fn, not_fn,
             temp_in_loop, early, return_in_loop, break_at_two, continue_odd,
             break_on_tensor, nested_break_continue, asserting, cast_and_len,
             cast_traced, printing, to_static_loop]


def _pair(fn):
    """(reference conversion, port conversion) from one counter value, so
    the generated names agree."""
    ref_transformer._COUNTER[0] = port_transformer._COUNTER[0] = 0
    return ref_convert(fn), convert_to_static(fn)


def _a(*v):
    return np.array(v, np.float32)


def _rt(a):
    return rp.to_tensor(a)


def _pt(a):
    return torch.from_numpy(np.asarray(a))


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    if isinstance(v, RTensor):
        return np.asarray(v._value)
    return np.asarray(v)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


def _capture(fn, *example):
    with torch.no_grad(), capturing():
        return torch.export.export(_Fn(fn), tuple(map(_pt, example)),
                                   strict=False)


def _ops(ep):
    """The operators of the program and of its branch / body graphs."""
    return {str(n.target) for m in ep.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"}


def _ref_jit(conv, *args):
    def run(*v):
        return jax.tree.map(
            lambda o: o._value if isinstance(o, RTensor) else o,
            conv(*[RTensor(a) for a in v]),
            is_leaf=lambda o: isinstance(o, RTensor))
    return jax.tree.map(np.asarray, jax.jit(run)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("fn", FUNCTIONS, ids=lambda f: f.__name__)
def test_code_of_is_the_references(fn):
    ref, port = _pair(fn)
    assert code_of(port) == ref_code_of(ref)


class TestConversion:
    def test_source_is_rewritten(self):
        _, conv = _pair(branchy)
        src = code_of(conv)
        assert "convert_ifelse" in src
        assert "__true_fn" in src and "__false_fn" in src

    def test_if_eager_parity(self):
        ref, conv = _pair(branchy)
        for a in (_a(1.0, 2.0), _a(-1.0, -2.0)):
            np.testing.assert_allclose(_np(conv(_pt(a))),
                                       _np(ref(_rt(a))), **TOL)
            np.testing.assert_allclose(_np(conv(_pt(a))),
                                       _np(branchy(_pt(a))), **TOL)

    def test_if_captures_torch_cond(self):
        ref, conv = _pair(branchy)
        ep = _capture(conv, np.zeros(2, np.float32))
        assert "cond" in _ops(ep)
        for a in (_a(1.0, 2.0), _a(-1.0, -2.0)):
            np.testing.assert_allclose(_np(ep.module()(_pt(a))),
                                       _ref_jit(ref, a), **TOL)

    def test_nested_if(self):
        ref, conv = _pair(nested_if)
        ep = _capture(conv, _a(1.0))
        for a in (_a(20.0), _a(1.0), _a(-1.0), _a(-3.0)):
            np.testing.assert_allclose(_np(conv(_pt(a))),
                                       _np(ref(_rt(a))), **TOL)
            np.testing.assert_allclose(_np(ep.module()(_pt(a))),
                                       _ref_jit(ref, a), **TOL)

    def test_while_tensor_bound_captures(self):
        ref, conv = _pair(loopy)
        x = _a(1.0, 2.0)
        np.testing.assert_allclose(_np(conv(_pt(x), 3)),
                                   _np(ref(_rt(x), 3)), **TOL)
        ep = _capture(conv, np.zeros(2, np.float32), np.asarray(3))
        assert "while_loop" in _ops(ep)
        got = ep.module()(_pt(x), _pt(np.asarray(5)))
        np.testing.assert_allclose(_np(got), _ref_jit(ref, x, np.int32(5)),
                                   **TOL)
        np.testing.assert_allclose(_np(got), [6.0, 12.0], **TOL)

    def test_for_range(self):
        ref, conv = _pair(for_range_loop)
        x = _a(1.0)
        np.testing.assert_allclose(_np(conv(_pt(x))), _np(ref(_rt(x))),
                                   **TOL)
        np.testing.assert_allclose(_np(conv(_pt(x))), [10.0], **TOL)

    def test_logicals(self):
        ref, conv = _pair(logical_fn)
        assert "convert_logical_and" in code_of(conv)
        x = _a(1.0)
        for flag in (True, False):
            np.testing.assert_allclose(_np(conv(_pt(x), flag)),
                                       _np(ref(_rt(x), flag)), **TOL)
        refn, convn = _pair(not_fn)
        assert "convert_logical_not" in code_of(convn)
        np.testing.assert_allclose(_np(convn(_pt(x))), _np(refn(_rt(x))),
                                   **TOL)

    def test_temp_var_in_loop(self):
        ref, conv = _pair(temp_in_loop)
        x = _a(1.0)
        np.testing.assert_allclose(_np(conv(_pt(x), 3)),
                                   _np(ref(_rt(x), 3)), **TOL)
        ep = _capture(conv, x, np.asarray(2))
        np.testing.assert_allclose(
            _np(ep.module()(_pt(x), _pt(np.asarray(4)))),
            _ref_jit(ref, x, np.int32(4)), **TOL)

    def test_return_canonicalized_to_ifelse(self):
        ref, conv = _pair(early)
        assert "convert_ifelse" in code_of(conv)
        np.testing.assert_allclose(_np(conv(_pt(_a(-2.0)))), [2.0], **TOL)
        ep = _capture(conv, _a(1.0))
        assert "cond" in _ops(ep)
        for a in (_a(3.0), _a(-2.0)):
            np.testing.assert_allclose(_np(ep.module()(_pt(a))),
                                       _ref_jit(ref, a), **TOL)

    def test_return_in_loop_stays_native(self):
        ref, conv = _pair(return_in_loop)
        x = _a(2.0)
        np.testing.assert_allclose(_np(conv(_pt(x))), _np(ref(_rt(x))),
                                   **TOL)
        np.testing.assert_allclose(_np(conv(_pt(x))), [4.0], **TOL)


class ControlFlowNet:
    """The reference test's network, built in either package."""

    @staticmethod
    def make(pkg):
        class Net(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(4, 4)

            def forward(self, x):
                h = self.fc(x)
                if h.sum() > 0:
                    out = h * 2
                else:
                    out = h * 0.5
                return out
        return Net()


class TestToStaticIntegration:
    def test_layer_with_control_flow(self):
        rnet = ControlFlowNet.make(rp)
        pnet = ControlFlowNet.make(tp)
        pnet.set_state_dict({k: np.asarray(v._value)
                             for k, v in rnet.state_dict().items()})
        x = np.random.default_rng(0).random((2, 4)).astype(np.float32)
        want = rp.jit.to_static(rnet).forward_static(_rt(x)).numpy()
        st = tp.jit.to_static(pnet)
        assert st is pnet
        got = st.forward_static(_pt(x))
        np.testing.assert_allclose(_np(got), want, **TOL)
        np.testing.assert_allclose(_np(got), _np(pnet(_pt(x))), **TOL)
        assert "cond" in _ops(st.forward_static
                                           .concrete_program)

    def test_function_to_static(self):
        rf = rp.jit.to_static(to_static_loop)
        pf = tp.jit.to_static(to_static_loop)
        for a in (np.full((2,), 100.0, np.float32), np.ones(2, np.float32)):
            np.testing.assert_allclose(_np(pf(_pt(a))), _np(rf(_rt(a))),
                                       **TOL)
        np.testing.assert_allclose(
            _np(pf(_pt(np.full((2,), 100.0, np.float32)))), [30.0, 30.0])
        assert pf.cache_stats()["misses"] == rf.cache_stats()["misses"]
        assert "cond" in _ops(pf.concrete_program)

    def test_translator_disable(self):
        pt = tp.jit.ProgramTranslator()
        pt.enable(False)
        try:
            @tp.jit.to_static
            def g(x):
                return x + 1
            np.testing.assert_allclose(_np(g(torch.ones(2))), [2.0, 2.0])
            assert g._converted_fn is None
        finally:
            pt.enable(True)


class TestBreakContinue:
    def test_break_leaves_induction_var_at_break_value(self):
        ref, conv = _pair(break_at_two)
        x = np.ones(2, np.float32)
        np.testing.assert_allclose(_np(conv(_pt(x))), _np(ref(_rt(x))),
                                   **TOL)
        np.testing.assert_allclose(_np(conv(_pt(x))), [2.0, 2.0])

    def test_continue_in_for_range(self):
        ref, conv = _pair(continue_odd)
        x = np.ones(2, np.float32)
        np.testing.assert_allclose(_np(conv(_pt(x))), _np(ref(_rt(x))),
                                   **TOL)
        np.testing.assert_allclose(_np(conv(_pt(x))), [3.0, 3.0])

    def test_break_on_tensor_condition_captures(self):
        ref, conv = _pair(break_on_tensor)
        x = np.full((2,), 1.0, np.float32)
        ep = _capture(conv, x)
        assert {"while_loop",
                "cond"} <= _ops(ep)
        got = _np(ep.module()(_pt(x)))
        np.testing.assert_allclose(got, _ref_jit(ref, x), **TOL)
        # s grows by 2 per iteration; stops once sum >= 6: 3 iterations
        np.testing.assert_allclose(got, [3.0, 3.0])
        np.testing.assert_allclose(_np(conv(_pt(x))), [3.0, 3.0])

    def test_nested_break_continue(self):
        ref, conv = _pair(nested_break_continue)
        x = np.ones(2, np.float32)
        np.testing.assert_allclose(_np(conv(_pt(x))), _np(ref(_rt(x))),
                                   **TOL)
        np.testing.assert_allclose(_np(conv(_pt(x))), [6.0, 6.0])


class TestStmtConverters:
    def test_assert_native_and_captured(self):
        _, conv = _pair(asserting)
        x = np.ones(2, np.float32)
        np.testing.assert_allclose(_np(conv(_pt(x))), [2.0, 2.0])
        with pytest.raises(AssertionError, match="must be positive"):
            conv(_pt(-x))
        ep = _capture(conv, x)
        assert "paddle_tpu_torch.dy2static_assert.default" in _ops(ep)
        np.testing.assert_allclose(_np(ep.module()(_pt(x))), [2.0, 2.0])
        # the captured assert runs with the program
        with pytest.raises(AssertionError, match="must be positive"):
            ep.module()(_pt(-x))

    def test_cast_and_len(self):
        ref, conv = _pair(cast_and_len)
        x = np.ones(3, np.float32)
        y, z = conv(_pt(x))
        ry, rz = ref(_rt(x))
        np.testing.assert_allclose(_np(y), _np(ry), **TOL)
        assert z == rz == 3 and isinstance(z, int)

    def test_cast_under_capture(self):
        ref, conv = _pair(cast_traced)
        ep = _capture(conv, np.asarray(3.0, np.float32))
        got = ep.module()(_pt(np.asarray(3.0, np.float32)))
        assert float(got) == float(_ref_jit(ref, np.float32(3.0))) == 2.0

    def test_print_captured_does_not_break(self, capsys):
        _, conv = _pair(printing)
        x = np.ones(2, np.float32)
        ep = _capture(conv, x)
        capsys.readouterr()
        np.testing.assert_allclose(_np(ep.module()(_pt(x))), [2.0, 2.0])
        # the captured print runs with the program
        assert "value: tensor([1., 1.])" in capsys.readouterr().out
        conv(_pt(np.zeros(1, np.float32)))
        assert "value:" in capsys.readouterr().out


def test_capture_that_cannot_hold_the_flow_raises():
    """A tensor ``if`` left native (a return inside a loop) has no value
    to branch on under capture: the export raises, nothing re-runs
    eagerly."""
    def f(x):
        for i in range(3):
            if x.sum() > i:
                return x * i
        return x

    with pytest.raises(Exception, match="(?i)data.dependent|guard"):
        _capture(convert_to_static(f), np.ones(2, np.float32))


def test_missing_while_loop_is_refused_by_name(monkeypatch):
    import importlib
    hop = importlib.import_module("torch._higher_order_ops.while_loop")
    monkeypatch.delattr(hop, "while_loop")
    _, conv = _pair(loopy)
    with pytest.raises(NotImplementedError, match="while_loop"):
        _capture(conv, np.zeros(2, np.float32), np.asarray(3))


def _flow_case(pkg, op):
    """One function per control-flow op of ``pkg`` (``paddle.cond``,
    ``while_loop``, ``case``, ``switch_case``) on a tensor x and a
    tensor index k."""
    def run(x, k):
        if op == "cond":
            return pkg.cond(x.sum() > 0, lambda a: a * 2, lambda a: a - 1, x)
        if op == "while_loop":
            return pkg.while_loop(lambda i, s: i < k,
                                  lambda i, s: [i + 1, s + x],
                                  [k * 0, x * 0])[1]
        if op == "case":
            return pkg.case([(x.sum() > 10, lambda: x * 10),
                             (x.sum() > 0, lambda: x * 2)],
                            default=lambda: -x)
        return pkg.switch_case(k, [lambda: x + 1, lambda: x * 3,
                                   lambda: x - 5])
    return run


@pytest.mark.parametrize("op", ["cond", "while_loop", "case",
                                "switch_case"])
def test_control_flow_ops_captured(op):
    """``paddle.cond`` / ``while_loop`` / ``case`` / ``switch_case``
    under capture become ``torch.cond`` / ``while_loop`` and give the
    reference's values: against its ``jax.jit`` run where it traces
    (``lax.cond`` / ``while_loop`` / ``switch`` of the clipped index),
    against its eager run for ``case``, which the reference cannot
    trace (it reads the predicate's value)."""
    port = _flow_case(tp, op)
    ref = _flow_case(rp, op)
    inputs = [(_a(1.0, 2.0), 1), (_a(-1.0, -2.0), 2), (_a(6.0, 7.0), 5),
              (_a(-3.0, 1.0), -1)]
    ep = _capture(port, *inputs[0][:1], np.asarray(inputs[0][1]))
    want_op = "while_loop" if op == "while_loop" else "cond"
    assert want_op in _ops(ep)
    for x, k in inputs:
        got = _np(ep.module()(_pt(x), _pt(np.asarray(k))))
        if op == "case":
            want = _np(ref(_rt(x), _rt(np.asarray(k))))
        else:
            want = _ref_jit(lambda a, b: ref(a, b), x, np.int32(k))
        np.testing.assert_allclose(got, want, **TOL)
        if op != "switch_case" or 0 <= k < 3:
            # eagerly an index out of range raises (no default given)
            eager = port(_pt(x), _pt(np.asarray(k)))
            np.testing.assert_allclose(_np(eager), got, **TOL)
