"""The op namespace of the PyTorch port against the JAX package, on the
CPU: every op of ``OP_REGISTRY`` and every other public function of the
namespace (one case each, inputs and tolerances in ``torch_op_cases.py``,
made from a per-case seeded generator), its values and dtypes and, for a
differentiable op, the gradients of its float inputs under a fixed random
cotangent (the reference's tape, which is ``jax.vjp`` of its op, against
torch's autograd) within 1e-5 abs + 1e-5 rel. Then the registry names,
the spec table's 16 ops and ``infer_meta``, the control flow, the
TensorArray, and the random ops' shapes, dtypes, ranges, moments and
seeding.
"""
import functools
import zlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.ops as ref_ops
import paddle_tpu_torch as port
import paddle_tpu_torch.ops as port_ops
from paddle_tpu_torch.core import place as port_place

import torch_op_cases as oc

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def on_cpu():
    prev = port_place._default
    port.set_device("cpu")
    yield
    port_place._default = prev


_HOST_SIDE = (jax.errors.JAXTypeError, jax.errors.ConcretizationTypeError,
              jax.errors.NonConcreteBooleanIndexError, TypeError,
              AttributeError)


@functools.lru_cache(maxsize=None)
def _ref_all():
    """{case id: (outputs, gradients)} of every case whose reference op
    traces, all computed by one jitted program (one compile for the
    sweep, not one per case or per primitive of the eager tape); the
    others (host-side ops) run eagerly in ``run_ref``."""
    progs = {}
    for cid in sorted(oc.CASES):
        try:
            progs[cid] = _ref_program(cid, oc.wants_grad(cid))
        except _HOST_SIDE:
            pass
    outs = jax.jit(lambda ins: {c: progs[c][0](*ins[c]) for c in progs})(
        {c: p[1] for c, p in progs.items()})
    return {c: ([(_np(o), True) for o in out],
                None if grads is None else [np.asarray(g) for g in grads])
            for c, (out, grads) in outs.items()}


def _ref_program(cid, grad):
    """(fn, inputs): fn(*inputs) gives the reference op's outputs and,
    with ``grad``, its float inputs' gradients through ``jax.vjp`` under
    the case's cotangents; raises where the op does not trace."""
    args, kw = oc.make_inputs(cid)
    floats = [a for a in oc._leaves(list(args) + list(kw.values()))
              if isinstance(a, np.ndarray) and a.dtype == np.float32]

    def forward(*vals):
        it = iter(vals)

        def conv(v):
            if isinstance(v, oc.Raw):
                return v.a
            if isinstance(v, np.ndarray):
                return ref.Tensor(next(it)) if v.dtype == np.float32 \
                    else ref.to_tensor(v)
            if isinstance(v, (list, tuple)) and not (
                    v and isinstance(v[0], str)):
                return type(v)(conv(x) for x in v)
            return v
        out = oc.op_fn(ref_ops, cid)(
            *[conv(a) for a in args], **{k: conv(v) for k, v in kw.items()})
        return [o._value for o in oc._leaves(out)]

    shapes = jax.eval_shape(forward, *floats)
    if not grad:
        return (lambda *v: (forward(*v), None)), floats
    outs = [(np.zeros(s.shape, s.dtype), True) for s in shapes]
    cots = [jax.numpy.asarray(c) if c is not None else
            jax.numpy.zeros(s.shape, s.dtype) if jax.numpy.issubdtype(
                s.dtype, jax.numpy.inexact) else
            np.zeros(s.shape, jax.dtypes.float0)
            for c, s in zip(oc.cotangents(cid, outs), shapes)]

    def run(*vals):
        out, vjp = jax.vjp(forward, *vals)
        return out, vjp(cots)
    return run, floats


def _np(o):
    a = np.asarray(o)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def run_ref(cid, grad):
    batched = _ref_all()
    if cid in batched:
        return batched[cid]
    args, kw = oc.make_inputs(cid)         # a host-side op: eagerly
    leaves = []

    def conv(v):
        if isinstance(v, oc.Raw):
            return v.a
        if isinstance(v, np.ndarray):
            t = ref.to_tensor(v, stop_gradient=not (
                grad and v.dtype == np.float32))
            if not t.stop_gradient:
                leaves.append(t)
            return t
        if isinstance(v, (list, tuple)) and not (v and isinstance(v[0],
                                                                  str)):
            return type(v)(conv(x) for x in v)
        return v
    fn = oc.op_fn(ref_ops, cid)
    if args and isinstance(args[0], tuple) and args[0] and \
            args[0][0] == "lu":
        packed, piv = ref_ops.lu(ref.to_tensor(args[0][1]))
        out = fn(packed, piv)
    else:
        out = fn(*[conv(a) for a in args],
                 **{k: conv(v) for k, v in kw.items()})

    def to_np(o):
        if isinstance(o, ref.Tensor):
            a = o.numpy()
            return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        if isinstance(o, jax.Array):
            return np.asarray(o)
        return None
    outs = oc.outputs_numpy(out, to_np)
    if not grad:
        return outs, None
    tens = [o for o in oc._leaves(out) if isinstance(o, ref.Tensor)]
    cots = [c for c, (_, isT) in zip(oc.cotangents(cid, outs), outs) if isT]
    loss = None
    for t, c in zip(tens, cots):
        if c is not None:
            term = (t * ref.to_tensor(c)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return outs, [np.zeros(x.shape, np.float32) if x.grad is None
                  else x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("cid", sorted(oc.CASES))
def test_op_against_reference(cid):
    grad = oc.wants_grad(cid)
    want, want_g = run_ref(cid, grad)
    got, got_g = run_port(cid, grad)
    oc.compare(cid, got, want)
    if grad:
        atol, rtol = oc.GRAD_TOL
        assert len(got_g) == len(want_g)
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=cid)


def run_port(cid, grad):
    return oc.run_port(port_ops, cid, "cpu", grad)


def test_every_public_function_has_a_case():
    """Each public function of the port's namespace and of ``fft`` is held
    by a case, by the random ops' tests or by its own test; and so is
    every registry op."""
    covered = {oc.fn_name(c) for c in oc.CASES} | set(oc.RANDOM) \
        | set(oc.OWN_TESTS)
    public = set(port_ops.__all__) - {"OP_REGISTRY", "apply_op", "def_op",
                                      "infer_meta"}
    public |= {f"fft.{n}" for n in port.fft.__all__}
    assert public - covered == set()
    reg = {getattr(oc.op_fn(port_ops, c), "op_name", oc.fn_name(c))
           for c in oc.CASES} | {getattr(port_ops, n).op_name
                                 for n in oc.OWN_TESTS + oc.RANDOM
                                 if hasattr(getattr(port_ops, n), "op_name")}
    assert set(port_ops.OP_REGISTRY) - reg - {"unstack"} == set()
    assert len(oc.CASES) > 300


def test_registry_names_equal_the_reference():
    ref_names = set(ref_ops.OP_REGISTRY)
    port_names = set(port_ops.OP_REGISTRY)
    assert port_names == ref_names and len(port_names) == 251


def test_unstack_registry_placeholder_trap():
    """Deliberate: as in the reference, OP_REGISTRY["unstack"] is an
    identity placeholder while ops.unstack is unbind."""
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    for ops, mk in ((ref_ops, ref.to_tensor), (port_ops, torch.from_numpy)):
        np.testing.assert_array_equal(
            np.asarray(ops.OP_REGISTRY["unstack"](mk(x)).numpy()), x)
        assert len(ops.unstack(mk(x))) == 3


def test_mode_is_the_sorted_middle_trap():
    """Deliberate: ``mode`` is the reference's middle element of the
    sorted axis, not the most frequent value."""
    x = np.float32([[1, 1, 1, 5, 9]])
    assert float(ref_ops.mode(ref.to_tensor(x)).numpy()[0]) == 1.0
    x = np.float32([[7, 7, 3, 4, 5]])
    assert float(port_ops.mode(torch.from_numpy(x))[0]) == 5.0
    assert float(ref_ops.mode(ref.to_tensor(x)).numpy()[0]) == 5.0


SPEC_OPS = ("logaddexp2", "rot90_k2", "sinc", "i0", "i1", "polygamma",
            "xlogy", "ldexp", "vander", "trapezoid", "unwrap", "diff",
            "cummax", "cummin", "renorm", "frexp")


def test_spec_table_and_infer_meta():
    from paddle_tpu_torch.ops import codegen
    misc = [s["op"] for s in codegen.SPECS if s["group"] == "misc"]
    assert tuple(misc) == SPEC_OPS
    groups = {s["group"] for s in codegen.SPECS}
    assert groups == {"misc", "math", "activation"}
    for name in SPEC_OPS:
        assert port_ops.OP_REGISTRY[name] is getattr(port_ops, name)
        args, kw = oc.make_inputs(name)
        arrays = [a for a in args if isinstance(a, np.ndarray)]
        want = ref.ops.infer_meta(name, *[ref.to_tensor(a) for a in arrays],
                                  **kw)
        got = port_ops.infer_meta(name, *[torch.from_numpy(a)
                                          for a in arrays], **kw)
        want = want if isinstance(want, (tuple, list)) else [want]
        got = got if isinstance(got, (tuple, list)) else [got]
        for g, w in zip(got, want):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), name
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
    got = port_ops.infer_meta("add", ((2, 3), torch.float32),
                              ((3,), torch.int32))
    assert tuple(got.shape) == (2, 3) and got.dtype == torch.float32
    with pytest.raises(KeyError):
        port_ops.infer_meta("no_such_op", torch.zeros(1))
    # attributes positionally after the tensors, as the reference's
    x = torch.tensor([-1.0, 2.0])
    assert port_ops.leaky_relu(x, 0.5).tolist() == [-0.5, 2.0]
    with pytest.raises(TypeError):
        port_ops.leaky_relu(x, 0.5, negative_slope=0.1)
    with pytest.raises(TypeError):
        port_ops.leaky_relu(x, 0.5, 1.0)


def test_control_flow_eager():
    t = torch.tensor(3.0, requires_grad=True)
    out = port.cond(t > 2, lambda: t * 2, lambda: t * 3)
    out.backward()
    assert float(out) == 6.0 and float(t.grad) == 2.0
    assert float(port.cond(torch.tensor(False), lambda a: a + 1,
                           lambda a: a - 1, torch.tensor(5.0))) == 4.0
    i, s = port.while_loop(lambda i, s: i < 5, lambda i, s: (i + 1, s + i),
                           [torch.tensor(0), torch.tensor(0)])
    ri, rs = ref.while_loop(lambda i, s: i < 5, lambda i, s: (i + 1, s + i),
                            [ref.to_tensor(0), ref.to_tensor(0)])
    assert (int(i), int(s)) == (int(ri.numpy()), int(rs.numpy())) == (5, 10)
    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    carry, ys = port.scan(lambda c, x: (c + x.sum(), c * 2),
                          torch.tensor(0.0), torch.from_numpy(xs))
    rc, rys = ref.scan(lambda c, x: (c + x.sum(), c * 2),
                       ref.to_tensor(np.float32(0)), ref.to_tensor(xs))
    assert float(carry) == float(rc.numpy())
    np.testing.assert_array_equal(ys.numpy(), rys.numpy())
    fns = [lambda: 10, lambda: 20]
    assert port.case([(torch.tensor(False), fns[0]),
                      (torch.tensor(True), fns[1])]) == 20
    assert port.case([(False, fns[0])], default=lambda: 30) == 30
    assert port.switch_case(torch.tensor(1), fns) == 20
    assert port.switch_case(5, {1: fns[0], 3: fns[1]},
                            default=lambda: 7) == 7
    with pytest.raises(ValueError):
        port.case([(False, fns[0])])
    with pytest.raises(IndexError):
        port.switch_case(4, fns)


def test_tensor_array():
    arr = port_ops.create_array("float32")
    port_ops.array_write(torch.ones(2), 0, arr)
    port_ops.array_write(torch.zeros(2), torch.tensor(1), arr)
    port_ops.array_write(torch.full((2,), 3.0), 0, arr)
    assert port_ops.array_read(arr, 0).tolist() == [3.0, 3.0]
    n = port_ops.array_length(arr)
    rarr = ref_ops.create_array("float32")
    ref_ops.array_write(ref.to_tensor(np.ones(2, np.float32)), 0, rarr)
    ref_ops.array_write(ref.to_tensor(np.zeros(2, np.float32)), 1, rarr)
    rn = ref_ops.array_length(rarr)
    assert int(n) == int(rn.numpy()) == 2
    assert str(n.dtype).removeprefix("torch.") == str(rn.numpy().dtype)
    with pytest.raises(IndexError):
        port_ops.array_write(torch.ones(1), 5, arr)


def test_increment_and_create_parameter():
    x = torch.tensor([1], dtype=torch.int32)
    assert port_ops.increment(x, 2.0) is x and x.tolist() == [3]
    p = port_ops.create_parameter([4, 3], "float32", name="w")
    rp = ref_ops.create_parameter([4, 3], "float32")
    assert isinstance(p, port.Parameter) and p.trainable
    assert tuple(p.shape) == tuple(rp.shape) and p.dtype == torch.float32
    assert float(p.abs().max()) <= np.sqrt(6.0 / 4)
    b = port_ops.create_parameter([3], "int64")
    assert b.dtype == torch.int32 and b.abs().sum() == 0


# ---- the random ops ---------------------------------------------------------

def _draws(make):
    port.seed(1234)
    a = make()
    port.seed(1234)
    b = make()
    port.seed(99)
    c = make()
    return a, b, c


RANDOM_CASES = {
    # name: (make, (dtype, shape), (lo, hi) or None, (mean, std) or None)
    "rand": (lambda: port_ops.rand([4000]), (torch.float32, (4000,)),
             (0, 1), (0.5, 1 / np.sqrt(12))),
    "uniform": (lambda: port_ops.uniform([4000], min=-2.0, max=3.0),
                (torch.float32, (4000,)), (-2, 3), (0.5, 5 / np.sqrt(12))),
    "randn": (lambda: port_ops.randn([4000]), (torch.float32, (4000,)),
              None, (0.0, 1.0)),
    "standard_normal": (lambda: port_ops.standard_normal([4000]),
                        (torch.float32, (4000,)), None, (0.0, 1.0)),
    "normal": (lambda: port_ops.normal(2.0, 3.0, [4000]),
               (torch.float32, (4000,)), None, (2.0, 3.0)),
    "randint": (lambda: port_ops.randint(-3, 5, [4000]),
                (torch.int32, (4000,)), (-3, 4), (0.5, np.sqrt(63 / 12))),
    "randint_like": (lambda: port_ops.randint_like(
        torch.zeros(4000, dtype=torch.float32), 0, 10),
        (torch.float32, (4000,)), (0, 9), (4.5, np.sqrt(99 / 12))),
    "randperm": (lambda: port_ops.randperm(4000), (torch.int32, (4000,)),
                 (0, 3999), None),
    "bernoulli": (lambda: port_ops.bernoulli(torch.full((4000,), 0.3)),
                  (torch.float32, (4000,)), (0, 1), (0.3, np.sqrt(0.21))),
    "poisson": (lambda: port_ops.poisson(torch.full((4000,), 4.0)),
                (torch.float32, (4000,)), (0, None), (4.0, 2.0)),
    "multinomial": (lambda: port_ops.multinomial(
        torch.tensor([0.1, 0.2, 0.7]), 4000, replacement=True),
        (torch.int32, (4000,)), (0, 2), (1.6, np.sqrt(0.44))),
}


@pytest.mark.parametrize("name", sorted(RANDOM_CASES))
def test_random_op(name):
    """Shape and dtype equal the reference's; the range holds; mean and
    std within 5 standard errors (4000 draws: 0.08 std for the mean) of
    the distribution's; the same seed gives the same draws, another seed
    others."""
    make, (dtype, shape), rng, moments = RANDOM_CASES[name]
    a, b, c = _draws(make)
    assert a.dtype == dtype and tuple(a.shape) == shape
    assert torch.equal(a, b) and not torch.equal(a, c)
    if rng is not None:
        assert float(a.min()) >= rng[0]
        if rng[1] is not None:
            assert float(a.max()) <= rng[1]
    if moments is not None:
        m, s = moments
        af = a.double()
        assert abs(float(af.mean()) - m) < 5 * s / np.sqrt(a.numel())
        assert abs(float(af.std()) - s) < 0.05 * s + 0.02
    if name == "randperm":
        assert sorted(a.tolist()) == list(range(4000))
    ref_out = {"rand": lambda: ref_ops.rand([4000]),
               "randint": lambda: ref_ops.randint(-3, 5, [4000]),
               "randperm": lambda: ref_ops.randperm(4000),
               "multinomial": lambda: ref_ops.multinomial(
                   ref.to_tensor(np.float32([0.1, 0.2, 0.7])), 4000,
                   replacement=True)}.get(name)
    if ref_out is not None:
        r = ref_out().numpy()
        assert r.dtype == a.numpy().dtype and r.shape == tuple(a.shape)


def test_multinomial_without_replacement_and_seeded_uniform():
    port.seed(5)
    m = port_ops.multinomial(torch.tensor([[0.2, 0.3, 0.5, 0.0]]), 3)
    assert sorted(m[0].tolist()) == [0, 1, 2]
    a = port_ops.uniform([8], seed=7)
    b = port_ops.uniform([8], seed=7)
    assert torch.equal(a, b)


def test_case_inputs_do_not_depend_on_order():
    cid = "gather"
    a = oc.make_inputs(cid)[0][0]
    oc.make_inputs("reshape")
    assert np.array_equal(a, oc.make_inputs(cid)[0][0])
    assert oc.rng_for(cid).integers(1 << 30) == np.random.default_rng(
        zlib.crc32(cid.encode())).integers(1 << 30)
