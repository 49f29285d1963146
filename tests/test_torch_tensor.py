"""``to_tensor``, the device and places, ``Parameter``, the in-place
variants and the tensor methods of the PyTorch port, against the JAX
package on the CPU.

The method walk takes every public name of the reference ``Tensor`` and
puts it in one of three classes: attached to ``torch.Tensor`` by the port
(torch lacks it) and behaving as the reference's on a sample; torch's own
and behaving as the reference's on the same sample; or in ``CLASHES``,
the table of names whose torch meaning differs from Paddle's (README.md's
port section holds the same table). The samples are the op cases of
``torch_op_cases.py`` called as methods, or ``SAMPLES`` below.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
import paddle_tpu_torch.ops as port_ops
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.ops import tensor_methods

import test_torch_ops
import torch_op_cases as oc

jax.config.update("jax_platforms", "cpu")
ROOT = Path(__file__).resolve().parents[1]

# name -> how torch's meaning differs; the function form keeps Paddle's
CLASHES = {
    "shape": "torch.Size (a tuple), not a list",
    "size": "a method (x.size() / x.size(d)), not the element count",
    "dtype": "a torch.dtype, not a numpy dtype",
    "dim": "a method x.dim(), not the reference's property (= ndim)",
    "real": "a property, not a method: paddle.real(x)",
    "name": "torch's named-tensor name (None), not a generated name",
    "value": "not attached: a port tensor is its own value (the "
             "reference's raw jax.Array)",
    "einsum": "not attached: the equation comes first: paddle.einsum",
    "multiplex": "not attached: the inputs come first: paddle.multiplex",
    "numpy": "refuses a card tensor or one that needs a gradient: "
             "x.detach().cpu().numpy()",
    "to": "takes torch devices and dtypes, not 'tpu' or dtype names",
    "T": "reverses all axes, deprecated by torch beyond 2-d: paddle.t",
    "transpose": "x.transpose(d0, d1) swaps two axes: paddle.transpose(x, "
                 "perm)",
    "matmul": "no transpose_x / transpose_y: paddle.matmul",
    "solve": "removed from torch: paddle.solve",
    "broadcast_to": "takes size: paddle.broadcast_to(x, shape)",
    "max": "x.max(d) returns (values, indices): paddle.max(x, axis)",
    "min": "x.min(d) returns (values, indices): paddle.min(x, axis)",
    "median": "the lower middle and indices: paddle.median (the mean of "
              "the two)",
    "nanmedian": "as median: paddle.nanmedian",
    "mode": "the most frequent value and indices: paddle.mode (the "
            "reference's sorted middle)",
    "kthvalue": "returns (values, indices): paddle.kthvalue",
    "sort": "returns (values, indices): paddle.sort",
    "argsort": "int64, and descending is not the flip of the stable "
               "ascending order: paddle.argsort",
    "topk": "int64 indices: paddle.topk (int32)",
    "argmax": "int64 indices: paddle.argmax",
    "argmin": "int64 indices: paddle.argmin",
    "nonzero": "int64 indices: paddle.nonzero",
    "count_nonzero": "int64 counts and no keepdim: paddle.count_nonzero",
    "bincount": "int64 counts: paddle.bincount",
    "unique": "other outputs and order: paddle.unique",
    "gather": "x.gather(d, index) is take_along_axis: paddle.gather(x, "
              "index, axis)",
    "scatter": "x.scatter(d, index, src) is put_along_axis: "
               "paddle.scatter",
    "scatter_": "as scatter, in place: paddle.scatter_",
    "index_select": "x.index_select(dim, index): paddle.index_select(x, "
                    "index, axis)",
    "where": "x.where(condition, y): paddle.where(condition, x, y)",
    "unsqueeze": "one int axis only: paddle.unsqueeze(x, list)",
    "unsqueeze_": "as unsqueeze: paddle.unsqueeze_",
    "squeeze_": "a list of axes: paddle.squeeze_",
    "split": "sizes of the pieces (an int is a piece's size, not their "
             "count): paddle.split",
    "flip": "dims as a list: paddle.flip(x, axis)",
    "flatten": "start_dim / end_dim: paddle.flatten(x, start_axis, "
               "stop_axis)",
    "expand": "sizes as arguments: paddle.expand(x, shape)",
    "rot90": "dims: paddle.rot90(x, k, axes)",
    "diagonal": "offset / dim1 / dim2: paddle.diagonal",
    "trace": "2-d only, no offset: paddle.trace",
    "sum": "an int32 sum is int64: paddle.sum (int32)",
    "prod": "one axis only; an int32 product is int64: paddle.prod",
    "mean": "refuses integers: paddle.mean",
    "cumsum": "needs dim; an int32 sum is int64: paddle.cumsum",
    "logcumsumexp": "needs dim: paddle.logcumsumexp",
    "quantile": "q as a tensor, dim: paddle.quantile",
    "norm": "p and dim differ: paddle.norm",
    "dot": "1-d only: paddle.dot",
    "cov": "rowvar, ddof: paddle.cov",
    "equal": "a Python bool of the whole: paddle.equal (elementwise)",
    "histogram": "returns (hist, bin_edges): paddle.histogram",
    "slogdet": "returns (sign, logabsdet): paddle.slogdet (stacked)",
    "svd": "returns (U, S, V): paddle.svd (U, S, Vh)",
    "triangular_solve": "x.triangular_solve(A) solves A X = x: "
                        "paddle.triangular_solve",
    "imag": "refuses a real tensor: paddle.imag (zeros)",
    "clip_": "min / max keywords: paddle.clip_",
}


@pytest.fixture(autouse=True)
def on_cpu():
    prev = port_place._default
    port.set_device("cpu")
    yield
    port_place._default = prev


# ---- to_tensor, the device, places, Parameter ------------------------------

TO_TENSOR = [
    (3, {}), (2.5, {}), (True, {}), ([1, 2, 3], {}), ([[1.0, 2.0]], {}),
    (np.arange(4), {}), (np.arange(4, dtype=np.float64), {}),
    (np.ones(3, np.float16), {}), (np.ones(2, np.complex128), {}),
    (np.ones(3, np.uint8), {}), (np.array([True, False]), {}),
    ([1, 2], {"dtype": "int64"}), ([1, 2], {"dtype": "float64"}),
    (np.arange(3), {"dtype": "float32"}), (1.5, {"dtype": "bfloat16"}),
]


@pytest.mark.parametrize("i", range(len(TO_TENSOR)))
def test_to_tensor_dtypes_follow_the_reference(i):
    data, kw = TO_TENSOR[i]
    want = ref.to_tensor(data, **kw)
    got = port.to_tensor(data, **kw)
    assert got.device.type == "cpu" and not got.requires_grad
    assert str(got.dtype).removeprefix("torch.") == \
        np.dtype(want.dtype).name
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.numpy(), np.float32))


def test_to_tensor_copies_places_and_grads():
    t = torch.arange(3, dtype=torch.int64)
    c = port.to_tensor(t)
    assert c.dtype == torch.int64 and c.data_ptr() != t.data_ptr()
    g = port.to_tensor([1.0, 2.0], stop_gradient=False)
    assert g.requires_grad and g.stop_gradient is False
    assert port.to_tensor([1.0], place="cpu").device.type == "cpu"
    assert port.to_tensor([1.0], place=port.CPUPlace()).device.type == "cpu"
    with pytest.raises(TypeError):
        port.to_tensor(np.array(["a"]))


def test_set_device_get_device_and_places():
    assert port.set_device("cpu") == port.CPUPlace()
    ref.set_device("cpu")
    assert port.get_device() == ref.get_device() == "cpu:0"
    assert port.resolve_device(None).type == "cpu"
    assert port.zeros([2]).device.type == "cpu"
    assert port.CUDAPlace(1).torch_device == torch.device("cuda", 1)
    assert port.CUDAPinnedPlace() == port.CPUPlace()
    assert hash(port.CUDAPlace(0)) == hash(port.CUDAPlace(0))
    assert port.CUDAPlace(0) != port.CPUPlace()
    assert port.device_count() == 1
    if not torch.cuda.is_available():
        for name in ("gpu", "gpu:0", "cuda", port.CUDAPlace(0)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                port.set_device(name)
        assert port.get_device() == "cpu:0"
    with pytest.raises(ValueError):
        port.set_device("meta")
    assert torch.zeros(2).place == port.CPUPlace()


def test_default_float_dtype():
    assert port.get_default_dtype() == torch.float32
    try:
        port.set_default_dtype("float16")
        assert port.to_tensor(1.5).dtype == torch.float16
        assert port.ones([2]).dtype == torch.float16
        port.set_default_dtype("float64")       # the reference's x64-off
        assert port.get_default_dtype() == torch.float32
        with pytest.raises(TypeError):
            port.set_default_dtype("int32")
    finally:
        port.set_default_dtype("float32")
    assert port.finfo("bfloat16").eps == float(ref.finfo("bfloat16").eps)
    assert port.iinfo("int32").max == int(ref.iinfo("int32").max)


def test_parameter():
    p = port.Parameter(np.ones((2, 3), np.float32))
    rp = ref.Parameter(np.ones((2, 3), np.float32))
    assert isinstance(p, torch.nn.Parameter) and p.trainable == rp.trainable
    assert p.persistable and p.requires_grad and not p.stop_gradient
    p.trainable = False
    assert not p.requires_grad and p.stop_gradient
    q = port.Parameter(torch.zeros(3), trainable=False, name="w")
    assert not q.trainable and q.param_name == "w"
    m = torch.nn.Module()
    m.w = port.Parameter(torch.ones(2))
    assert [n for n, _ in m.named_parameters()] == ["w"]
    assert not port.Parameter(np.arange(3)).requires_grad   # int32


# ---- the in-place variants ---------------------------------------------------

INPLACE = {
    "reshape_": ([[3, 2]], {}), "squeeze_": ([], {"axis": [0]}),
    "unsqueeze_": ([[0, 2]], {}), "flatten_": ([], {}),
    "tanh_": ([], {}), "exp_": ([], {}), "sqrt_": ([], {}),
    "rsqrt_": ([], {}), "clip_": ([], {"min": 0.6, "max": 1.2}),
    "ceil_": ([], {}), "floor_": ([], {}), "round_": ([], {}),
    "reciprocal_": ([], {}), "scale_": ([], {"scale": 2.0, "bias": 1.0}),
    "zero_": ([], {}), "fill_": ([3.5], {}),
    "add_": ([np.float32(0.25)], {}), "subtract_": ([np.float32(0.5)], {}),
}


@pytest.mark.parametrize("name", sorted(INPLACE) + ["scatter_"])
def test_inplace_variant(name):
    x = np.random.default_rng(3).uniform(0.5, 2.0, (1, 2, 3)).astype(
        np.float32)
    if name == "scatter_":
        x = x[0]
        args, kw = [np.int32([1]), np.float32([[9.0, 8.0, 7.0]])], {}
    else:
        args, kw = INPLACE[name]
    r = ref.to_tensor(x)
    t = torch.from_numpy(x.copy())
    rargs = [ref.to_tensor(a) if isinstance(a, np.ndarray) and a.ndim
             else a for a in args]
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) and a.ndim
             else a for a in args]
    rout = getattr(ref.ops, name)(r, *rargs, **kw)
    tout = getattr(port_ops, name)(t, *targs, **kw)
    assert tout is t
    np.testing.assert_allclose(t.numpy(), np.asarray(rout.numpy()),
                               rtol=1e-6, atol=1e-6)
    assert tuple(t.shape) == tuple(rout.shape)


def test_inplace_reshape_keeps_the_parameter():
    w = torch.nn.Parameter(torch.ones(2, 3))
    port_ops.reshape_(w, [3, 2])
    assert w.shape == (3, 2) and w.requires_grad


# ---- the method walk --------------------------------------------------------

def _sample_from_cases(name):
    for cid in sorted(oc.CASES):
        if oc.fn_name(cid) != name:
            continue
        args, kw = oc.make_inputs(cid)
        if args and isinstance(args[0], np.ndarray):
            return cid, args, kw
    return None


def _attrs(n):
    return lambda t: getattr(t, n)


SAMPLES = {
    "astype": lambda t: t.astype("int64"),
    "cast": lambda t: t.cast("int64"),
    "stop_gradient": lambda t: np.asarray(t.stop_gradient),
    "persistable": lambda t: np.asarray(t.persistable),
    "ndim": lambda t: np.asarray(t.ndim),
    "dim": lambda t: np.asarray(t.dim()),
    "is_leaf": lambda t: np.asarray(t.is_leaf),
    "grad": lambda t: np.asarray(t.grad is None),
    "place": lambda t: np.asarray(str(t.place) == "Place(cpu:0)"),
    "concat": lambda t: t.concat(0),
    "slice": lambda t: t.slice([0, 1], [1, 0], [3, 2]),
    "clear_grad": lambda t: np.asarray(t.clear_grad() is None),
    "clear_gradient": lambda t: np.asarray(t.clear_gradient() is None),
    "block_until_ready": lambda t: t.block_until_ready(),
    "cpu": lambda t: t.cpu(),
    "detach": lambda t: t.detach(),
    "requires_grad_": lambda t: np.asarray(t.requires_grad_(True)
                                           .stop_gradient),
    "item": lambda t: np.asarray(t[0, 0].item()),
    "backward": lambda t: np.asarray(t.sum().backward() is None),
    "set_value": lambda t: (t.set_value(np.full((3, 4), 2.0, np.float32)),
                            t)[1],
    "copy_": lambda t: t.copy_(t * 0 + 3),
    "fill_": lambda t: t.fill_(1.5),
    "zero_": lambda t: t.zero_(),
    "add_": lambda t: t.add_(t * 0 + 0.5),
    "subtract_": lambda t: t.subtract_(t * 0 + 0.5),
    "scale_": lambda t: t.scale_(2.0, 1.0),
    "reshape_": lambda t: t.reshape_([4, 3]),
    "flatten_": lambda t: t.flatten_(),
}
for _n in ("exp_", "sqrt_", "rsqrt_", "tanh_", "ceil_", "floor_", "round_",
           "reciprocal_"):
    SAMPLES[_n] = (lambda n: lambda t: getattr(t, n)())(_n)


def _ref_tensor_names():
    return sorted(n for n in dir(ref.Tensor) if not n.startswith("_"))


def _to_np(o):
    if isinstance(o, torch.Tensor):
        return o.detach().float().numpy() if o.dtype == torch.bfloat16 \
            else o.detach().numpy()
    if isinstance(o, ref.Tensor):
        a = o.numpy()
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return None


class _Outs:
    def __init__(self, outs):
        self.outs = outs


def _same(name, rcall, tcall):
    """Whether the sample gives the reference's result on a port tensor;
    (bool, detail)."""
    try:
        r = rcall()
        want = r.outs if isinstance(r, _Outs) else oc.outputs_numpy(r, _to_np)
        got = oc.outputs_numpy(tcall(), _to_np)
        oc.compare(name, got, want, tol="trans") if name in oc.CASES else \
            _compare(got, want)
        return True, ""
    except Exception as e:   # a difference of any kind puts it in a class
        return False, f"{type(e).__name__}: {str(e)[:80]}"


def _compare(got, want):
    assert len(got) == len(want)
    for (g, gt), (w, wt) in zip(got, want):
        assert g.shape == w.shape
        if gt and wt:
            assert g.dtype == w.dtype
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), 1e-5, 1e-6)


def _walk():
    rows = {}
    x = oc.S(np.random.default_rng(11), 3, 4)
    for name in _ref_tensor_names():
        attached = name in tensor_methods._ATTACHED
        own = hasattr(torch.Tensor, name) and not attached
        if name in SAMPLES:
            fn = SAMPLES[name]

            def rcall(fn=fn):
                return fn(ref.to_tensor(x, stop_gradient=False))

            def tcall(fn=fn):
                return fn(torch.from_numpy(x.copy()).requires_grad_(
                    name not in INPLACE and not name.endswith("_")))
        else:
            found = _sample_from_cases(name)
            if found is None:
                rows[name] = (attached, own, False, "no sample")
                continue
            cid, args, kw = found
            rest = [a for a in args[1:]]

            def conv(v, mk):
                if isinstance(v, np.ndarray):
                    return mk(v)
                if isinstance(v, (list, tuple)) and v and isinstance(
                        v[0], np.ndarray):
                    return type(v)(mk(a) for a in v)
                return v

            def rcall(args=args, rest=rest, kw=kw, cid=cid):
                if getattr(ref.Tensor, name) is getattr(ref.ops,
                                                        oc.fn_name(cid)):
                    # the reference's method is its op: the op sweep's
                    # (batched) result
                    return _Outs(test_torch_ops.run_ref(cid, False)[0])
                t = ref.to_tensor(args[0])
                return getattr(t, name)(*[conv(a, ref.to_tensor)
                                          for a in rest],
                                        **{k: conv(v, ref.to_tensor)
                                           for k, v in kw.items()})

            def tcall(args=args, rest=rest, kw=kw):
                t = torch.from_numpy(args[0].copy())
                mk = torch.from_numpy
                return getattr(t, name)(*[conv(a, mk) for a in rest],
                                        **{k: conv(v, mk)
                                           for k, v in kw.items()})
        same, why = _same(name, rcall, tcall)
        rows[name] = (attached, own, same, why)
    return rows


def test_every_reference_tensor_name_is_classed():
    rows = _walk()
    assert len(rows) == 262
    unclassed = {n: r for n, r in rows.items()
                 if not ((r[0] or r[1]) and r[2]) and n not in CLASHES}
    assert unclassed == {}, unclassed
    # the table names torch's own methods (and the one name not attached)
    assert not set(CLASHES) & set(tensor_methods._ATTACHED)
    assert set(CLASHES) <= set(rows)
    attached_ok = [n for n, r in rows.items() if r[0] and r[2]]
    own_ok = [n for n, r in rows.items() if r[1] and r[2] and
              n not in CLASHES]
    assert len(attached_ok) >= 55 and len(own_ok) >= 40


def test_readme_holds_the_clash_table():
    text = (ROOT / "README.md").read_text()
    section = text[text.index("Tensor methods whose torch meaning"):]
    names = set(re.findall(r"^\| `([A-Za-z_0-9]+)` \|", section, re.M))
    assert set(CLASHES) <= names, sorted(set(CLASHES) - names)


def test_attached_names_never_replace_torch():
    before = {n: getattr(torch.Tensor, n) for n in dir(torch.Tensor)
              if n in ("transpose", "max", "sort", "gather", "size")}
    assert tensor_methods.install() == tensor_methods._ATTACHED
    for n, f in before.items():
        assert getattr(torch.Tensor, n) is f
    t = torch.randn(2, 3)
    assert t.transpose(0, 1).shape == (3, 2)
    assert t.max(1).indices.dtype == torch.int64
    assert t.stop_gradient and t.astype("float16").dtype == torch.float16
    t.stop_gradient = False
    assert t.requires_grad
    t.sum().backward()
    np.testing.assert_array_equal(t.gradient(), np.ones((2, 3), np.float32))
    t.clear_grad()
    assert t.grad is None and t.gradient() is None
    with pytest.raises(ValueError):
        t.set_value(np.ones(3))
