"""The port's autograd API, initializers and ``ParamAttr`` against the
JAX package's, on the same numpy inputs:

* ``grad`` (a list of gradients, ``.grad`` untouched, the reference's
  RuntimeError for an unused input and None with ``allow_unused``, and
  no second-order graph whatever ``create_graph`` says, as the
  reference's tape builds none), ``backward`` with seeds, ``no_grad`` /
  ``enable_grad`` / ``set_grad_enabled``, the post-backward hooks;
* a ``PyLayer`` with a custom backward (the gradient is the custom one,
  not the forward's derivative), ``saved_tensor`` as the reference's
  property and as Paddle's method, a non-tensor argument, instantiation
  refused;
* the initializers: ``Constant``, ``Assign``, ``Dirac``, ``Bilinear``,
  ``calculate_gain`` and ``_fan_in_out`` exactly; the random ones
  (``Normal``, ``TruncatedNormal``, ``Uniform``, Xavier, Kaiming,
  ``Orthogonal``) by their bounds and moments, since JAX's and torch's
  generators differ; the device rule;
* ``ParamAttr`` honoured by the layers in the reference's positions
  (``Linear``, ``Embedding``, ``Conv2D``, ``LayerNorm``, ``RMSNorm``,
  ``BatchNorm1D``): the initializer, ``trainable=False``, ``False`` for
  no parameter, ``Embedding``'s XavierNormal under a ``weight_attr``
  without an initializer; ``set_global_initializer`` read by no layer.

Tolerance: exact where both compute the same closed form; the moments
within 5 standard errors of the sample.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import autograd as ref_autograd
from paddle_tpu import nn as ref_nn
from paddle_tpu.nn import initializer as ref_init
import paddle_tpu_torch as ptt
from paddle_tpu_torch import autograd as port_autograd
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as port_init


def test_grad_matches_jax_and_refuses_an_unused_input():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([0.5, -1.0, 2.0], np.float32)
    rx = paddle.to_tensor(a, stop_gradient=False)
    ry = paddle.to_tensor(b, stop_gradient=False)
    rz = paddle.to_tensor(b, stop_gradient=False)
    tx, ty, tz = (torch.from_numpy(v.copy()).requires_grad_()
                  for v in (a, b, b))
    r_out = (rx * rx * ry).sum()
    t_out = (tx * tx * ty).sum()
    rg = ref_autograd.grad(r_out, [rx, ry], create_graph=True,
                           retain_graph=True)
    tg = port_autograd.grad(t_out, [tx, ty], create_graph=True,
                            retain_graph=True)
    for r, t in zip(rg, tg):
        np.testing.assert_allclose(t.numpy(), r.numpy(), rtol=1e-6)
    # no second-order graph, as the reference's tape builds none
    assert not any(t.requires_grad for t in tg)
    assert all(r.stop_gradient for r in rg)
    assert tx.grad is None and rx.grad is None
    with pytest.raises(RuntimeError, match="allow_unused"):
        ref_autograd.grad((rx * ry).sum(), [rx, rz])
    with pytest.raises(RuntimeError, match="allow_unused"):
        port_autograd.grad((tx * ty).sum(), [tx, tz])
    rg = ref_autograd.grad((rx * ry).sum(), [rx, rz], allow_unused=True)
    tg = port_autograd.grad((tx * ty).sum(), [tx, tz], allow_unused=True)
    assert rg[1] is None and tg[1] is None
    np.testing.assert_allclose(tg[0].numpy(), rg[0].numpy())


def test_backward_grad_modes_and_post_backward_hooks():
    calls = []
    handle = port_autograd.register_post_backward_hook(
        lambda: calls.append(1))
    x = torch.ones(3, requires_grad=True)
    port_autograd.backward([x * 2.0], [torch.tensor([1.0, 2.0, 3.0])])
    assert x.grad.tolist() == [2.0, 4.0, 6.0] and calls == [1]
    port_autograd.grad((x * x).sum(), x)
    assert calls == [1, 1]
    handle.remove()
    port_autograd.backward((x * 3.0).sum())
    assert calls == [1, 1] and x.grad.tolist() == [5.0, 7.0, 9.0]
    with port_autograd.no_grad():
        assert not port_autograd.grad_enabled()
        with port_autograd.enable_grad():
            assert port_autograd.grad_enabled()
            assert (x * 2).requires_grad
        assert not (x * 2).requires_grad
    ptt.set_grad_enabled(False)
    try:
        assert not (x * 2).requires_grad
    finally:
        ptt.set_grad_enabled(True)
    with ptt.set_grad_enabled(False):
        assert not (x * 2).requires_grad
    assert (x * 2).requires_grad
    # the reference's, for the same three switches
    with paddle.no_grad():
        assert not ref_autograd.grad_enabled()
        with ref_autograd.enable_grad():
            assert ref_autograd.grad_enabled()


def _clip_layer(pkg):
    class ClipGrad(pkg.PyLayer):
        """Forward x * scale (a non-tensor argument); backward the
        incoming gradient clipped to [-1, 1] times the saved y, not the
        derivative."""

        @staticmethod
        def forward(ctx, x, scale, y):
            ctx.save_for_backward(y)
            return x * scale

        @staticmethod
        def backward(ctx, g):
            (y,) = ctx.saved_tensor
            return g.clip(-1.0, 1.0) * y, None
    return ClipGrad


def test_pylayer_custom_backward_matches_jax():
    from paddle_tpu.autograd import py_layer as ref_py_layer

    a = np.array([0.5, -2.0, 3.0], np.float32)
    y = np.array([2.0, 3.0, -1.0], np.float32)
    gout = np.array([4.0, 0.25, -3.0], np.float32)
    RefClip = _clip_layer(ref_py_layer)
    rx = paddle.to_tensor(a, stop_gradient=False)
    r = RefClip.apply(rx, 3.0, paddle.to_tensor(y))
    (r * paddle.to_tensor(gout)).sum().backward()
    PortClip = _clip_layer(ptt)
    tx = torch.from_numpy(a.copy()).requires_grad_()
    t = PortClip.apply(tx, 3.0, torch.from_numpy(y))
    (t * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(t.detach().numpy(), r.numpy())
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy())
    assert tx.grad.tolist() == [2.0, 0.75, 1.0]
    with pytest.raises(RuntimeError, match="apply"):
        PortClip()
    ctx = ptt.PyLayerContext()
    ctx.save_for_backward(tx)
    assert ctx.saved_tensor() == ctx.saved_tensor == ctx.saved_tensors()
    assert port_autograd.LegacyPyLayer.__mro__[1] is ptt.PyLayer


INIT_SHAPES = [(6, 4), (5,), (4, 3, 3, 3), (8, 2, 5)]


@pytest.mark.parametrize("shape", INIT_SHAPES, ids=str)
def test_fan_rule_and_exact_initializers_match_jax(shape):
    assert port_init._fan_in_out(shape) == ref_init._fan_in_out(shape)
    exact = [lambda m: m.Constant(0.75),
             lambda m: m.Assign(np.arange(math.prod(shape), dtype=np.float32)
                                .reshape(shape))]
    if len(shape) >= 3:
        exact += [lambda m: m.Dirac(), lambda m: m.Dirac(groups=2)]
    if len(shape) >= 3 and shape[-1] == shape[-2] or len(shape) == 3:
        exact.append(lambda m: m.Bilinear())
    for make in exact:
        want = np.asarray(make(ref_init)(shape, "float32"))
        got = make(port_init)(shape, "float32", device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32


def test_calculate_gain_and_global_initializer_match_jax():
    for name, param in (("sigmoid", None), ("tanh", None), ("relu", None),
                        ("leaky_relu", None), ("leaky_relu", 0.2),
                        ("selu", None), ("conv2d", None)):
        assert port_init.calculate_gain(name, param) == \
            ref_init.calculate_gain(name, param)
    with pytest.raises(ValueError):
        port_init.calculate_gain("swish")
    # set_global_initializer is stored and read by no layer
    port_init.set_global_initializer(port_init.Constant(5.0))
    try:
        assert isinstance(port_init.get_global_initializer()[0],
                          port_init.Constant)
        lin = tnn.Linear(4, 3, device="cpu")
        assert not torch.all(lin.weight == 5.0)
    finally:
        port_init._global_initializer = None


RANDOM = {  # name: (make(module), bounds (lo, hi) or None, mean, std)
    "Normal": (lambda m: m.Normal(0.5, 2.0), None, 0.5, 2.0),
    "TruncatedNormal": (lambda m: m.TruncatedNormal(0.5, 2.0), (-3.5, 4.5),
                        0.5, 2.0 * 0.8796256),
    "Uniform": (lambda m: m.Uniform(-0.5, 1.5), (-0.5, 1.5), 0.5,
                2.0 / math.sqrt(12)),
    "XavierNormal": (lambda m: m.XavierNormal(), None, 0.0,
                     math.sqrt(2.0 / (64 + 96))),
    "XavierUniform": (lambda m: m.XavierUniform(), (
        -math.sqrt(6 / 160), math.sqrt(6 / 160)), 0.0, math.sqrt(2 / 160)),
    "KaimingNormal": (lambda m: m.KaimingNormal(), None, 0.0,
                      math.sqrt(2.0 / 64)),
    "KaimingUniform": (lambda m: m.KaimingUniform(negative_slope=0.1), (
        -math.sqrt(2 / 1.01) * math.sqrt(3 / 64),
        math.sqrt(2 / 1.01) * math.sqrt(3 / 64)), 0.0,
        math.sqrt(2 / 1.01) / 8.0),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializers_match_jax_in_distribution(name):
    make, bounds, mean, std = RANDOM[name]
    shape = (64, 96)
    n = 64 * 96
    got = make(port_init)(shape, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    want = np.asarray(make(ref_init)(shape))
    assert got.shape == want.shape and got.dtype == torch.float32
    for arr in (got.numpy(), want):
        if bounds is not None:
            assert bounds[0] <= arr.min() and arr.max() <= bounds[1]
        assert abs(arr.mean() - mean) <= 5 * std / math.sqrt(n)
        assert abs(arr.std() - std) <= 5 * std / math.sqrt(2 * n)
    bf = make(port_init)(shape, "bfloat16", device="cpu")
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 4)], ids=str)
def test_orthogonal_matches_jax_in_kind(shape):
    got = port_init.Orthogonal(gain=1.5)(shape, device="cpu").numpy()
    want = np.asarray(ref_init.Orthogonal(gain=1.5)(shape))
    for arr in (got, want):
        m = arr.reshape(-1, shape[-1])
        small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(small, 2.25 * np.eye(len(small)),
                                   atol=1e-5)


def test_initializers_run_on_cuda_unless_asked():
    if torch.cuda.is_available():
        assert port_init.Constant(1.0)((2,)).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_init.Normal()((2, 2))
    assert port_init.Normal()((2, 2), device="cpu").device.type == "cpu"


def _attr(pkg, value, trainable=True):
    return pkg.ParamAttr(initializer=pkg.initializer.Constant(value),
                         trainable=trainable)


LAYERS = {  # name: (reference layer, port layer) makers over attr makers
    "Linear": lambda pkg, a, kw: pkg.Linear(4, 3, a(pkg, 0.5),
                                            a(pkg, -1.0, False), "x", **kw),
    "Embedding": lambda pkg, a, kw: pkg.Embedding(7, 3, 2, False,
                                                  a(pkg, 0.5), **kw),
    "Conv2D": lambda pkg, a, kw: pkg.Conv2D(2, 3, 3, 1, 0, 1, 1, "zeros",
                                            a(pkg, 0.5), a(pkg, -1.0, False),
                                            **kw),
    "LayerNorm": lambda pkg, a, kw: pkg.LayerNorm(4, 1e-5, a(pkg, 0.5),
                                                  a(pkg, -1.0, False), **kw),
    "RMSNorm": lambda pkg, a, kw: pkg.RMSNorm(4, 1e-6, a(pkg, 0.5), **kw),
    "BatchNorm1D": lambda pkg, a, kw: pkg.BatchNorm1D(
        3, 0.9, 1e-5, a(pkg, 0.5), a(pkg, -1.0, False), "NCL", **kw),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_param_attr_is_honoured_as_by_the_reference(name):
    ref = LAYERS[name](ref_nn, _attr, {})
    port = LAYERS[name](tnn, _attr, {"device": "cpu"})
    r_state = {k: v for k, v in ref.state_dict().items()
               if not k.startswith("_")}
    p_params = dict(port.named_parameters())
    assert sorted(p_params) == sorted(r_state)
    for k, p in p_params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(r_state[k]._value), k)
        assert p.requires_grad == getattr(ref, k.split(".")[0]).trainable, k


def test_attrs_false_and_embedding_default_under_an_attr():
    ln = tnn.LayerNorm(4, 1e-5, False, False, device="cpu")
    assert ln.weight is None and ln.bias is None
    out = ln(torch.randn(2, 4))
    ref_ln = ref_nn.LayerNorm(4, 1e-5, False, False)
    assert ref_ln.weight is None and out.shape == (2, 4)
    # a weight_attr without an initializer: XavierNormal, not N(0, 1)
    for pkg, kw in ((ref_nn, {}), (tnn, {"device": "cpu"})):
        emb = pkg.Embedding(400, 300, weight_attr=pkg.ParamAttr(), **kw)
        w = np.asarray(emb.weight._value if pkg is ref_nn
                       else emb.weight.detach().numpy())
        assert abs(w.std() - math.sqrt(2 / 700)) < 0.002
    lin = tnn.Linear(3, 2, bias_attr=False, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert lin.bias is None
