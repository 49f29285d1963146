"""The port's convolutional ``nn`` (the functions and layers ResNet and
LeNet are built from) against the JAX package's, on the same seeded numpy
inputs, float32 on both sides:

* ``F.conv1d/2d/3d`` over strides, dilations, groups, every padding form
  of the reference's ``_norm_padding`` (an int, n ints, 2n ints, n + 2
  pairs, ``"SAME"`` with asymmetric pads, ``"VALID"``) and both layouts:
  output and the input, weight and bias gradients (``jax.vjp`` against
  ``torch.autograd``);
* ``F.batch_norm`` in training mode (output, gradients through the batch
  statistics, the running statistics after a blend), in eval mode, with
  ``use_global_stats``, channel-last; a bfloat16 layer's buffers keep
  their dtype in eager training, and its blend matches the reference's;
* ``F.max_pool2d`` (torch's padding and padded by hand, ``"SAME"``, ties
  in a window of zeros), ``F.avg_pool2d`` (exclusive and not, padded by
  hand), ``F.adaptive_avg_pool2d`` (output 1, divisible and general
  bins), the 1-d and 3-d forms, ``flatten``: output and input gradient;
* the layers (``Conv2D``, ``BatchNorm2D``, the pools, ``ReLU``,
  ``Flatten``, ``Sequential``) with the reference's state-dict keys,
  shapes and initial ranges, on the reference's weights;
* the refusals (``ceil_mode``, ``return_mask``, ``padding_mode``,
  ``divisor_override``, ``ParamAttr``s);
* ``F.dropout`` / ``nn.Dropout`` with ``axis`` and ``mode`` against the
  reference's keep pattern and scaling (the masks' random bits differ
  between the packages), and the draws at ``axis=None`` unchanged.

The batch-norm gradients come from the reference's tape, as its
``batch_norm`` writes the running statistics into its buffers and cannot
run under ``jax.vjp``.

Tolerance: float32 on both sides, apart by the order of sums only: 2e-5
absolute and relative, as ``tests/test_torch_fused_layers.py``.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops.manipulation import flatten as ref_flatten
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import Generator
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flatten

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_vjp(fn, arrays, seed):
    """Output and input gradients of the reference's ``fn`` (over
    Tensors) by ``jax.vjp``, against a seeded output gradient."""
    def f(*vs):
        return fn(*[paddle.Tensor(v) for v in vs])._value

    out, vjp = jax.vjp(f, *[jnp.asarray(a) for a in arrays])
    gout = _rand(out.shape, seed)
    return (np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(gout))],
            gout)


def _port_vjp(fn, arrays, gout):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(gout))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _match(ref_fn, port_fn, arrays, seed=99):
    out_r, grads_r, gout = _ref_vjp(ref_fn, arrays, seed)
    out_p, grads_p = _port_vjp(port_fn, arrays, gout)
    assert out_p.shape == out_r.shape
    np.testing.assert_allclose(out_p, out_r, **TOL)
    for i, (a, b) in enumerate(zip(grads_p, grads_r)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"input {i}")
    return out_p


# --- convolution -------------------------------------------------------------

CONV_CASES = {  # name: (n, x shape, w shape, kwargs)
    "pad0": (2, (2, 4, 9, 9), (6, 4, 3, 3), dict(padding=0)),
    "int_pad_stride2": (2, (2, 4, 9, 9), (6, 4, 3, 3),
                        dict(padding=1, stride=2)),
    "n_ints_dilation2": (2, (2, 4, 11, 10), (6, 4, 3, 3),
                         dict(padding=[1, 2], dilation=2)),
    "2n_ints_asymmetric": (2, (2, 4, 9, 8), (6, 4, 3, 3),
                           dict(padding=[0, 1, 2, 1], stride=[1, 2])),
    "same_stride2_asymmetric": (2, (2, 4, 8, 8), (6, 4, 3, 3),
                                dict(padding="SAME", stride=2)),
    "same_dilated": (2, (2, 4, 8, 7), (6, 4, 3, 3),
                     dict(padding="same", dilation=2)),
    "valid_stride2": (2, (2, 4, 9, 9), (6, 4, 3, 3),
                      dict(padding="VALID", stride=2)),
    "groups2": (2, (2, 4, 8, 8), (6, 2, 3, 3), dict(padding=1, groups=2)),
    "depthwise": (2, (2, 4, 8, 8), (4, 1, 3, 3), dict(padding=1, groups=4)),
    "nhwc_same_stride2": (2, (2, 8, 8, 4), (6, 4, 3, 3),
                          dict(padding="SAME", stride=2,
                               data_format="NHWC")),
    "stem_7x7_stride2": (2, (2, 3, 16, 16), (8, 3, 7, 7),
                         dict(padding=3, stride=2)),
    "conv1d": (1, (2, 4, 11), (6, 4, 3), dict(padding=1, stride=2)),
    "conv1d_nlc_same": (1, (2, 11, 4), (6, 4, 4),
                        dict(padding="SAME", data_format="NLC")),
    "conv3d": (3, (1, 2, 5, 6, 5), (3, 2, 3, 3, 3),
               dict(padding=1, stride=[1, 2, 1])),
    "conv1d_n_plus_2_pairs": (1, (2, 4, 11), (6, 4, 3),
                              dict(padding=[[0, 0], [0, 0], [2, 1]])),
    "conv3d_n_plus_2_pairs": (3, (1, 2, 5, 6, 5), (3, 2, 3, 3, 3),
                              dict(padding=[[0, 0], [0, 0], [1, 0], [0, 2],
                                            [1, 1]])),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv_matches_jax(case, with_bias):
    n, xs, ws, kw = CONV_CASES[case]
    arrays = [_rand(xs, 1), _rand(ws, 2)]
    if with_bias:
        arrays.append(_rand((ws[0],), 3))
    ref = getattr(RF, f"conv{n}d")
    port = getattr(TF, f"conv{n}d")
    out = _match(lambda *t: ref(*t, **kw), lambda *t: port(*t, **kw),
                 arrays)
    assert np.isfinite(out).all()


def test_conv2d_takes_four_pairs_the_reference_reads_as_ints():
    """At n = 2 the reference reads [[0, 0], [0, 0], [h0, h1], [w0, w1]] as
    2n ints and raises (ROADMAP Queue 3); the port takes the pairs, and
    equals the reference's 2n-int form of the same pads."""
    arrays = [_rand((2, 4, 9, 8), 1), _rand((6, 4, 3, 2), 2)]
    pairs = [[0, 0], [0, 0], [1, 0], [2, 1]]
    with pytest.raises(TypeError):
        _ref_vjp(lambda x, w: RF.conv2d(x, w, padding=pairs), arrays, 9)
    _match(lambda x, w: RF.conv2d(x, w, padding=[1, 0, 2, 1]),
           lambda x, w: TF.conv2d(x, w, padding=pairs), arrays)


def test_same_pads_are_lax_pads():
    from paddle_tpu_torch.nn.functional.conv import same_pads
    for size, k, s, d in [(8, 3, 2, 1), (9, 3, 2, 1), (7, 4, 3, 2),
                          (5, 1, 2, 1), (16, 7, 2, 1), (3, 5, 1, 1)]:
        want = jax.lax.padtype_to_pads((size,), ((k - 1) * d + 1,), (s,),
                                       "SAME")
        assert same_pads((size,), (k,), (s,), (d,)) == [tuple(want[0])]


# --- batch norm ----------------------------------------------------------

def _bn_ref(x, rm, rv, w, b, gout, **kw):
    tx = paddle.to_tensor(x, stop_gradient=False)
    tw = paddle.to_tensor(w, stop_gradient=False)
    tb = paddle.to_tensor(b, stop_gradient=False)
    trm, trv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    out = RF.batch_norm(tx, trm, trv, tw, tb, **kw)
    (out * paddle.to_tensor(gout)).sum().backward()
    grads = [t.grad.numpy() if t.grad is not None else np.zeros_like(a)
             for t, a in ((tx, x), (tw, w), (tb, b))]
    return out.numpy(), grads, trm.numpy(), trv.numpy()


def _bn_port(x, rm, rv, w, b, gout, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    out = TF.batch_norm(ts[0], trm, trv, ts[1], ts[2], **kw)
    (out * torch.from_numpy(gout)).sum().backward()
    return (out.detach().numpy(), [t.grad.numpy() for t in ts],
            trm.numpy(), trv.numpy())


BN_CASES = {
    "train": dict(training=True),
    "train_momentum_0.5": dict(training=True, momentum=0.5, epsilon=1e-3),
    "eval": dict(training=False),
    "train_global_stats": dict(training=True, use_global_stats=True),
    "eval_batch_stats": dict(training=False, use_global_stats=False),
    "train_nhwc": dict(training=True, data_format="NHWC"),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_jax(case):
    kw = BN_CASES[case]
    C = 5
    shape = (4, 6, 6, C) if kw.get("data_format") == "NHWC" else (4, C, 6, 6)
    x = _rand(shape, 1) * 3 + 1.5
    rm, rv = _rand((C,), 2), np.abs(_rand((C,), 3)) + 0.5
    w, b, gout = _rand((C,), 4), _rand((C,), 5), _rand(shape, 6)
    ref = _bn_ref(x, rm, rv, w, b, gout, **kw)
    port = _bn_port(x, rm, rv, w, b, gout, **kw)
    np.testing.assert_allclose(port[0], ref[0], **TOL)
    for name, a, r in zip(("x", "weight", "bias"), port[1], ref[1]):
        np.testing.assert_allclose(a, r, **TOL, err_msg=name)
    np.testing.assert_allclose(port[2], ref[2], **TOL)
    np.testing.assert_allclose(port[3], ref[3], **TOL)
    blended = kw["training"] and not kw.get("use_global_stats")
    assert blended == (not np.array_equal(port[2], rm))


def test_batch_norm_blends_the_biased_variance_at_paddles_momentum():
    """The running variance takes momentum of the old value and the biased
    batch variance (torch's own batch norm takes 1 - momentum of the old
    and the unbiased variance)."""
    x = _rand((3, 2, 4, 4), 7)
    rm, rv = np.zeros(2, np.float32), np.ones(2, np.float32)
    port = _bn_port(x, rm, rv, np.ones(2, np.float32),
                    np.zeros(2, np.float32), np.ones_like(x), training=True)
    var = x.transpose(1, 0, 2, 3).reshape(2, -1).var(1)
    np.testing.assert_allclose(port[3], 0.9 * 1.0 + 0.1 * var, **TOL)
    t_rm, t_rv = torch.zeros(2), torch.ones(2)
    torch.nn.functional.batch_norm(torch.from_numpy(x), t_rm, t_rv,
                                   training=True, momentum=0.1)
    assert not np.allclose(t_rv.numpy(), port[3], rtol=1e-4, atol=0)


def test_eager_bf16_bn_buffers_keep_dtype_and_match_jax():
    """A bfloat16 layer's running statistics stay bfloat16 after a
    train-mode forward (the blend casts back to the buffer's dtype), and
    equal the reference's blend (one bf16 rounding of f32 values apart by
    their order of sums: within one bf16 ulp, 2^-8 relative)."""
    x = _rand((2, 4, 8, 8), 3) * 2 + 0.7
    paddle.seed(0)
    ref = ref_nn.BatchNorm2D(4)
    ref.to(dtype="bfloat16")
    ref.train()
    ref_out = ref(paddle.cast(paddle.to_tensor(x), "bfloat16"))
    port = tnn.BatchNorm2D(4, device="cpu").to(torch.bfloat16)
    port.train()
    port_out = port(torch.from_numpy(x).to(torch.bfloat16))
    assert port._mean.dtype == port._variance.dtype == torch.bfloat16
    assert port_out.dtype == torch.bfloat16
    assert str(ref._mean.dtype).endswith("bfloat16")
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(
            getattr(port, name).float().numpy(),
            getattr(ref, name).astype("float32").numpy(),
            rtol=2 ** -8, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(port_out.detach().float().numpy(),
                               ref_out.astype("float32").numpy(),
                               rtol=2 ** -7, atol=2 ** -7)


# --- pooling ---------------------------------------------------------------

POOL_CASES = {  # name: (function, x shape, kwargs)
    "max_k3_s2_p1": ("max_pool2d", (2, 3, 9, 9),
                     dict(kernel_size=3, stride=2, padding=1)),
    "max_k2": ("max_pool2d", (2, 3, 8, 8), dict(kernel_size=2)),
    "max_k2_s2_lenet": ("max_pool2d", (2, 3, 10, 10),
                        dict(kernel_size=2, stride=2)),
    "max_same": ("max_pool2d", (2, 3, 8, 7),
                 dict(kernel_size=3, stride=2, padding="SAME")),
    "max_wide_pad": ("max_pool2d", (2, 3, 7, 7),
                     dict(kernel_size=3, stride=1, padding=2)),
    "max_nhwc": ("max_pool2d", (2, 9, 9, 3),
                 dict(kernel_size=3, stride=2, padding=1,
                      data_format="NHWC")),
    "avg_exclusive_p1": ("avg_pool2d", (2, 3, 9, 9),
                         dict(kernel_size=3, stride=2, padding=1)),
    "avg_inclusive_p1": ("avg_pool2d", (2, 3, 9, 9),
                         dict(kernel_size=3, stride=2, padding=1,
                              exclusive=False)),
    "avg_no_pad": ("avg_pool2d", (2, 3, 8, 8), dict(kernel_size=2)),
    "avg_same_exclusive": ("avg_pool2d", (2, 3, 8, 7),
                           dict(kernel_size=3, stride=2, padding="SAME")),
    "avg_same_inclusive": ("avg_pool2d", (2, 3, 8, 7),
                           dict(kernel_size=3, stride=2, padding="SAME",
                                exclusive=False)),
    "avg_valid": ("avg_pool2d", (2, 3, 9, 9),
                  dict(kernel_size=3, stride=2, padding="VALID")),
    "avg_wide_pad_exclusive": ("avg_pool2d", (2, 3, 7, 7),
                               dict(kernel_size=3, stride=1, padding=2)),
    "adaptive_1x1": ("adaptive_avg_pool2d", (2, 3, 7, 7),
                     dict(output_size=(1, 1))),
    "adaptive_divisible": ("adaptive_avg_pool2d", (2, 3, 8, 6),
                           dict(output_size=(4, 2))),
    "adaptive_general": ("adaptive_avg_pool2d", (2, 3, 8, 7),
                         dict(output_size=(3, 5))),
    "adaptive_int_nhwc": ("adaptive_avg_pool2d", (2, 7, 8, 3),
                          dict(output_size=3, data_format="NHWC")),
    "max_1d": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                              padding=1)),
    "avg_1d": ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                              padding=1)),
    "avg_1d_same": ("avg_pool1d", (2, 3, 10), dict(kernel_size=3, stride=2,
                                                   padding="SAME")),
    "adaptive_1d": ("adaptive_avg_pool1d", (2, 3, 10),
                    dict(output_size=4)),
    "max_3d": ("max_pool3d", (1, 2, 5, 6, 5),
               dict(kernel_size=3, stride=2, padding=1)),
    "avg_3d": ("avg_pool3d", (1, 2, 5, 6, 5),
               dict(kernel_size=2, stride=1, padding=1)),
    "adaptive_3d": ("adaptive_avg_pool3d", (1, 2, 5, 6, 4),
                    dict(output_size=(2, 3, 1))),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_jax(case):
    name, xs, kw = POOL_CASES[case]
    ref, port = getattr(RF, name), getattr(TF, name)
    _match(lambda t: ref(t, **kw), lambda t: port(t, **kw), [_rand(xs, 4)])


def test_max_pool_ties_send_the_gradient_to_the_first_maximum():
    """A map of zeros, as after a ReLU: every element of a window ties;
    both packages route each window's gradient to its first unpadded
    element (6 x 6, kernel 3, stride 2, pad 1: ResNet's stem pool)."""
    x = np.zeros((1, 1, 6, 6), np.float32)
    kw = dict(kernel_size=3, stride=2, padding=1)
    _, (g_ref,), _ = _ref_vjp(lambda t: RF.max_pool2d(t, **kw), [x], 1)
    t = torch.zeros((1, 1, 6, 6), requires_grad=True)
    (TF.max_pool2d(t, **kw) * torch.from_numpy(_rand((1, 1, 3, 3), 1))
     ).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), g_ref)
    want = np.zeros((6, 6), np.float32)
    for i, r in enumerate((0, 1, 3)):
        for j, c in enumerate((0, 1, 3)):
            want[r, c] = _rand((1, 1, 3, 3), 1)[0, 0, i, j]
    np.testing.assert_array_equal(t.grad.numpy()[0, 0], want)


@pytest.mark.parametrize("start,stop", [(0, -1), (1, -1), (1, 2), (-2, -1),
                                        (2, 2)])
def test_flatten_matches_jax(start, stop):
    x = _rand((2, 3, 4, 5), 1)
    want = ref_flatten(paddle.to_tensor(x), start, stop).numpy()
    got = flatten(torch.from_numpy(x), start, stop).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert flatten(torch.tensor(3.0)).shape == (1,)


# --- layers ------------------------------------------------------------------

def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _port_of(ref, port):
    state = _state(ref)
    assert sorted(port.state_dict()) == sorted(state)
    for k, v in port.state_dict().items():
        assert tuple(v.shape) == state[k].shape, k
    return tnn.load_numpy_state_dict(port, state)


def _layer_grads_match(ref, port, x, gout):
    tx = paddle.to_tensor(x, stop_gradient=False)
    out_r = ref(tx)
    (out_r * paddle.to_tensor(gout)).sum().backward()
    px = torch.from_numpy(x).requires_grad_(True)
    out_p = port(px)
    (out_p * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(out_p.detach().numpy(), out_r.numpy(), **TOL)
    np.testing.assert_allclose(px.grad.numpy(), tx.grad.numpy(), **TOL)
    ref_params = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].grad.numpy(), **TOL,
                                   err_msg=name)


def test_conv2d_layer_init_keys_and_weights():
    paddle.seed(0)
    ref = ref_nn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2)
    port = tnn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2, device="cpu",
                      generator=Generator(5))
    fan_in = 2 * 9
    limit = np.sqrt(2.0) * np.sqrt(3.0 / fan_in)
    w = port.weight.detach().numpy()
    assert w.shape == (6, 2, 3, 3) and w.dtype == np.float32
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.8 * limit
    assert np.abs(port.bias.detach().numpy()).max() <= 1 / np.sqrt(fan_in)
    assert np.abs(ref.weight.numpy()).max() <= limit
    again = tnn.Conv2D(4, 6, 3, groups=2, device="cpu",
                       generator=Generator(5))
    assert torch.equal(again.weight, port.weight)
    assert tnn.Conv2D(4, 6, 3, bias_attr=False, device="cpu").bias is None
    _port_of(ref, port)
    x = _rand((2, 4, 9, 9), 1)
    _layer_grads_match(ref, port, x, _rand((2, 6, 5, 5), 2))


def test_batch_norm_layer_keys_buffers_and_train_step():
    paddle.seed(0)
    ref = ref_nn.BatchNorm2D(3)
    port = tnn.BatchNorm2D(3, device="cpu")
    assert sorted(port.state_dict()) == ["_mean", "_variance", "bias",
                                         "weight"]
    assert not any("num_batches" in k for k in port.state_dict())
    assert torch.equal(port._variance, torch.ones(3))
    _port_of(ref, port)
    ref.train()
    port.train()
    x = _rand((4, 3, 5, 5), 1) * 2 + 1
    _layer_grads_match(ref, port, x, _rand(x.shape, 2))
    np.testing.assert_allclose(port._mean.numpy(), ref._mean.numpy(), **TOL)
    np.testing.assert_allclose(port._variance.numpy(),
                               ref._variance.numpy(), **TOL)
    ref.eval()
    port.eval()
    _layer_grads_match(ref, port, x, _rand(x.shape, 3))
    for cls, shape in (("BatchNorm1D", (4, 3, 7)), ("BatchNorm", (2, 3, 4, 4)),
                       ("BatchNorm3D", (2, 3, 2, 3, 2))):
        r, p = getattr(ref_nn, cls)(3), getattr(tnn, cls)(3, device="cpu")
        _port_of(r, p)
        _layer_grads_match(r, p, _rand(shape, 4), _rand(shape, 5))
    no_affine = tnn.BatchNorm2D(3, weight_attr=False, bias_attr=False,
                                device="cpu")
    assert no_affine.weight is None and no_affine.bias is None


def test_sequential_names_and_stateless_layers():
    paddle.seed(0)
    ref = ref_nn.Sequential(ref_nn.Conv2D(1, 2, 3, padding=1),
                            ref_nn.ReLU(), ref_nn.MaxPool2D(2, 2),
                            ref_nn.AvgPool2D(2, 1, padding=1),
                            ref_nn.AdaptiveAvgPool2D(2), ref_nn.Flatten(),
                            ref_nn.Linear(8, 3))
    port = tnn.Sequential(tnn.Conv2D(1, 2, 3, padding=1, device="cpu"),
                          tnn.ReLU(), tnn.MaxPool2D(2, 2),
                          tnn.AvgPool2D(2, 1, padding=1),
                          tnn.AdaptiveAvgPool2D(2), tnn.Flatten(),
                          tnn.Linear(8, 3, device="cpu"))
    assert sorted(port.state_dict()) == ["0.bias", "0.weight", "6.bias",
                                         "6.weight"]
    _port_of(ref, port)
    _layer_grads_match(ref, port, _rand((2, 1, 8, 8), 1), _rand((2, 3), 2))
    assert len(port) == 7 and isinstance(port[1], tnn.ReLU)
    named = tnn.Sequential(collections.OrderedDict(
        [("conv", tnn.Conv2D(1, 2, 3, device="cpu")), ("act", tnn.ReLU())]))
    pairs = tnn.Sequential(("conv", tnn.Conv2D(1, 2, 3, device="cpu")),
                           ("act", tnn.ReLU()))
    ref_named = ref_nn.Sequential(collections.OrderedDict(
        [("conv", ref_nn.Conv2D(1, 2, 3)), ("act", ref_nn.ReLU())]))
    ref_pairs = ref_nn.Sequential(("conv", ref_nn.Conv2D(1, 2, 3)),
                                  ("act", ref_nn.ReLU()))
    for p, r in ((named, ref_named), (pairs, ref_pairs)):
        assert sorted(p.state_dict()) == sorted(r.state_dict())
        assert sorted(p.state_dict()) == ["conv.bias", "conv.weight"]
    for cls, shape, kw in (("MaxPool1D", (2, 3, 9), dict(kernel_size=2)),
                           ("AvgPool1D", (2, 3, 9), dict(kernel_size=3,
                                                         padding=1)),
                           ("MaxPool3D", (1, 2, 4, 4, 4),
                            dict(kernel_size=2)),
                           ("AvgPool3D", (1, 2, 4, 4, 4),
                            dict(kernel_size=2, exclusive=False)),
                           ("AdaptiveAvgPool1D", (2, 3, 9),
                            dict(output_size=4)),
                           ("AdaptiveAvgPool3D", (1, 2, 4, 5, 4),
                            dict(output_size=2))):
        x = _rand(shape, 3)
        np.testing.assert_allclose(
            getattr(tnn, cls)(**kw)(torch.from_numpy(x)).numpy(),
            getattr(ref_nn, cls)(**kw)(paddle.to_tensor(x)).numpy(), **TOL,
            err_msg=cls)


def test_refusals_name_their_roadmap_item():
    x = torch.zeros((1, 1, 4, 4))
    with pytest.raises(NotImplementedError, match="Queue 3"):
        TF.max_pool2d(x, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        TF.avg_pool2d(x, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        TF.max_pool2d(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        TF.avg_pool2d(x, 2, divisor_override=3)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tnn.MaxPool2D(2, return_mask=True)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tnn.MaxPool2D(2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tnn.AvgPool2D(2, divisor_override=2)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tnn.Conv2D(1, 2, 3, padding_mode="reflect", device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tnn.BatchNorm2D(2, weight_attr=object(), device="cpu")
    with pytest.raises(TypeError):      # weight_attr is not ported
        tnn.Conv2D(1, 2, 3, 1, 0, 1, 1, "zeros", None, device="cpu")


# --- dropout (ROADMAP Queue 3 fault 1) ------------------------------------

def _pattern(out, x, axis):
    """(keep mask, the kept elements' scale), and whether the mask is one
    decision per index of ``axis``, shared over the other axes."""
    keep = out != 0
    scale = out[keep] / x[keep]
    axes = [axis] if isinstance(axis, int) else list(axis or range(x.ndim))
    shared = all(np.all(keep == keep.take([0], axis=a))
                 for a in range(x.ndim) if a not in axes)
    return keep, scale, shared


DROPOUT_CASES = [  # (axis, mode)
    (None, "upscale_in_train"), (1, "upscale_in_train"),
    ([0, 2], "upscale_in_train"), (0, "downscale_in_infer"),
    (None, "downscale_in_infer")]


@pytest.mark.parametrize("axis,mode", DROPOUT_CASES,
                         ids=[f"{a}-{m}" for a, m in DROPOUT_CASES])
def test_dropout_axis_and_mode_match_jax(axis, mode):
    x = np.abs(_rand((24, 40, 6), 1)) + 0.5
    p = 0.4
    paddle.seed(3)
    ref = RF.dropout(paddle.to_tensor(x), p, axis, True, mode).numpy()
    port = TF.dropout(torch.from_numpy(x), p, axis, True, mode,
                      generator=Generator(3)).numpy()
    layer = tnn.Dropout(p, axis, mode, generator=Generator(3))
    assert layer.training
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), port)
    keep_r, scale_r, shared_r = _pattern(ref, x, axis)
    keep_p, scale_p, shared_p = _pattern(port, x, axis)
    assert shared_r and shared_p
    want = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(scale_p, want, rtol=1e-6)
    np.testing.assert_allclose(scale_r, want, rtol=1e-6)
    assert 0 < keep_p.mean() < 1 and 0 < keep_r.mean() < 1
    # eval: the identity for upscale_in_train on both sides
    layer.eval()
    if mode == "upscale_in_train":
        np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), x)
        np.testing.assert_array_equal(
            RF.dropout(paddle.to_tensor(x), p, axis, False, mode).numpy(), x)


def test_dropout_third_positional_argument_is_axis():
    """``F.dropout(x, 0.5, 1)`` drops whole columns (one decision per
    column, shared over the rows), as the reference does; it used to be
    read as ``training`` and drop single elements."""
    x = np.ones((64, 32), np.float32)
    out = TF.dropout(torch.from_numpy(x), 0.5, 1,
                     generator=Generator(0)).numpy()
    assert (out == out[:1]).all()
    assert 0 < (out[0] == 0).mean() < 1
    ref = RF.dropout(paddle.to_tensor(x), 0.5, 1).numpy()
    assert (ref == ref[:1]).all()
    with pytest.raises(TypeError):      # the generator is keyword-only
        TF.dropout(torch.from_numpy(x), 0.5, None, True,
                   "upscale_in_train", Generator(0))
    with pytest.raises(ValueError, match="mode"):
        TF.dropout(torch.from_numpy(x), 0.5, mode="upscale")


def test_dropout_downscale_in_infer_scales_in_eval():
    """``downscale_in_infer`` returns x * (1 - p) outside training, as
    Paddle defines it; the reference returns x unscaled (ROADMAP Queue 3,
    faults of the reference), which the port does not copy."""
    x = _rand((3, 4), 1)
    got = TF.dropout(torch.from_numpy(x), 0.25, training=False,
                     mode="downscale_in_infer").numpy()
    np.testing.assert_allclose(got, x * 0.75, rtol=1e-6)
    ref = RF.dropout(paddle.to_tensor(x), 0.25, training=False,
                     mode="downscale_in_infer").numpy()
    np.testing.assert_array_equal(ref, x)


def test_dropout_draws_at_axis_none_are_unchanged():
    """At axis=None the mask is still one uniform draw per element of x's
    shape from the generator, kept where it is below 1 - p, so the numbers
    of BERT, the encoder layers and ``incubate.nn`` do not move."""
    x = torch.from_numpy(_rand((4, 7, 9), 2))
    got = TF.dropout(x, 0.3, generator=Generator(11))
    g = torch.Generator().manual_seed(11)
    keep = torch.rand(x.shape, generator=g) < 0.7
    want = torch.where(keep, x / 0.7, torch.zeros(()))
    assert torch.equal(got, want)
    layer = tnn.Dropout(0.3, generator=Generator(11))
    assert torch.equal(layer(x), want)
