"""The rest of ``nn.functional`` and its layers in the PyTorch port against
the JAX package, on the same seeded numpy inputs (and the reference's
weights), float32 on both sides:

* the name walk: every public name of the reference's ``nn`` and
  ``nn.functional`` exists in the port, but the named deferrals
  (``Conv*Transpose`` / ``conv*_transpose``, ROADMAP item 16;
  ``SyncBatchNorm`` is held in ``test_torch_models_mesh.py``);
* the 27 activations and ``tanh``, output and input gradient
  (``jax.vjp`` against ``torch.autograd``), and their layers (``PReLU``
  on the reference's weight);
* ``interpolate`` in each mode ("nearest", "linear", "bilinear",
  "trilinear", "bicubic", "area"), shrinking and growing, with and without
  ``align_corners``, channel-first and channel-last: the reference's
  function (``jax.image.resize``'s, not torch's), output and gradient;
* the rest of ``F.common``, ``F.norm``, ``F.pooling`` (the adaptive max
  pools; ``max_unpool`` of each package's own ``max_pool`` mask) and
  ``F.vision`` (``affine_grid``, ``grid_sample`` in every mode, padding
  mode and corner rule, ``temporal_shift``), and every new layer;
* the random ones by their structure: ``dropout2d/3d`` drop whole
  channels, ``alpha_dropout`` gives the two affine images, and
  ``class_center_sample`` keeps every positive class;
* the reference's traps the port copies, each named: the in-place
  activations overwrite a leaf that requires grad and record nothing;
  ``one_hot`` gives a zero row out of range; ``interpolate`` ignores
  ``align_mode``; ``instance_norm`` reads no running statistics;
  ``SpectralNorm`` never updates its vectors; ``FusedMultiHeadAttention``
  reads none of its ``*_attr`` arguments.

Tolerance: 1e-5 absolute and relative unless a case states otherwise
(apart by the order of sums only).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.incubate import nn as ref_inc
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.incubate import nn as port_inc
from paddle_tpu_torch.nn import functional as TF

TOL = dict(atol=1e-5, rtol=1e-5)
DEFERRED = {"Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
            "conv1d_transpose", "conv2d_transpose", "conv3d_transpose"}


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


class _Recorded(Exception):
    """Stops a test body in the recording pass, once its case is noted."""


_STATE = {"recording": None, "node": None, "results": {}}


def _match(ref_fn, port_fn, arrays, tol=TOL):
    """Output and every input's gradient (against one fixed output
    gradient) of the two packages' ``fn``s. The reference's side of every
    case of this module was computed before the first one ran, in one
    compiled program (``_reference_results``): one compile, not one per
    case."""
    rec = _STATE["recording"]
    if rec is not None:
        rec.append((_STATE["node"], ref_fn, arrays))
        raise _Recorded
    out, grads_r, gout = _STATE["results"][_STATE["node"]]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out_p = port_fn(*ts)
    grads_p = torch.autograd.grad(out_p, ts, torch.from_numpy(gout),
                                  allow_unused=True)
    assert tuple(out_p.shape) == out.shape
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out), **tol)
    for i, (a, b, t) in enumerate(zip(grads_p, grads_r, ts)):
        a = torch.zeros_like(t) if a is None else a     # no path: zero
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol,
                                   err_msg=f"input {i}")


def _reference_results(session):
    """Run every selected test of this module that calls ``_match`` up to
    that call, note its reference function and inputs, and compute all
    their outputs and vjps in one jitted program."""
    rec = _STATE["recording"] = []
    try:
        for item in session.items:
            if item.module is not sys.modules[__name__] or \
                    item.originalname not in _MATCHED:
                continue
            _STATE["node"] = item.nodeid
            params = getattr(getattr(item, "callspec", None), "params", {})
            try:
                item.obj(**params)
            except _Recorded:
                pass
    finally:
        _STATE["recording"] = None
    fns = [(lambda f: lambda *vs: f(*[paddle.Tensor(v) for v in vs])._value
            )(ref_fn) for _, ref_fn, _ in rec]

    @jax.jit
    def everything(arrays):
        res = []
        for f, a in zip(fns, arrays):
            out, vjp = jax.vjp(f, *a)
            # a fixed output gradient of out's shape, made in the program
            gout = jnp.sin(jnp.arange(out.size, dtype=out.dtype) * 0.7
                           + 0.3).reshape(out.shape)
            res.append((out, vjp(gout), gout))
        return res

    results = everything([[jnp.asarray(a) for a in arrs]
                          for _, _, arrs in rec])
    for (node, _, _), (out, grads, g) in zip(rec, results):
        _STATE["results"][node] = (np.asarray(out),
                                   [np.asarray(x) for x in grads],
                                   np.asarray(g))


@pytest.fixture(autouse=True)
def _node(request):
    if request.function.__name__ in _MATCHED and not _STATE["results"]:
        _reference_results(request.session)
    _STATE["node"] = request.node.nodeid


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("pair", ["nn", "functional"])
def test_every_public_name_of_the_reference_is_in_the_port(pair):
    ref, port = ((ref_nn, tnn) if pair == "nn" else (RF, TF))
    missing = sorted(_public(ref) - _public(port) - DEFERRED)
    assert not missing
    assert DEFERRED & _public(ref) - _public(port)


# --- activations ----------------------------------------------------------

ACTS = {  # name: kwargs
    "relu": {}, "relu6": {}, "leaky_relu": dict(negative_slope=0.1),
    "elu": dict(alpha=0.7), "selu": {}, "celu": dict(alpha=1.3),
    "gelu": {}, "gelu_tanh": dict(approximate=True), "sigmoid": {},
    "hardsigmoid": {}, "hardswish": {}, "hardtanh": dict(min=-0.5, max=0.7),
    "hardshrink": dict(threshold=0.4), "softshrink": dict(threshold=0.3),
    "tanhshrink": {}, "silu": {}, "swish": {}, "mish": {}, "softplus": {},
    "softsign": {}, "thresholded_relu": dict(threshold=0.2),
    "log_sigmoid": {}, "softmax": dict(axis=1), "log_softmax": {},
    "tanh": {}, "gumbel_softmax": dict(temperature=0.5),
    "maxout": dict(groups=2, axis=1), "glu": dict(axis=-1),
}


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation_matches_jax(name):
    fn = name.split("_tanh")[0] if name == "gelu_tanh" else name
    kw = ACTS[name]
    x = _rand((2, 4, 6), 1)
    _match(lambda v: getattr(RF, fn)(v, **kw),
           lambda v: getattr(TF, fn)(v, **kw), [x])


LAYER_ACTS = {  # layer: (positional args, function, its kwargs)
    "ReLU": ((), "relu", {}), "ReLU6": ((), "relu6", {}),
    "LeakyReLU": ((0.2,), "leaky_relu", {}), "ELU": ((0.5,), "elu", {}),
    "CELU": ((), "celu", {}), "SELU": ((), "selu", {}),
    "GELU": ((True,), "gelu", {}), "Sigmoid": ((), "sigmoid", {}),
    "Hardsigmoid": ((), "hardsigmoid", {}),
    "Hardswish": ((), "hardswish", {}),
    "Hardtanh": ((-0.3, 0.4), "hardtanh", {}),
    "Hardshrink": ((0.2,), "hardshrink", {}),
    "Softshrink": ((0.2,), "softshrink", {}),
    "Tanhshrink": ((), "tanhshrink", {}), "Silu": ((), "silu", {}),
    "Swish": ((), "swish", {}), "Mish": ((), "mish", {}),
    "Softplus": ((), "softplus", {}), "Softsign": ((), "softsign", {}),
    "ThresholdedReLU": ((0.3,), "thresholded_relu", {}),
    "LogSigmoid": ((), "log_sigmoid", {}), "Softmax": ((1,), "softmax", {}),
    "LogSoftmax": ((), "log_softmax", {}), "Maxout": ((2,), "maxout", {}),
    "GLU": ((1,), "glu", {}), "Tanh": ((), "tanh", {}),
}


@pytest.mark.parametrize("name", sorted(LAYER_ACTS))
def test_activation_layer_matches_jax(name):
    args, _, _ = LAYER_ACTS[name]
    ref, port = getattr(ref_nn, name)(*args), getattr(tnn, name)(*args)
    assert isinstance(port, tnn.Layer) and type(port).__name__ == name
    x = _rand((2, 4, 3), 2)
    _match(ref, port, [x])


@pytest.mark.parametrize("n, fmt", [(1, "NCHW"), (4, "NCHW"), (4, "NHWC")])
def test_prelu_layer_matches_jax(n, fmt):
    paddle.seed(0)
    ref = ref_nn.PReLU(n, 0.1, data_format=fmt)
    port = tnn.PReLU(n, 0.1, data_format=fmt, device="cpu")
    assert list(port.state_dict()) == ["weight"]
    w = _rand((n,), 3)
    ref.weight.set_value(paddle.to_tensor(w))
    tnn.load_numpy_state_dict(port, {"weight": w})
    x = _rand((2, 4, 3, 4) if fmt == "NCHW" else (2, 3, 4, 4), 4)
    _match(ref, port, [x])


@pytest.mark.parametrize("name", ["relu_", "elu_", "tanh_", "softmax_"])
def test_inplace_activation_overwrites_x_and_records_nothing(name):
    """The reference's trap, copied on purpose: ``x`` takes the values
    and stays a leaf; a gradient through it skips the activation."""
    x = _rand((3, 5), 5)
    rx, px = paddle.to_tensor(x), torch.from_numpy(x.copy())
    assert getattr(TF, name)(px) is px
    getattr(RF, name)(rx)
    np.testing.assert_allclose(px.numpy(), rx.numpy(), **TOL)
    leaf = torch.from_numpy(x.copy()).requires_grad_(True)
    getattr(TF, name)(leaf)
    assert leaf.is_leaf and leaf.grad_fn is None
    (leaf * 3.0).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), np.full_like(x, 3.0))


# --- interpolate ------------------------------------------------------------

INTERP = {  # name: (x shape, kwargs)
    "nearest_grow": ((2, 3, 5, 4), dict(size=[9, 7])),
    "nearest_shrink": ((2, 3, 9, 7), dict(size=[4, 3])),
    "nearest_scale_nhwc": ((2, 5, 4, 3), dict(scale_factor=2.5,
                                              data_format="NHWC")),
    "bilinear_grow": ((2, 3, 5, 4), dict(size=[9, 7], mode="bilinear")),
    "bilinear_shrink": ((2, 3, 9, 8), dict(size=[4, 3], mode="bilinear")),
    "bilinear_mixed_nhwc": ((2, 7, 4, 3), dict(size=[3, 9], mode="bilinear",
                                               data_format="NHWC")),
    "bilinear_corners_grow": ((2, 3, 5, 4), dict(size=[9, 7],
                                                 mode="bilinear",
                                                 align_corners=True)),
    "bilinear_corners_shrink": ((2, 3, 9, 8), dict(size=[4, 1],
                                                   mode="bilinear",
                                                   align_corners=True)),
    "bicubic_grow": ((2, 2, 5, 6), dict(size=[11, 9], mode="bicubic")),
    "bicubic_shrink": ((2, 2, 11, 9), dict(size=[5, 4], mode="bicubic")),
    "bicubic_corners": ((2, 2, 5, 6), dict(size=[8, 9], mode="bicubic",
                                           align_corners=True)),
    "linear_1d_grow": ((2, 3, 7), dict(size=[12], mode="linear",
                                       data_format="NCL")),
    "linear_1d_shrink_scale": ((2, 3, 12), dict(scale_factor=0.4,
                                                mode="linear",
                                                data_format="NCL")),
    "trilinear_mixed": ((1, 2, 4, 6, 5), dict(size=[7, 3, 5],
                                              mode="trilinear",
                                              data_format="NCDHW")),
    "area_shrink": ((2, 3, 8, 8), dict(size=[3, 5], mode="area")),
    "area_grow": ((2, 3, 4, 4), dict(size=[6, 7], mode="area")),
}


@pytest.mark.parametrize("case", sorted(INTERP))
def test_interpolate_matches_jax(case):
    shape, kw = INTERP[case]
    x = _rand(shape, 6)
    _match(lambda v: RF.interpolate(v, **kw),
           lambda v: TF.interpolate(v, **kw), [x])


def test_interpolate_is_not_torchs_and_ignores_align_mode():
    """The reference's traps: half-pixel nearest, antialiased shrink,
    Keys' a = -0.5 cubic; ``align_mode`` never read."""
    x = torch.from_numpy(_rand((1, 1, 8, 8), 7))
    for mode, size, tm in (("nearest", [3, 3], "nearest"),
                           ("bilinear", [3, 3], "bilinear"),
                           ("bicubic", [13, 13], "bicubic")):
        ours = TF.interpolate(x, size=size, mode=mode)
        theirs = torch.nn.functional.interpolate(x, size=size, mode=tm)
        assert not torch.allclose(ours, theirs, atol=1e-3)
        torch.testing.assert_close(
            TF.interpolate(x, size=size, mode=mode, align_mode=1), ours)


# --- the rest of F.common ---------------------------------------------------

COMMON = {  # name: (ref fn, port fn, input shapes)
    "pad_constant": (lambda v: RF.pad(v, [1, 2, 0, 1], value=0.5),
                     lambda v: TF.pad(v, [1, 2, 0, 1], value=0.5),
                     [(2, 3, 4, 5)]),
    "pad_reflect": (lambda v: RF.pad(v, [1, 2, 2, 1], mode="reflect"),
                    lambda v: TF.pad(v, [1, 2, 2, 1], mode="reflect"),
                    [(2, 3, 4, 5)]),
    "pad_replicate_nhwc": (
        lambda v: RF.pad(v, [1, 0, 2, 1], mode="replicate",
                         data_format="NHWC"),
        lambda v: TF.pad(v, [1, 0, 2, 1], mode="replicate",
                         data_format="NHWC"), [(2, 4, 5, 3)]),
    "pad_circular_1d": (lambda v: RF.pad(v, [2, 1], mode="circular",
                                         data_format="NCL"),
                        lambda v: TF.pad(v, [2, 1], mode="circular",
                                         data_format="NCL"),
                        [(2, 3, 5)]),
    "zeropad2d": (lambda v: RF.zeropad2d(v, [1, 2, 0, 3]),
                  lambda v: TF.zeropad2d(v, [1, 2, 0, 3]),
                  [(2, 3, 4, 5)]),
    "zeropad2d_nhwc": (lambda v: RF.zeropad2d(v, [1, 2, 0, 3], "NHWC"),
                       lambda v: TF.zeropad2d(v, [1, 2, 0, 3], "NHWC"),
                       [(2, 4, 5, 3)]),
    "unfold": (lambda v: RF.unfold(v, [2, 3], [1, 2], 1, [1, 2]),
               lambda v: TF.unfold(v, [2, 3], [1, 2], 1, [1, 2]),
               [(2, 3, 6, 7)]),
    "unfold_four_pads": (lambda v: RF.unfold(v, 2, 2, [1, 0, 2, 1]),
                         lambda v: TF.unfold(v, 2, 2, [1, 0, 2, 1]),
                         [(2, 3, 6, 7)]),
    "fold": (lambda v: RF.fold(v, [5, 6], [2, 3], 1, [1, 1], [1, 1]),
             lambda v: TF.fold(v, [5, 6], [2, 3], 1, [1, 1], [1, 1]),
             [(2, 18, 36)]),
    "fold_strided": (lambda v: RF.fold(v, [6, 6], 2, 2),
                     lambda v: TF.fold(v, [6, 6], 2, 2), [(2, 12, 9)]),
    "pixel_shuffle": (lambda v: RF.pixel_shuffle(v, 2),
                      lambda v: TF.pixel_shuffle(v, 2), [(2, 8, 3, 4)]),
    "pixel_shuffle_nhwc": (lambda v: RF.pixel_shuffle(v, 2, "NHWC"),
                           lambda v: TF.pixel_shuffle(v, 2, "NHWC"),
                           [(2, 3, 4, 8)]),
    "pixel_unshuffle": (lambda v: RF.pixel_unshuffle(v, 2),
                        lambda v: TF.pixel_unshuffle(v, 2), [(2, 3, 4, 6)]),
    "channel_shuffle": (lambda v: RF.channel_shuffle(v, 3),
                        lambda v: TF.channel_shuffle(v, 3), [(2, 6, 3, 4)]),
    "bilinear": (RF.bilinear, TF.bilinear, [(4, 3), (4, 5), (2, 3, 5), (2,)]),
    "bilinear_no_bias": (RF.bilinear, TF.bilinear, [(4, 3), (4, 5),
                                                    (2, 3, 5)]),
    "cosine_similarity": (lambda a, b: RF.cosine_similarity(a, b),
                          lambda a, b: TF.cosine_similarity(a, b),
                          [(4, 6, 3), (4, 6, 3)]),
    "cosine_similarity_last": (
        lambda a, b: RF.cosine_similarity(a, b, axis=-1, eps=1e-6),
        lambda a, b: TF.cosine_similarity(a, b, axis=-1, eps=1e-6),
        [(4, 6), (4, 6)]),
    "label_smooth": (lambda v: RF.label_smooth(v, epsilon=0.2),
                     lambda v: TF.label_smooth(v, epsilon=0.2), [(3, 5)]),
    "label_smooth_prior": (
        lambda v, p: RF.label_smooth(v, p, 0.1),
        lambda v, p: TF.label_smooth(v, p, 0.1), [(3, 5), (1, 5)]),
    "diag_embed": (RF.diag_embed, TF.diag_embed, [(2, 4)]),
    "diag_embed_offset": (lambda v: RF.diag_embed(v, 1),
                          lambda v: TF.diag_embed(v, 1), [(2, 3, 4)]),
    "diag_embed_neg_swapped": (lambda v: RF.diag_embed(v, -2, -1, -2),
                               lambda v: TF.diag_embed(v, -2, -1, -2),
                               [(2, 3)]),
    "diag_embed_dims": (lambda v: RF.diag_embed(v, 0, 0, 2),
                        lambda v: TF.diag_embed(v, 0, 0, 2), [(2, 3)]),
}


@pytest.mark.parametrize("case", sorted(COMMON))
def test_common_function_matches_jax(case):
    ref_fn, port_fn, shapes = COMMON[case]
    arrays = [_rand(s, 10 + i) for i, s in enumerate(shapes)]
    _match(ref_fn, port_fn, arrays)


@pytest.mark.parametrize("maxlen", [None, 6])
def test_sequence_mask_matches_jax(maxlen):
    lengths = np.array([[1, 4], [0, 3]], np.int32)
    want = RF.sequence_mask(paddle.to_tensor(lengths), maxlen).numpy()
    got = TF.sequence_mask(torch.from_numpy(lengths), maxlen)
    assert got.dtype == torch.int32 and str(want.dtype) == "int32"
    np.testing.assert_array_equal(got.numpy(), want)
    got = TF.sequence_mask(torch.from_numpy(lengths), maxlen, "bool")
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))


def test_one_hot_gives_a_zero_row_out_of_range():
    """``jax.nn.one_hot``'s rule (torch's ``one_hot`` raises)."""
    ids = np.array([[0, 3], [5, -1]], np.int32)
    want = RF.one_hot(paddle.to_tensor(ids), 4).numpy()
    got = TF.one_hot(torch.from_numpy(ids), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[1].any()


def test_class_center_sample_keeps_every_positive_class():
    label = np.array([7, 2, 7, 9, 2], np.int64)
    ref = RF.class_center_sample(paddle.to_tensor(label), 12, 3)
    got = TF.class_center_sample(torch.from_numpy(label), 12, 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    remap, sampled = TF.class_center_sample(torch.from_numpy(label), 12, 6)
    s = sampled.numpy()
    assert len(s) == 6 == len(set(s)) and list(s[:3]) == [2, 7, 9]
    np.testing.assert_array_equal(s[remap.numpy()], label)


def test_dropout2d_3d_drop_whole_channels_and_alpha_dropout_is_affine():
    x = torch.from_numpy(_rand((4, 6, 3, 5), 20)) + 10.0
    for fn, shape in ((TF.dropout2d, (4, 6, 3, 5)),
                      (TF.dropout3d, (4, 6, 3, 5, 1))):
        out = fn(x.reshape(shape), p=0.5)
        ch = out.reshape(4, 6, -1)
        zero = (ch == 0).all(-1)
        kept = torch.isclose(ch, 2 * x.reshape(4, 6, -1)).all(-1)
        assert bool((zero | kept).all()) and zero.any() and kept.any()
        assert fn(x.reshape(shape), p=0.5, training=False) is not None
    p, alpha_p = 0.3, -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    out = TF.alpha_dropout(x, p)
    hit = torch.isclose(out, a * x + b) | torch.isclose(
        out, torch.full_like(out, a * alpha_p + b))
    assert bool(hit.all())
    assert TF.alpha_dropout(x, p, training=False) is x


# --- norm -------------------------------------------------------------------

NORM = {
    "instance_norm": (lambda v, w, b: RF.instance_norm(v, weight=w, bias=b),
                      lambda v, w, b: TF.instance_norm(v, weight=w, bias=b),
                      [(2, 3, 4, 5), (3,), (3,)]),
    "instance_norm_nlc_plain": (
        lambda v: RF.instance_norm(v, data_format="NLC"),
        lambda v: TF.instance_norm(v, data_format="NLC"), [(2, 7, 3)]),
    "group_norm": (lambda v, w, b: RF.group_norm(v, 2, 1e-5, w, b),
                   lambda v, w, b: TF.group_norm(v, 2, 1e-5, w, b),
                   [(2, 4, 3, 5), (4,), (4,)]),
    "group_norm_nhwc": (
        lambda v, w: RF.group_norm(v, 3, 1e-4, w, data_format="NHWC"),
        lambda v, w: TF.group_norm(v, 3, 1e-4, w, data_format="NHWC"),
        [(2, 3, 5, 6), (6,)]),
    "normalize": (RF.normalize, TF.normalize, [(3, 4, 5)]),
    "normalize_p1": (lambda v: RF.normalize(v, 1, -1),
                     lambda v: TF.normalize(v, 1, -1), [(3, 4)]),
    "local_response_norm": (lambda v: RF.local_response_norm(v, 3),
                            lambda v: TF.local_response_norm(v, 3),
                            [(2, 5, 3, 4)]),
    "local_response_norm_nhwc": (
        lambda v: RF.local_response_norm(v, 4, 1e-3, 0.5, 2.0, "NHWC"),
        lambda v: TF.local_response_norm(v, 4, 1e-3, 0.5, 2.0, "NHWC"),
        [(2, 3, 4, 6)]),
}


@pytest.mark.parametrize("case", sorted(NORM))
def test_norm_function_matches_jax(case):
    ref_fn, port_fn, shapes = NORM[case]
    _match(ref_fn, port_fn, [_rand(s, 30 + i) for i, s in enumerate(shapes)])


def test_instance_norm_reads_no_running_statistics():
    """The reference's trap: running statistics, ``use_input_stats`` and
    ``momentum`` are accepted and never read."""
    x = torch.from_numpy(_rand((2, 3, 6), 40))
    rm, rv = torch.full((3,), 5.0), torch.full((3,), 9.0)
    torch.testing.assert_close(
        TF.instance_norm(x, rm, rv, use_input_stats=False, momentum=0.1),
        TF.instance_norm(x))
    assert rm.eq(5.0).all() and rv.eq(9.0).all()


# --- pooling ----------------------------------------------------------------

ADAPTIVE = {
    "1d_general": ("adaptive_max_pool1d", (2, 3, 7), 3, {}),
    "1d_one": ("adaptive_max_pool1d", (2, 3, 7), 1, {}),
    "2d_divisible": ("adaptive_max_pool2d", (2, 3, 6, 8), [3, 4], {}),
    "2d_general_nhwc": ("adaptive_max_pool2d", (2, 7, 5, 3), [3, 2],
                        dict(data_format="NHWC")),
    "3d_mixed": ("adaptive_max_pool3d", (1, 2, 4, 5, 6), [2, 3, 1], {}),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE))
def test_adaptive_max_pool_matches_jax(case):
    name, shape, size, kw = ADAPTIVE[case]
    _match(lambda v: getattr(RF, name)(v, size, **kw),
           lambda v: getattr(TF, name)(v, size, **kw), [_rand(shape, 41)])


UNPOOL = {  # n: (x shape, kernel, stride, padding, data_format)
    "1d": (1, (2, 3, 8), 2, 2, 0, "NCL"),
    "2d": (2, (2, 3, 6, 8), 2, 2, 0, "NCHW"),
    "2d_pad_nhwc": (2, (2, 6, 8, 3), 3, 3, 1, "NHWC"),
    "3d": (3, (1, 2, 4, 4, 6), 2, 2, 0, "NCDHW"),
}


@pytest.mark.parametrize("case", sorted(UNPOOL))
def test_max_unpool_of_the_pools_mask_matches_jax(case):
    n, shape, k, s, p, fmt = UNPOOL[case]
    x = _rand(shape, 42)
    pool = f"max_pool{n}d"
    unpool = f"max_unpool{n}d"
    fmt_kw = {} if n == 1 else dict(data_format=fmt)

    def ref_fn(v):
        out, mask = getattr(RF, pool)(v, k, s, p, return_mask=True,
                                      **fmt_kw)
        return getattr(RF, unpool)(out, mask, k, s, p, data_format=fmt)

    def port_fn(v):
        out, mask = getattr(TF, pool)(v, k, s, p, return_mask=True,
                                      **fmt_kw)
        return getattr(TF, unpool)(out, mask, k, s, p, data_format=fmt)

    _match(ref_fn, port_fn, [x])


# --- vision -----------------------------------------------------------------

@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_matches_jax(align):
    theta = _rand((2, 2, 3), 50)
    _match(lambda t: RF.affine_grid(t, [2, 3, 5, 4], align),
           lambda t: TF.affine_grid(t, [2, 3, 5, 4], align), [theta])


GRID = [(m, p, a) for m in ("bilinear", "nearest")
        for p in ("zeros", "border", "reflection") for a in (True, False)]


@pytest.mark.parametrize("mode, padding, align", GRID)
def test_grid_sample_matches_jax(mode, padding, align):
    x = _rand((2, 3, 5, 6), 51)
    grid = _rand((2, 4, 7, 2), 52, -1.4, 1.4)

    def kw(fn):
        return lambda v, g: fn(v, g, mode, padding, align)

    # the grid's gradient is zero almost everywhere for "nearest"; both
    # packages take it through floor / round
    _match(kw(RF.grid_sample), kw(TF.grid_sample), [x, grid])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_temporal_shift_matches_jax(fmt):
    x = _rand((6, 8, 3, 4) if fmt == "NCHW" else (6, 3, 4, 8), 53)
    _match(lambda v: RF.temporal_shift(v, 3, 0.25, fmt),
           lambda v: TF.temporal_shift(v, 3, 0.25, fmt), [x])


# --- layers -----------------------------------------------------------------

def _port_of(ref, port):
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    assert list(port.state_dict()) == list(state)
    return tnn.load_numpy_state_dict(port, state)


LAYERS = {  # name: (make(pkg, **port kw), input shapes)
    "Identity": (lambda m, **k: m.Identity(3, foo=1), [(2, 3)]),
    "Dropout2D_eval": (lambda m, **k: m.Dropout2D(0.5).eval(),
                       [(2, 3, 4, 4)]),
    "Dropout3D_eval": (lambda m, **k: m.Dropout3D(0.5).eval(),
                       [(2, 3, 2, 4, 4)]),
    "AlphaDropout_eval": (lambda m, **k: m.AlphaDropout(0.5).eval(),
                          [(2, 3)]),
    "Upsample": (lambda m, **k: m.Upsample(scale_factor=2, mode="bilinear"),
                 [(2, 3, 4, 5)]),
    "UpsamplingBilinear2D": (lambda m, **k: m.UpsamplingBilinear2D([7, 9]),
                             [(2, 3, 4, 5)]),
    "UpsamplingNearest2D": (lambda m, **k: m.UpsamplingNearest2D(
        scale_factor=3), [(2, 3, 4, 5)]),
    "Bilinear": (lambda m, **k: m.Bilinear(3, 4, 5, **k), [(6, 3), (6, 4)]),
    "PixelShuffle": (lambda m, **k: m.PixelShuffle(2), [(2, 8, 3, 3)]),
    "PixelUnshuffle": (lambda m, **k: m.PixelUnshuffle(2), [(2, 2, 4, 6)]),
    "ChannelShuffle": (lambda m, **k: m.ChannelShuffle(2), [(2, 6, 3, 3)]),
    "CosineSimilarity": (lambda m, **k: m.CosineSimilarity(axis=-1),
                         [(4, 5), (4, 5)]),
    "Unfold": (lambda m, **k: m.Unfold(3, 1, 1), [(2, 3, 5, 5)]),
    "Fold": (lambda m, **k: m.Fold([4, 5], 2), [(2, 12, 12)]),
    "Pad1D": (lambda m, **k: m.Pad1D([1, 2], mode="reflect"), [(2, 3, 5)]),
    "Pad2D": (lambda m, **k: m.Pad2D([1, 0, 2, 1], value=1.5),
              [(2, 3, 4, 5)]),
    "Pad3D": (lambda m, **k: m.Pad3D([1, 0, 1, 1, 0, 2], mode="replicate"),
              [(1, 2, 3, 4, 5)]),
    "ZeroPad2D": (lambda m, **k: m.ZeroPad2D([1, 2, 3, 0]), [(2, 3, 4, 5)]),
    "PairwiseDistance": (lambda m, **k: m.PairwiseDistance(3.0, keepdim=True),
                         [(4, 6), (4, 6)]),
    "Softmax2D": (lambda m, **k: m.Softmax2D(), [(2, 3, 4, 5)]),
    "InstanceNorm1D": (lambda m, **k: m.InstanceNorm1D(3, **k), [(2, 3, 6)]),
    "InstanceNorm2D": (lambda m, **k: m.InstanceNorm2D(3, **k),
                       [(2, 3, 4, 5)]),
    "InstanceNorm3D_no_affine": (lambda m, **k: m.InstanceNorm3D(
        3, weight_attr=False, **k), [(2, 3, 2, 3, 4)]),
    "GroupNorm": (lambda m, **k: m.GroupNorm(2, 4, **k), [(2, 4, 3, 3)]),
    "LocalResponseNorm": (lambda m, **k: m.LocalResponseNorm(3),
                          [(2, 5, 3, 3)]),
    "SpectralNorm": (lambda m, **k: m.SpectralNorm([4, 6], 0, 2, **k),
                     [(4, 6)]),
    "AdaptiveMaxPool1D": (lambda m, **k: m.AdaptiveMaxPool1D(3),
                          [(2, 3, 7)]),
    "AdaptiveMaxPool2D": (lambda m, **k: m.AdaptiveMaxPool2D([2, 3]),
                          [(2, 3, 5, 7)]),
    "AdaptiveMaxPool3D": (lambda m, **k: m.AdaptiveMaxPool3D(2),
                          [(1, 2, 4, 5, 4)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make, shapes = LAYERS[name]
    paddle.seed(1)
    ref = make(ref_nn)
    try:
        port = make(tnn, device="cpu")
    except TypeError:               # a layer without parameters
        port = make(tnn)
    assert isinstance(port, tnn.Layer)
    _port_of(ref, port)
    arrays = [_rand(s, 60 + i) for i, s in enumerate(shapes)]
    _match(ref, port, arrays)
    for (k, a), b in zip(ref.named_parameters(), port.parameters()):
        assert b.requires_grad and tuple(b.shape) == tuple(a.shape), k


@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_unpool_layer_matches_jax(n):
    shape = {1: (2, 3, 8), 2: (2, 3, 4, 6), 3: (1, 2, 4, 4, 2)}[n]
    x = _rand(shape, 70)
    ref_pool, port_pool = (getattr(m, f"max_pool{n}d") for m in (RF, TF))
    ref_un = getattr(ref_nn, f"MaxUnPool{n}D")(2)
    port_un = getattr(tnn, f"MaxUnPool{n}D")(2)
    _match(lambda v: ref_un(*ref_pool(v, 2, return_mask=True)),
           lambda v: port_un(*port_pool(v, 2, return_mask=True)), [x])


def test_spectral_norm_never_updates_its_vectors():
    """The reference's trap: every call starts from the same u and v."""
    layer = tnn.SpectralNorm([4, 6], power_iters=1, device="cpu")
    u = layer.weight_u.clone()
    w = torch.from_numpy(_rand((4, 6), 71))
    first = layer(w)
    torch.testing.assert_close(layer(w), first)
    assert torch.equal(layer.weight_u, u)


def test_return_mask_of_adaptive_max_pools_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tnn.AdaptiveMaxPool2D(2, return_mask=True)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        TF.adaptive_max_pool1d(torch.zeros(1, 1, 4), 2, return_mask=True)


# --- the transformer layers' *_attr ------------------------------------------

def test_transformer_layers_take_weight_and_bias_attr():
    attr = tnn.ParamAttr(initializer=tnn.initializer.Constant(0.25))
    layer = tnn.TransformerEncoderLayer(8, 2, 16, 0.0, "gelu",
                                        weight_attr=attr, bias_attr=False,
                                        device="cpu")
    lin = [m for m in layer.sublayers() if isinstance(m, tnn.Linear)]
    assert len(lin) == 6
    assert all(m.bias is None and bool((m.weight == 0.25).all())
               for m in lin)
    assert layer.activation is TF.gelu
    model = tnn.Transformer(8, 2, 1, 1, 16, 0.0, weight_attr=attr,
                            device="cpu")
    assert all(bool((m.weight == 0.25).all()) for m in model.sublayers()
               if isinstance(m, tnn.Linear))
    ref = ref_nn.MultiHeadAttention(8, 2, weight_attr=ref_nn.ParamAttr(
        initializer=ref_nn.initializer.Constant(0.25)), bias_attr=False)
    port = tnn.MultiHeadAttention(8, 2, weight_attr=attr, bias_attr=False,
                                  device="cpu")
    assert list(port.state_dict()) == list(ref.state_dict())


def test_fused_layers_attr_arguments_follow_the_reference():
    """``FusedFeedForward`` passes its linear attrs on; the reference's
    ``FusedMultiHeadAttention`` reads none of its ``*_attr`` (a trap,
    copied)."""
    attr = tnn.ParamAttr(initializer=tnn.initializer.Constant(0.5))
    ffn = port_inc.FusedFeedForward(8, 16, linear1_weight_attr=attr,
                                    linear2_bias_attr=False, device="cpu")
    assert bool((ffn.linear1.weight == 0.5).all()) and ffn.linear2.bias is None
    ref = ref_inc.FusedFeedForward(8, 16, linear2_bias_attr=False)
    assert list(ffn.state_dict()) == list(ref.state_dict())
    mha = port_inc.FusedMultiHeadAttention(8, 2, qkv_weight_attr=attr,
                                           linear_bias_attr=False,
                                           device="cpu")
    assert not bool((mha.attn.q_proj.weight == 0.5).all())
    assert mha.attn.out_proj.bias is not None
    ref = ref_inc.FusedMultiHeadAttention(8, 2, qkv_weight_attr=attr,
                                          linear_bias_attr=False)
    assert list(mha.state_dict()) == list(ref.state_dict())


_MATCHED = {
    "test_activation_matches_jax", "test_activation_layer_matches_jax",
    "test_prelu_layer_matches_jax", "test_interpolate_matches_jax",
    "test_common_function_matches_jax", "test_norm_function_matches_jax",
    "test_adaptive_max_pool_matches_jax",
    "test_max_unpool_of_the_pools_mask_matches_jax",
    "test_affine_grid_matches_jax", "test_grid_sample_matches_jax",
    "test_temporal_shift_matches_jax", "test_layer_matches_jax",
    "test_max_unpool_layer_matches_jax",
}
