"""The port's 22 loss functions and 15 loss layers against the JAX
package's, on the same numpy-seeded inputs, float32 on both sides: each
value and the gradient of each floating input (``jax.vjp`` against
``torch.autograd`` with one seeded output gradient), over the options
that change the formula (reductions, class weights, soft labels, label
smoothing, ``use_softmax=False``, a class axis that is not the last,
``pos_weight``, ``batchmean``, ``swap``, the norm's order,
``norm_by_times``, a custom tree, ``return_softmax``). The layers hold the
reference's arguments and, for ``HSigmoidLoss``, its weights.

Kept as the reference has it (ROADMAP Queue 3): ``nll_loss`` takes the
log of its input (it is ``cross_entropy(use_softmax=False)``), so it is
fed probabilities here.

Tolerance: 1e-5 absolute and relative (float32, the same operations; the
CTC recursion's log-sum-exps and the norms' sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed, scale=1.0):
    return np.asarray(np.random.default_rng(seed).standard_normal(shape)
                      * scale, np.float32)


def _probs(shape, seed):
    x = np.exp(_rand(shape, seed))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _ints(shape, hi, seed):
    return np.random.default_rng(seed).integers(0, hi, shape)


def _sign(shape, seed):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _ref_vjp(case, arrays, seed):
    def f(*vs):
        return _first(case(RF, paddle.to_tensor,
                           *[paddle.Tensor(v) for v in vs]))._value

    vals = [jnp.asarray(a) for a in arrays]
    gout = _rand(jax.eval_shape(f, *vals).shape, seed)

    @jax.jit                        # one compile, not one per eager op
    def both(vals, g):
        out, vjp = jax.vjp(f, *vals)
        return out, vjp(g)

    out, grads = both(vals, jnp.asarray(gout))
    return np.asarray(out), [np.asarray(g) for g in grads], gout


def _port_vjp(case, arrays, gout):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = _first(case(TF, lambda a: torch.from_numpy(np.asarray(a)), *ts))
    grads = torch.autograd.grad(out, ts, torch.from_numpy(gout))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _match(case, arrays, seed=99):
    out_r, grads_r, gout = _ref_vjp(case, arrays, seed)
    out_p, grads_p = _port_vjp(case, arrays, gout)
    assert out_p.shape == out_r.shape
    np.testing.assert_allclose(out_p, out_r, **TOL)
    for i, (a, b) in enumerate(zip(grads_p, grads_r)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"input {i}")
    return out_p


LAB = _ints((6,), 5, 3)
LAB_IGN = np.where(np.arange(6) % 3 == 0, -100, LAB)
W5 = (np.arange(5) * 0.3 + 0.5).astype(np.float32)
SOFT = _probs((6, 5), 4)
B01 = (np.random.default_rng(5).random((6, 4)) < 0.5).astype(np.float32)
PM = _sign((6,), 6)
CTC_LAB = np.array([[1, 2, 2, 3], [3, 1, 0, 0], [2, 2, 2, 1]])
TABLE = np.array([[0, 1, -1], [0, 2, 3], [0, 1, 4], [0, 2, -1]])
CODE = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0]])

# name: (case(F, T, *diff tensors), differentiable arrays)
CASES = {
    "ce_weight_sum": (lambda F, T, x: F.cross_entropy(
        x, T(LAB), weight=T(W5), reduction="sum"), [_rand((6, 5), 1)]),
    "ce_weight_ignore_mean": (lambda F, T, x: F.cross_entropy(
        x, T(LAB_IGN), weight=T(W5)), [_rand((6, 5), 1)]),
    "ce_soft_smooth_weight": (lambda F, T, x: F.cross_entropy(
        x, T(SOFT), weight=T(W5), soft_label=True, label_smoothing=0.2,
        reduction="none"), [_rand((6, 5), 1)]),
    "ce_smooth_ignore_none": (lambda F, T, x: F.cross_entropy(
        x, T(LAB_IGN), label_smoothing=0.1, reduction="none"),
        [_rand((6, 5), 1)]),
    "ce_no_softmax": (lambda F, T, p: F.cross_entropy(
        p, T(LAB), use_softmax=False), [_probs((6, 5), 2)]),
    "ce_axis1": (lambda F, T, x: F.cross_entropy(
        x, T(LAB[:, None]), axis=1), [_rand((6, 5, 1), 1)]),
    "softmax_with_ce": (lambda F, T, x: F.softmax_with_cross_entropy(
        x, T(LAB_IGN)), [_rand((6, 5), 1)]),
    "softmax_with_ce_soft": (lambda F, T, x: F.softmax_with_cross_entropy(
        x, T(SOFT), soft_label=True), [_rand((6, 5), 1)]),
    "nll_loss_weight": (lambda F, T, p: F.nll_loss(
        p, T(LAB_IGN), weight=T(W5)), [_probs((6, 5), 2)]),
    "bce_weight": (lambda F, T, p: F.binary_cross_entropy(
        p, T(B01), weight=T(W5[:4])), [_probs((6, 4), 7)]),
    "bce_none": (lambda F, T, p: F.binary_cross_entropy(
        p, T(B01), reduction="none"), [_probs((6, 4), 7)]),
    "bce_logits": (lambda F, T, z: F.binary_cross_entropy_with_logits(
        z, T(B01), reduction="sum"), [_rand((6, 4), 8, 3.0)]),
    "bce_logits_weights": (lambda F, T, z: F.binary_cross_entropy_with_logits(
        z, T(B01), weight=T(W5[:4]), pos_weight=T(W5[1:])),
        [_rand((6, 4), 8, 3.0)]),
    "mse": (lambda F, T, a, b: F.mse_loss(a, b), [_rand((6, 4), 9),
                                                  _rand((6, 4), 10)]),
    "mse_none": (lambda F, T, a, b: F.mse_loss(a, b, "none"),
                 [_rand((6, 4), 9), _rand((6, 4), 10)]),
    "l1_sum": (lambda F, T, a, b: F.l1_loss(a, b, "sum"),
               [_rand((6, 4), 9), _rand((6, 4), 10)]),
    "smooth_l1": (lambda F, T, a, b: F.smooth_l1_loss(a, b, delta=0.5),
                  [_rand((6, 4), 9), _rand((6, 4), 10)]),
    "huber": (lambda F, T, a, b: F.huber_loss(a, b, 0.7, "none"),
              [_rand((6, 4), 9), _rand((6, 4), 10)]),
    "kl_div_batchmean": (lambda F, T, lp, y: F.kl_div(lp, y, "batchmean"),
                         [np.log(_probs((6, 4), 11)), _probs((6, 4), 12)]),
    "kl_div_sum": (lambda F, T, lp, y: F.kl_div(lp, y, "sum"),
                   [np.log(_probs((6, 4), 11)), _probs((6, 4), 12)]),
    "margin_ranking": (lambda F, T, a, b: F.margin_ranking_loss(
        a, b, T(PM), 0.3), [_rand((6,), 13), _rand((6,), 14)]),
    "hinge_embedding": (lambda F, T, x: F.hinge_embedding_loss(
        x, T(PM), 0.5, "sum"), [_rand((6,), 15)]),
    "cosine_embedding": (lambda F, T, a, b: F.cosine_embedding_loss(
        a, b, T(PM), 0.1), [_rand((6, 4), 16), _rand((6, 4), 17)]),
    "triplet_margin": (lambda F, T, a, p, n: F.triplet_margin_loss(
        a, p, n, 1.0), [_rand((6, 4), 18), _rand((6, 4), 19),
                        _rand((6, 4), 20)]),
    "triplet_margin_p1_swap": (lambda F, T, a, p, n: F.triplet_margin_loss(
        a, p, n, 2.0, p=1, swap=True, reduction="none"),
        [_rand((6, 4), 18), _rand((6, 4), 19), _rand((6, 4), 20)]),
    "log_loss": (lambda F, T, p: F.log_loss(p, T(B01)),
                 [_probs((6, 4), 21)]),
    "square_error_cost": (lambda F, T, a, b: F.square_error_cost(a, b),
                          [_rand((6, 4), 9), _rand((6, 4), 10)]),
    "ctc_mean": (lambda F, T, lp: F.ctc_loss(
        lp, T(CTC_LAB), T(np.array([7, 5, 6])), T(np.array([4, 2, 4])),
        blank=0), [np.log(_probs((7, 3, 5), 22))]),
    "ctc_norm_by_times_none": (lambda F, T, lp: F.ctc_loss(
        lp, T(CTC_LAB), T(np.array([7, 7, 6])), T(np.array([4, 2, 3])),
        blank=4, reduction="none", norm_by_times=True),
        [_rand((7, 3, 5), 23)]),
    "dice": (lambda F, T, x: F.dice_loss(x, T(_ints((3, 4, 1), 5, 24))),
             [_probs((3, 4, 5), 25)]),
    "npair": (lambda F, T, a, p: F.npair_loss(
        a, p, T(np.array([0, 1, 0, 2, 1, 0]))),
        [_rand((6, 4), 26), _rand((6, 4), 27)]),
    "sigmoid_focal": (lambda F, T, x: F.sigmoid_focal_loss(
        x, T(B01)), [_rand((6, 4), 28, 2.0)]),
    "sigmoid_focal_norm_mean": (lambda F, T, x, n: F.sigmoid_focal_loss(
        x, T(B01), n, alpha=-1.0, gamma=1.5, reduction="mean"),
        [_rand((6, 4), 28, 2.0), np.array([3.0], np.float32)]),
    "hsigmoid_default_tree": (lambda F, T, x, w, b: F.hsigmoid_loss(
        x, T(_ints((4,), 6, 29)), 6, w, b),
        [_rand((4, 3), 30), _rand((5, 3), 31), _rand((5,), 32)]),
    "hsigmoid_custom_tree": (lambda F, T, x, w: F.hsigmoid_loss(
        x, T(np.array([0, 1, 2, 3])), 5, w, None, T(TABLE), T(CODE)),
        [_rand((4, 3), 30), _rand((5, 3), 31)]),
    "margin_ce": (lambda F, T, x: F.margin_cross_entropy(
        x, T(LAB), reduction="sum"),
        [np.tanh(_rand((6, 5), 33)).astype(np.float32)]),
    "margin_ce_softmax_none": (lambda F, T, x: F.margin_cross_entropy(
        x, T(LAB), 1.2, 0.3, 0.1, 8.0, return_softmax=True,
        reduction=None), [np.tanh(_rand((6, 5), 33)).astype(np.float32)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    case, arrays = CASES[name]
    out = _match(case, arrays)
    assert np.isfinite(out).all()


def test_every_loss_function_is_covered():
    names = ("cross_entropy softmax_with_cross_entropy nll_loss "
             "binary_cross_entropy binary_cross_entropy_with_logits "
             "mse_loss l1_loss smooth_l1_loss huber_loss kl_div "
             "margin_ranking_loss hinge_embedding_loss "
             "cosine_embedding_loss triplet_margin_loss log_loss "
             "square_error_cost ctc_loss dice_loss npair_loss "
             "sigmoid_focal_loss hsigmoid_loss margin_cross_entropy").split()
    assert len(names) == 22
    for n in names:
        assert callable(getattr(TF, n)) and callable(getattr(RF, n)), n


def test_return_softmax_forms_match_jax():
    x = _rand((6, 5), 1)
    r_loss, r_sm = RF.softmax_with_cross_entropy(
        paddle.to_tensor(x), paddle.to_tensor(LAB), return_softmax=True)
    t_loss, t_sm = TF.softmax_with_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(LAB), return_softmax=True)
    np.testing.assert_allclose(t_loss.numpy(), r_loss.numpy(), **TOL)
    np.testing.assert_allclose(t_sm.numpy(), r_sm.numpy(), **TOL)
    c = np.tanh(x)
    r = RF.margin_cross_entropy(paddle.to_tensor(c), paddle.to_tensor(LAB),
                                return_softmax=True)
    t = TF.margin_cross_entropy(torch.from_numpy(c), torch.from_numpy(LAB),
                                return_softmax=True)
    for a, b in zip(t, r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _layer(name, pkg, T):
    layers = {
        "CrossEntropyLoss": (lambda: pkg.CrossEntropyLoss(
            weight=T(W5), label_smoothing=0.1), (LAB_IGN,), (6, 5)),
        "NLLLoss": (lambda: pkg.NLLLoss(reduction="sum"), (LAB,), "probs"),
        "BCELoss": (lambda: pkg.BCELoss(), (B01[:, :1].ravel(),), "p6"),
        "BCEWithLogitsLoss": (lambda: pkg.BCEWithLogitsLoss(
            pos_weight=T(W5[:4])), (B01,), (6, 4)),
        "MSELoss": (lambda: pkg.MSELoss("sum"), (_rand((6, 4), 40),),
                    (6, 4)),
        "L1Loss": (lambda: pkg.L1Loss(), (_rand((6, 4), 40),), (6, 4)),
        "SmoothL1Loss": (lambda: pkg.SmoothL1Loss(delta=0.3),
                         (_rand((6, 4), 40),), (6, 4)),
        "HuberLoss": (lambda: pkg.HuberLoss(0.4), (_rand((6, 4), 40),),
                      (6, 4)),
        "KLDivLoss": (lambda: pkg.KLDivLoss("batchmean"),
                      (_probs((6, 4), 41),), (6, 4)),
        "MarginRankingLoss": (lambda: pkg.MarginRankingLoss(0.2),
                              (_rand((6,), 42), PM), (6,)),
        "CosineEmbeddingLoss": (lambda: pkg.CosineEmbeddingLoss(0.2),
                                (_rand((6, 4), 43), PM), (6, 4)),
        "TripletMarginLoss": (lambda: pkg.TripletMarginLoss(swap=True),
                              (_rand((6, 4), 44), _rand((6, 4), 45)),
                              (6, 4)),
        "CTCLoss": (lambda: pkg.CTCLoss(blank=0, reduction="sum"),
                    (CTC_LAB, np.array([7, 5, 6]), np.array([4, 2, 4])),
                    (7, 3, 5)),
        "HingeEmbeddingLoss": (lambda: pkg.HingeEmbeddingLoss(0.3), (PM,),
                               (6,)),
        "HSigmoidLoss": (lambda: pkg.HSigmoidLoss(3, 6), (_ints((4,), 6,
                                                                46),),
                         (4, 3)),
    }
    return layers[name]


LAYER_NAMES = ["BCELoss", "BCEWithLogitsLoss", "CTCLoss",
               "CosineEmbeddingLoss", "CrossEntropyLoss",
               "HingeEmbeddingLoss", "HSigmoidLoss", "HuberLoss",
               "KLDivLoss", "L1Loss", "MSELoss", "MarginRankingLoss",
               "NLLLoss", "SmoothL1Loss", "TripletMarginLoss"]


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_loss_layer_matches_jax(name):
    ref_make, extra, shape = _layer(name, ref_nn, paddle.to_tensor)
    port_make, _, _ = _layer(name, tnn, lambda a: torch.from_numpy(
        np.asarray(a)))
    ref = ref_make()
    port = port_make() if name != "HSigmoidLoss" else tnn.HSigmoidLoss(
        3, 6, device="cpu")
    if shape == "probs":
        x = _probs((6, 5), 47)
    elif shape == "p6":
        x = _probs((6, 2), 47)[:, 0].copy()
    else:
        x = _rand(shape, 48)
        if name == "CTCLoss":
            x = np.log(_probs(shape, 48))
    arrays = [x]
    if name == "HSigmoidLoss":
        tnn.load_numpy_state_dict(port, {k: np.asarray(v._value) for k, v
                                         in ref.state_dict().items()})

    def case(F, T, xt):
        layer = ref if F is RF else port
        return layer(xt, *[T(e) for e in extra])

    out = _match(case, arrays)
    assert np.isfinite(out).all()
    if name == "HSigmoidLoss":
        assert tuple(port.weight.shape) == (5, 3)
        assert port.weight.abs().max() <= np.sqrt(6.0 / 8)
