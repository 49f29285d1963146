"""The port's BERT slice against the JAX package, on the same weights (the
reference's ``state_dict()`` through ``nn.load_numpy_state_dict``) and
the same numpy inputs, float32 on both sides:

* ``F.embedding`` with a loaded nonzero padding row, ``F.tanh`` and
  ``F.cross_entropy`` (scattered and all-ignored labels, every
  reduction): values and input gradients;
* ``nn.TransformerEncoderLayer`` pre- and post-LN, relu and gelu, at S =
  8 (plain attention on both sides) and at S = 256 with head_dim 64 (the
  JAX Pallas flash kernel in interpret mode against the port's plain
  flash), with and without an additive mask; ``nn.TransformerEncoder``
  with its layers' identical initial weights;
* ``BertForPretraining`` (mlm and nsp logits, ``loss`` and the gradient
  of every parameter, the tied word embedding among them) at ``tiny()``
  and at a flash-width config (hidden 128, 2 heads, S = 256), with and
  without ``attention_mask``; ``BertForSequenceClassification`` in
  ``eval()``; the mask's float32 sum with bfloat16 scores;
* 3 steps of ``bert_pretrain_step_factory`` against the reference's on a
  one-device mesh at S = 128 (plain attention on both sides), the
  all-ignored batch (the NSP term alone), ``remat=True`` against
  ``remat=False`` with dropout live, and the refusals.

Tolerance: f32 on both sides, apart by the order of sums only: 2e-5
absolute and relative for outputs and gradients, as
``tests/test_torch_fused_layers.py`` (largest BERT reading 0.25 of the
limit, ``mlm_transform.weight``'s gradient at ``tiny()``). The MLM
logits are products with N(0, 1) word embeddings, up to 52 in size, and
their order noise does not shrink where they cancel: 3.1e-5 absolute at
most (8 f32 ulps at 32). They are held, as the Llama logits of
``test_torch_train_step.py``, to atol 1e-4 (reading 0.31 of it). The 3
steps: losses within 1e-5 (reading 1.9e-6), parameters by the rule of
``test_torch_train_step.py``: at most 1e-4 of a parameter's elements
beyond 1e-5 and none beyond lr (readings 0, and 1.6e-6 at most); the
key bias, whose gradient is noise, no further apart than 2·3·lr
(reading 2.6e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.models import nlp as ref_nlp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import Generator
from paddle_tpu_torch.models import nlp as port_nlp
from paddle_tpu_torch.nn import functional as TF

TOL = dict(atol=2e-5, rtol=2e-5)
LOGITS_TOL = dict(atol=1e-4, rtol=0)
# a key bias shifts all of a query's scores alike, which the softmax does
# not see: its gradient is 0 but for rounding noise, and AdamW steps it
# by the sign of each package's own noise, about lr a step each way
NOISE_GRAD_PARAM = "self_attn.k_proj.bias"
LR = 1e-3
# hidden 128 / 2 heads: head_dim 64, flash-eligible at S = 256
WIDE = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=256)


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _port_of(ref, make):
    port = make()
    tnn.load_numpy_state_dict(port, _state(ref))
    return port


def _grads_match(ref, port):
    ref_params = dict(ref.named_parameters())
    port_params = dict(port.named_parameters())
    assert sorted(ref_params) == sorted(port_params)
    for name, p in port_params.items():
        r = ref_params[name].grad
        if r is None:               # a parameter the loss does not reach
            assert p.grad is None or not p.grad.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), r.numpy(), **TOL,
                                   err_msg=name)


# --- functional ------------------------------------------------------------

def test_embedding_zeroes_a_loaded_nonzero_padding_row():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((10, 6)).astype(np.float32)   # row 3 nonzero
    ids = np.array([[3, 1, 3, 9], [0, 3, 2, 3]], np.int32)
    gout = rng.standard_normal((2, 4, 6)).astype(np.float32)

    rw = paddle.to_tensor(w, stop_gradient=False)
    r = ref_nn.functional.embedding(paddle.to_tensor(ids), rw, padding_idx=3)
    (r * paddle.to_tensor(gout)).sum().backward()
    tw = torch.from_numpy(w).requires_grad_(True)
    t = TF.embedding(torch.from_numpy(ids).long(), tw, padding_idx=3)
    (t * torch.from_numpy(gout)).sum().backward()

    np.testing.assert_allclose(t.detach().numpy(), r.numpy(), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), rw.grad.numpy(), **TOL)
    assert not t[torch.from_numpy(ids) == 3].any()
    assert not tw.grad[3].any()
    # torch's own padding_idx zeroes the gradient only: not the formula
    raw = torch.nn.functional.embedding(torch.from_numpy(ids).long(),
                                        torch.from_numpy(w), padding_idx=3)
    assert raw[0, 0].abs().sum() > 0
    with pytest.raises(NotImplementedError, match="item 12"):
        TF.embedding(torch.from_numpy(ids).long(), tw, sparse=True)


def test_embedding_layer_init_and_tanh():
    emb = tnn.Embedding(7, 5, padding_idx=2, device="cpu",
                        generator=Generator(3))
    assert emb.weight.dtype == torch.float32
    assert not emb.weight[2].any() and emb.weight[0].abs().sum() > 0
    assert torch.equal(emb.weight, tnn.Embedding(
        7, 5, padding_idx=2, device="cpu", generator=Generator(3)).weight)
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    np.testing.assert_allclose(
        TF.tanh(torch.from_numpy(x)).numpy(),
        ref_nn.functional.tanh(paddle.to_tensor(x)).numpy(), **TOL)


CE_CASES = [("scattered", "mean"), ("scattered", "sum"),
            ("scattered", "none"), ("all_ignored", "mean"),
            ("all_ignored", "sum"), ("trailing_axis", "mean")]


@pytest.mark.parametrize("labels,reduction", CE_CASES,
                         ids=[f"{a}-{b}" for a, b in CE_CASES])
def test_cross_entropy_matches_jax(labels, reduction):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    lab = rng.integers(0, 11, (3, 5)).astype(np.int64)
    if labels == "scattered":
        lab[rng.random((3, 5)) < 0.4] = -100
    elif labels == "all_ignored":
        lab[:] = -100
    else:
        lab = lab[..., None]
    rx = paddle.to_tensor(logits, stop_gradient=False)
    r = ref_nn.functional.cross_entropy(rx, paddle.to_tensor(lab),
                                        reduction=reduction)
    r.sum().backward()
    tx = torch.from_numpy(logits).requires_grad_(True)
    t = TF.cross_entropy(tx, torch.from_numpy(lab), reduction=reduction)
    t.sum().backward()
    np.testing.assert_allclose(t.detach().numpy(), r.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), **TOL)
    if labels == "all_ignored":
        assert float(t.sum()) == 0.0 and not tx.grad.any()


def test_cross_entropy_refuses_what_is_not_ported():
    x, lab = torch.zeros(2, 3), torch.zeros(2, dtype=torch.long)
    for kw in (dict(weight=torch.ones(3)), dict(soft_label=True),
               dict(label_smoothing=0.1), dict(use_softmax=False),
               dict(axis=0)):
        with pytest.raises(NotImplementedError, match="item 12"):
            TF.cross_entropy(x, lab, **kw)
    with pytest.raises(ValueError, match="reduction"):
        TF.cross_entropy(x, lab, reduction="avg")


# --- the encoder layers ----------------------------------------------------

LAYER_CASES = [  # (S, E, heads, normalize_before, activation, masked)
    *[(8, 32, 4, pre, act, masked) for pre in (False, True)
      for act in ("relu", "gelu") for masked in (False, True)],
    (256, 128, 2, False, "gelu", False), (256, 128, 2, True, "relu", False),
    (256, 128, 2, False, "gelu", True), (256, 128, 2, True, "relu", True),
]


def _additive(B, S, seed):
    """(B, 1, 1, S) float32 additive mask: 0, or float32's lowest on the
    last quarter of each row's keys but the first row's."""
    m = np.zeros((B, 1, 1, S), np.float32)
    m[1:, ..., 3 * S // 4:] = np.finfo(np.float32).min
    m += np.random.default_rng(seed).standard_normal(m.shape) \
        .astype(np.float32) * (m == 0)
    return m


@pytest.mark.parametrize(
    "S,E,heads,pre,act,masked", LAYER_CASES,
    ids=[f"S{c[0]}-{'pre' if c[3] else 'post'}-{c[4]}"
         f"{'-mask' if c[5] else ''}" for c in LAYER_CASES])
def test_encoder_layer_matches_jax(S, E, heads, pre, act, masked):
    paddle.seed(0)
    ref = ref_nn.TransformerEncoderLayer(E, heads, 2 * E, dropout=0.0,
                                         activation=act,
                                         normalize_before=pre)
    port = _port_of(ref, lambda: tnn.TransformerEncoderLayer(
        E, heads, 2 * E, dropout=0.0, activation=act, normalize_before=pre,
        device="cpu"))
    x = np.random.default_rng(S + E).standard_normal((2, S, E)) \
        .astype(np.float32)
    mask = _additive(2, S, 5) if masked else None

    r_out = ref(paddle.to_tensor(x),
                None if mask is None else paddle.to_tensor(mask))
    (r_out ** 2).mean().backward()
    t_out = port(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask))
    (t_out ** 2).mean().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), r_out.numpy(), **TOL)
    _grads_match(ref, port)


def test_encoder_stack_starts_from_one_layer_and_matches_jax():
    paddle.seed(0)
    ref = ref_nn.TransformerEncoder(
        ref_nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0), 2)
    state = _state(ref)
    for k, v in state.items():               # the reference's deep copies
        if k.startswith("layers.1."):
            np.testing.assert_array_equal(v, state["layers.0." + k[9:]])
    gen = Generator(0)
    fresh = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.1, device="cpu", generator=gen), 2)
    for (k0, a), (k1, b) in zip(fresh.layers[0].named_parameters(),
                                fresh.layers[1].named_parameters()):
        assert k0 == k1 and torch.equal(a, b), k0
    # the copies draw dropout from the one generator, not from copies
    assert fresh.layers[1].dropout1.generator is gen
    assert sorted(fresh.state_dict()) == sorted(state)

    port = _port_of(ref, lambda: tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0, device="cpu"),
        2))
    x = np.random.default_rng(2).standard_normal((2, 8, 32)) \
        .astype(np.float32)
    r_out = ref(paddle.to_tensor(x))
    (r_out ** 2).mean().backward()
    t_out = port(torch.from_numpy(x))
    (t_out ** 2).mean().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), r_out.numpy(), **TOL)
    _grads_match(ref, port)
    with pytest.raises(NotImplementedError, match="item 7"):
        port(torch.from_numpy(x), cache=[None, None])


# --- BERT ------------------------------------------------------------------

def _configs(kind):
    if kind == "tiny":
        return ref_nlp.BertConfig.tiny(), port_nlp.BertConfig.tiny(), 16
    return (ref_nlp.BertConfig(**WIDE), port_nlp.BertConfig(**WIDE), 256)


def _bert(kind, cls="BertForPretraining"):
    rcfg, tcfg, S = _configs(kind)
    paddle.seed(0)
    ref = getattr(ref_nlp.bert, cls)(rcfg)
    port = _port_of(ref, lambda: getattr(port_nlp, cls)(tcfg, device="cpu"))
    return ref, port, tcfg, S


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    types = np.zeros((B, S), np.int32)
    types[:, S // 2:] = 1
    mlm = np.where(rng.random((B, S)) < 0.15,
                   rng.integers(0, cfg.vocab_size, (B, S)), -100) \
        .astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S - S // 4:] = 0
    return ids, types, mlm, nsp, mask


BERT_CASES = [("tiny", False), ("tiny", True), ("wide", False),
              ("wide", True)]


@pytest.mark.parametrize("kind,masked", BERT_CASES,
                         ids=[f"{k}{'-mask' if m else ''}"
                              for k, m in BERT_CASES])
def test_pretraining_forward_loss_and_grads_match_jax(kind, masked):
    ref, port, cfg, S = _bert(kind)
    ids, types, mlm, nsp, mask = _batch(cfg, 2, S)
    r_mask = paddle.to_tensor(mask) if masked else None
    r_mlm, r_nsp = ref(paddle.to_tensor(ids), paddle.to_tensor(types),
                       r_mask)
    r_loss = ref.loss(r_mlm, r_nsp, paddle.to_tensor(mlm),
                      paddle.to_tensor(nsp))
    r_loss.backward()

    t = [torch.from_numpy(a).long() for a in (ids, types, mlm, nsp, mask)]
    t_mlm, t_nsp = port(t[0], t[1], t[4] if masked else None)
    t_loss = port.loss(t_mlm, t_nsp, t[2], t[3])
    t_loss.backward()
    assert t_mlm.shape == (2, S, cfg.vocab_size) and t_nsp.shape == (2, 2)
    np.testing.assert_allclose(t_mlm.detach().numpy(), r_mlm.numpy(),
                               **LOGITS_TOL)
    np.testing.assert_allclose(t_nsp.detach().numpy(), r_nsp.numpy(), **TOL)
    np.testing.assert_allclose(float(t_loss), float(r_loss), **TOL)
    _grads_match(ref, port)
    # the tied head: one parameter, whose gradient sums both uses
    assert port.bert.embeddings.word_embeddings.weight.grad.abs().sum() > 0
    assert "mlm_head.weight" not in dict(port.named_parameters())


def test_sequence_classification_matches_jax_in_eval():
    ref, port, cfg, S = _bert("tiny", "BertForSequenceClassification")
    ref.eval()
    port.eval()
    ids, types, _, _, mask = _batch(cfg, 3, S)
    want = ref(paddle.to_tensor(ids), paddle.to_tensor(types),
               paddle.to_tensor(mask)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(),
                   torch.from_numpy(types).long(),
                   torch.from_numpy(mask).long())
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_scores_plus_the_f32_mask_sum_in_f32():
    """bf16 q, k, v and the f32 additive mask on the plain path: the sum
    is f32 before the f32 softmax (torch's promotion, as jnp's), so the
    output equals that formula and the reference's bf16 call, and not
    the one that rounds the mask to bf16 first."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
               for _ in range(3))
    mask = rng.standard_normal((2, 1, 1, 8)).astype(np.float32) * 3
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    got = TF.scaled_dot_product_attention(tq, tk, tv, attn_mask=tm)
    assert got.dtype == torch.bfloat16

    def formula(m):
        s = torch.matmul(tq.transpose(1, 2), tk.transpose(1, 2)
                         .transpose(-1, -2)) * 0.25
        p = torch.softmax((s + m).to(torch.float32), -1).to(torch.bfloat16)
        return torch.matmul(p, tv.transpose(1, 2)).transpose(1, 2)
    assert (torch.ones(1, dtype=torch.bfloat16) + tm).dtype == torch.float32
    assert torch.equal(got, formula(tm))
    assert not torch.equal(got, formula(tm.to(torch.bfloat16)))
    want = ref_nn.functional.scaled_dot_product_attention(
        *(paddle.to_tensor(a).astype("bfloat16") for a in (q, k, v)),
        attn_mask=paddle.to_tensor(mask))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype("float32").numpy()),
                               atol=1e-2, rtol=2 ** -7)


# --- the pretraining step --------------------------------------------------

def _factories():
    ref, port, cfg, _ = _bert("wide")
    ref.eval()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    j_params, j_opt, j_step = ref_nlp.bert_pretrain_step_factory(
        ref, mesh, learning_rate=LR)
    params, opt, step = port_nlp.bert_pretrain_step_factory(
        port, None, learning_rate=LR, device="cpu")
    return (j_params, j_opt, j_step), (params, opt, step), port, cfg


def test_three_factory_steps_match_jax():
    (j_params, j_opt, j_step), (params, opt, step), port, cfg = _factories()
    ids, types, mlm, nsp, _ = _batch(cfg, 2, 128, seed=7)
    assert params["bert.embeddings.word_embeddings.weight"] is \
        port.bert.embeddings.word_embeddings.weight    # no copy held
    assert sorted(params) == sorted(j_params)
    for i in range(3):
        j_params, j_opt, j_loss = j_step(
            j_params, j_opt, *(jnp.asarray(a) for a in (ids, types, mlm,
                                                        nsp)))
        params, opt, loss = step(params, opt, ids, types, mlm, nsp)
        np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                                   rtol=0, err_msg=f"step {i}")
    assert int(opt["step"]) == 3
    for k, p in params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(j_params[k]))
        if k.endswith(NOISE_GRAD_PARAM):
            assert diff.max() <= 2 * 3 * LR, k
            continue
        assert (diff > 1e-5).mean() <= 1e-4, k
        assert diff.max() <= LR, k

    # every label ignored: the NSP term alone, as in the reference
    ignored = np.full_like(mlm, -100)
    _, _, j_loss = j_step(j_params, j_opt, *(jnp.asarray(a) for a in (
        ids, types, ignored, nsp)))
    with torch.no_grad():
        _, nsp_logits = port(torch.from_numpy(ids).long(),
                             torch.from_numpy(types).long())
    nsp_only = float(TF.cross_entropy(nsp_logits, torch.from_numpy(nsp)))
    _, _, loss = step(params, opt, ids, types, ignored, nsp)
    np.testing.assert_allclose(float(loss), nsp_only, atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                               rtol=0)
    assert float(loss) < 2.0


def test_remat_equals_no_remat_with_live_dropout():
    """At dropout 0.1 in ``train()``, each model's generator reseeded:
    the checkpointed step recomputes with the forward's own draws, so
    losses and parameters equal those without remat."""
    cfg = dataclasses.replace(port_nlp.BertConfig(**WIDE),
                              hidden_dropout_prob=0.1)
    ids, types, mlm, nsp, _ = _batch(cfg, 2, 128, seed=8)
    runs = []
    for remat in (False, True):
        gen = Generator(5)
        model = port_nlp.BertForPretraining(cfg, device="cpu", generator=gen)
        params, opt, step = port_nlp.bert_pretrain_step_factory(
            model, learning_rate=LR, remat=remat, device="cpu")
        losses = [float(step(params, opt, ids, types, mlm, nsp)[2])
                  for _ in range(2)]
        runs.append((losses, {k: p.detach().clone()
                              for k, p in params.items()}))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], atol=0, rtol=0, msg=k)
    assert l0[1] < l0[0]


def test_factory_refusals_and_the_default_device():
    port = port_nlp.BertForPretraining(port_nlp.BertConfig.tiny(),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        port_nlp.bert_pretrain_step_factory(port, object(), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        port_nlp.bert_pretrain_step_factory(port, remat="dots",
                                            device="cpu")
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_nlp.BertForPretraining(port_nlp.BertConfig.tiny(),
                                        device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_nlp.bert_pretrain_step_factory(port, device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tnn.Embedding(4, 2, device=device)
