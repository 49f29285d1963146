"""The port's GPT against the JAX package, on the same weights (the
reference's ``state_dict()`` through ``nn.load_numpy_state_dict``) and the
same numpy inputs, float32 on both sides, at ``GPTConfig.tiny()``:

* logits, and the gradient of every parameter (the tied word embedding
  among them) of the mean logit square;
* ``generate``'s greedy tokens, with the window clipped to
  ``max_position_embeddings`` (10 here, so the last steps clip);
* 3 steps of ``gpt_pretrain_step_factory`` against the reference's on a
  one-device mesh, the step's ``eval()`` (dropout off inside it, the
  model's mode restored after it), and the refusals.

Tolerance: f32 on both sides, apart by the order of sums only. The
logits are products with N(0, 1) word embeddings, up to ~50 in size:
1e-4 absolute (the Llama and BERT logits' limit); gradients 1e-5
absolute and relative. The 3 steps: losses 1e-5, parameters at most 1e-4
of a tensor's elements beyond 1e-5 and none beyond lr (the rule of
``tests/test_torch_train_step.py``); the key biases, whose gradients are
rounding noise (a shift of all of a query's scores, which the softmax
does not see), no further apart than 2·3·lr.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.models.nlp import gpt as ref_gpt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import nlp as port_nlp

LOGITS_TOL = dict(atol=1e-4, rtol=0)
TOL = dict(atol=1e-5, rtol=1e-5)
LR = 1e-3
NOISE_GRAD_PARAM = "attn.k_proj.bias"


def _gpt(**fields):
    paddle.seed(0)
    ref = ref_gpt.GPTForCausalLM(dataclasses.replace(
        ref_gpt.GPTConfig.tiny(), **fields))
    port = port_nlp.GPTForCausalLM(dataclasses.replace(
        port_nlp.GPTConfig.tiny(), **fields), device="cpu")
    tnn.load_numpy_state_dict(port, {k: np.asarray(v.numpy()) for k, v in
                                     ref.state_dict().items()})
    return ref, port


def _ids(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


def test_logits_and_grads_match_jax():
    ref, port = _gpt()
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    assert port_nlp.GPTConfig() == port_nlp.GPTConfig(
        vocab_size=50304, hidden_size=768, num_hidden_layers=12,
        num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=1024, dropout=0.1, layer_norm_eps=1e-5)
    ids = _ids(2, 16)
    r = ref(paddle.to_tensor(ids))
    (r ** 2).mean().backward()
    t = port(torch.from_numpy(ids).long())
    (t ** 2).mean().backward()
    assert t.shape == (2, 16, 256)
    np.testing.assert_allclose(t.detach().numpy(), r.numpy(), **LOGITS_TOL)
    ref_params = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].grad.numpy(), **TOL,
                                   err_msg=name)
    # the causal mask: a later token leaves earlier logits alone
    ids2 = ids.copy()
    ids2[:, 9:] = (ids2[:, 9:] + 1) % 256
    with torch.no_grad():
        t2 = port(torch.from_numpy(ids2).long())
    assert torch.equal(t2[:, :9], t.detach()[:, :9])


def test_generate_matches_jax_and_clips_its_window():
    ref, port = _gpt(max_position_embeddings=10)
    ids = _ids(2, 8, seed=1)
    want = ref.generate(paddle.to_tensor(ids), max_new_tokens=4).numpy()
    got = port.generate(torch.from_numpy(ids), max_new_tokens=4)
    assert got.shape == (2, 12) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :8].numpy(), ids)


def test_three_factory_steps_match_jax():
    ref, port = _gpt()
    ref.eval()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    j_params, j_opt, j_step = ref_gpt.gpt_pretrain_step_factory(
        ref, mesh, learning_rate=LR)
    params, opt, step = port_nlp.gpt_pretrain_step_factory(
        port, learning_rate=LR, device="cpu")
    assert params["wte.weight"] is port.wte.weight      # no copy held
    assert sorted(params) == sorted(j_params)
    ids = _ids(2, 16, seed=2)
    labels = np.roll(ids, -1, axis=1)
    for i in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt, jnp.asarray(ids),
                                         jnp.asarray(labels))
        params, opt, loss = step(params, opt, ids, labels)
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


def test_the_step_runs_in_eval_and_restores_the_mode():
    """At dropout 0.1 in ``train()``: the step's loss is the ``eval()``
    loss of the weights it starts from (dropout off inside the step, as
    in the reference's compiled step), and the model is back in
    ``train()`` after it."""
    _, port = _gpt(dropout=0.1)
    port.train()
    ids = _ids(2, 16, seed=3)
    labels = np.roll(ids, -1, axis=1)
    t_ids, t_labels = (torch.from_numpy(a).long() for a in (ids, labels))
    with torch.no_grad():
        port.eval()
        want = float(port_nlp.gpt.lm_loss(port, t_ids, t_labels))
        port.train()
        live = float(port_nlp.gpt.lm_loss(port, t_ids, t_labels))
    assert live != want
    params, opt, step = port_nlp.gpt_pretrain_step_factory(
        port, learning_rate=LR, device="cpu")
    _, _, loss = step(params, opt, ids, labels)
    assert float(loss) == want and port.training
    port.eval()
    step(params, opt, ids, labels)
    assert not port.training


# meshes the factories refuse before reading anything else of them
_PIPE_MESH = types.SimpleNamespace(shape={"data": 1, "pipe": 2},
                                   axis_names=("data", "pipe"))
_EXPERT_MESH = types.SimpleNamespace(shape={"expert": 2},
                                     axis_names=("expert",))


def test_factory_refusals_and_the_default_device():
    _, port = _gpt()
    # a mesh trains (test_torch_models_mesh.py); "pipe" above 1 and axes
    # the factory does not know are refused
    with pytest.raises(NotImplementedError, match="item 15"):
        port_nlp.gpt_pretrain_step_factory(port, _PIPE_MESH, device="cpu")
    with pytest.raises(ValueError, match="expert"):
        port_nlp.gpt_pretrain_step_factory(port, _EXPERT_MESH, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_nlp.GPTForCausalLM(port_nlp.GPTConfig.tiny(),
                                    device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_nlp.gpt_pretrain_step_factory(port, device=device)
