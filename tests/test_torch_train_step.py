"""The port's training slice against the JAX package on one tiny f32 GQA
config (hidden 256, 4 heads / 2 kv heads -> head_dim 64, 2 layers, vocab
256) at B=2, S=256, a flash-eligible shape, with the same weights (carried
by ``load_numpy_state_dict``) and the same numpy batch:

* the port's ``LlamaForCausalLM.forward`` (the plain GQA flash path)
  against the JAX model's forward (the Pallas GQA kernel in interpret
  mode);
* the loss and every gradient of the port's ``llama_functional.loss_fn``
  against ``jax.grad`` of the JAX ``loss_fn`` with its Pallas flash path
  forced on (``_FORCE_FLASH_FOR_TESTS``); the JAX loss is its dense
  log-softmax on the CPU, the port's the fused CE's plain version: the
  same function;
* 3 steps of ``llama_train_step_factory`` in both packages (a one-device
  CPU mesh on the JAX side), with and without remat: losses, then every
  parameter;
* the refusal of every option the port has not ported.

Tolerances (f32 on both sides, apart by the order of sums only): logits
atol 1e-4 (reading 4e-6); loss atol 1e-5 (reading 1e-6); gradients atol
1e-5 (reading 4e-8, every gradient is below 3e-3 in size); the losses of
3 steps atol 1e-5 (reading 3e-6). Parameters after 3 steps: AdamW's
first steps move a weight by about lr whatever the size of its gradient,
so where a gradient is as small as the f32 noise of its sum the two
packages may step it differently. So at most 1e-4 of each parameter's
elements may differ by more than 1e-5 (reading: 2 of 65,536), and none by
more than lr = 1e-3 (reading 2.7e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.models.nlp import LlamaConfig as JConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JLlama
from paddle_tpu.models.nlp import llama_functional as jfun
from paddle_tpu.models.nlp.llama import \
    llama_train_step_factory as jax_train_factory
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_train_step_factory,
                                         load_numpy_state_dict, param_views)
from paddle_tpu_torch.models.nlp import llama_functional as tfun

CFG = dict(vocab=256, hidden=256, layers=2, heads=4, kv_heads=2)
B, S = 2, 256
LR = 1e-3


def _models(seed=0):
    paddle.seed(seed)
    jm = JLlama(JConfig.tiny(**CFG))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_numpy_state_dict(tm, state)
    return jm, tm, state


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab"], (B, S)).astype(np.int32),
            rng.integers(0, CFG["vocab"], (B, S)).astype(np.int32))


def test_forward_logits_match_jax():
    jm, tm, _ = _models()
    tokens, _ = _batch()
    want = np.asarray(jm(Tensor(jnp.asarray(tokens)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    assert got.shape == (B, S, CFG["vocab"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_loss_and_every_grad_match_jax(monkeypatch):
    jm, tm, _ = _models()
    tokens, labels = _batch()
    monkeypatch.setattr(jfun, "_FORCE_FLASH_FOR_TESTS", True)
    cfg = jm.config
    j_outer, j_layers = jfun.split_params(jm)
    j_loss, (j_go, j_gl) = jax.value_and_grad(
        lambda o, l: jfun.loss_fn(cfg, o, l, jnp.asarray(tokens),
                                  jnp.asarray(labels), remat=False),
        argnums=(0, 1))(j_outer, j_layers)

    params = dict(tm.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    outer, layers = param_views(params, CFG["layers"])
    loss = tfun.loss_fn(tm.config, outer, layers, torch.from_numpy(tokens),
                        torch.from_numpy(labels), remat=False)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               atol=1e-5, rtol=0)
    # the JAX layer gradients are stacked (L, ...): one slice per layer
    want = {k: np.asarray(v) for k, v in j_go.items()}
    for k, v in j_gl.items():
        for i in range(CFG["layers"]):
            want[f"model.layers.{i}.{k}"] = np.asarray(v[i])
    assert set(want) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key], atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("remat", [False, True])
def test_three_train_steps_match_jax(remat):
    jm, tm, _ = _models()
    tokens, labels = _batch()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    j_params, j_opt, j_step, _ = jax_train_factory(
        jm, mesh, learning_rate=LR, remat=remat)
    params, opt, step = llama_train_step_factory(
        tm, learning_rate=LR, remat=remat, device="cpu")
    assert params["lm_head.weight"] is tm.lm_head.weight  # no copy held
    for i in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt,
                                         jnp.asarray(tokens),
                                         jnp.asarray(labels))
        params, opt, loss = step(params, opt, tokens, labels)
        np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                                   rtol=0, err_msg=f"step {i}")
    assert int(opt["step"]) == 3
    for k, p in params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(j_params[k]))
        assert (diff > 1e-5).mean() <= 1e-4, k
        assert diff.max() <= LR, k


def test_factory_refuses_unported_options():
    _, tm, _ = _models()
    for kw, match in [(dict(remat="dots"), "remat='dots'"),
                      (dict(offload_moments=True), "offload_moments"),
                      (dict(chunked_vocab_ce=32), "chunked_vocab_ce"),
                      (dict(mesh=object()), "mesh axes")]:
        with pytest.raises(NotImplementedError, match=match):
            llama_train_step_factory(tm, device="cpu", **kw)
    with pytest.raises(ValueError, match="remat"):
        llama_train_step_factory(tm, device="cpu", remat="full")
    windowed = LlamaForCausalLM(dataclasses.replace(
        LlamaConfig.tiny(**CFG), sliding_window=64), device="cpu")
    with pytest.raises(NotImplementedError, match="rows 8-9"):
        llama_train_step_factory(windowed, device="cpu")
    with pytest.raises(NotImplementedError, match="rows 8-9"):
        windowed(torch.zeros((1, 8), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="positions"):
        tm(torch.zeros((1, 8), dtype=torch.long),
           positions=torch.arange(8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(**CFG),
                                             fuse_attention_qkv=True),
                         device="cpu")


def test_mha_at_flash_shapes_takes_the_dense_path_on_the_cpu():
    """kv_heads == heads needs the MHA flash kernels (not ported): the CPU
    takes the dense path, their plain version, and agrees with JAX."""
    cfg = dict(CFG, kv_heads=4)
    paddle.seed(0)
    jm = JLlama(JConfig.tiny(**cfg))
    tm = load_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu"),
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    tokens, _ = _batch()
    want = np.asarray(jm(Tensor(jnp.asarray(tokens)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_example_trains_on_the_cpu():
    from paddle_tpu_torch.examples.train_llama_compiled import train

    res = train(LlamaConfig.tiny(**CFG), B, S, steps=3, device="cpu",
                log=None)
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]   # one repeated batch
