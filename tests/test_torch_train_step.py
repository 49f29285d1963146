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
* the same three checks (forward logits, loss and every gradient against
  the JAX train step's own loss, 3 steps) on a windowed GQA config
  (``sliding_window`` 64 < S: grouped splash), a multi-head config
  (kv_heads == heads: multi-head flash) and a windowed multi-head one
  (splash at G = 1), each a variant of the config above;
* the refusal of the option the port has not ported (``mesh``).

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
    """Only ``mesh`` is still refused; ``remat`` outside False / True /
    "dots" and a window below 1 are errors. The options ported since
    (remat="dots", offload_moments, chunked_vocab_ce, positions, fused
    projections) are held against the JAX package in
    tests/test_torch_train_options.py."""
    _, tm, _ = _models()
    with pytest.raises(NotImplementedError, match="mesh axes"):
        llama_train_step_factory(tm, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="remat"):
        llama_train_step_factory(tm, device="cpu", remat="full")
    with pytest.raises(ValueError, match="sliding_window"):
        LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(**CFG),
                                             sliding_window=0), device="cpu")


# the windowed and multi-head configs: (kv_heads, sliding_window). At
# S=256 a window of 64 takes the splash path (G = 2 grouped, and G = 1),
# kv_heads == heads the multi-head flash path, in both packages.
CONFIGS = {"window": (2, 64), "mha": (4, None), "window_mha": (4, 64)}
# parameters after 3 steps, by the AdamW rule of the module docstring:
# readings 3, 3 and 7 of 65,536 elements beyond 1e-5 (window, mha,
# window_mha; the last in layer 1's k_proj, whose gradients are the
# smallest), none beyond lr (reading 4.3e-4); the share allowed is about
# twice the largest reading
CONFIG_PARAM_FRAC = 2e-4


def _config_models(name, seed=0):
    kv, window = CONFIGS[name]
    paddle.seed(seed)
    jm = JLlama(dataclasses.replace(JConfig.tiny(**dict(CFG, kv_heads=kv)),
                                    sliding_window=window))
    tm = LlamaForCausalLM(dataclasses.replace(
        LlamaConfig.tiny(**dict(CFG, kv_heads=kv)), sliding_window=window),
        device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v._value)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _jax_loss_and_grads(jm, tokens, labels):
    """The loss of the JAX train step (``llama.py:561-626``): the JAX
    model's own forward over a parameter tree, whose attention honours
    ``sliding_window``, and its dense log-softmax CE on the CPU."""
    from paddle_tpu.autograd import no_grad

    def loss(params):
        saved = jm.tree_flatten_params()
        jm.load_tree(params)
        try:
            with no_grad():
                logits = jm(Tensor(jnp.asarray(tokens)))._value
        finally:
            jm.load_tree(saved)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return jnp.mean(-jnp.take_along_axis(
            logp, jnp.asarray(labels)[..., None], -1)[..., 0])

    params = {k: v._value for k, v in jm.state_dict().items()}
    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_forward_logits_match_jax(name):
    """The port's forward (splash or multi-head flash, plain on the CPU)
    against the JAX model's (the Pallas kernels in interpret mode);
    tolerance as for the GQA config above."""
    jm, tm = _config_models(name)
    tokens, _ = _batch()
    want = np.asarray(jm(Tensor(jnp.asarray(tokens)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_loss_and_every_grad_match_jax(name):
    jm, tm = _config_models(name)
    tokens, labels = _batch()
    j_loss, j_grads = _jax_loss_and_grads(jm, tokens, labels)
    params = dict(tm.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    outer, layers = param_views(params, CFG["layers"])
    loss = tfun.loss_fn(tm.config, outer, layers, torch.from_numpy(tokens),
                        torch.from_numpy(labels), remat=False)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               atol=1e-5, rtol=0)
    assert set(j_grads) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_three_train_steps_match_jax(name):
    jm, tm = _config_models(name)
    tokens, labels = _batch()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    j_params, j_opt, j_step, _ = jax_train_factory(
        jm, mesh, learning_rate=LR, remat=False)
    params, opt, step = llama_train_step_factory(
        tm, learning_rate=LR, remat=False, device="cpu")
    for i in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt,
                                         jnp.asarray(tokens),
                                         jnp.asarray(labels))
        params, opt, loss = step(params, opt, tokens, labels)
        np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                                   rtol=0, err_msg=f"step {i}")
    for k, p in params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(j_params[k]))
        assert (diff > 1e-5).mean() <= CONFIG_PARAM_FRAC, k
        assert diff.max() <= LR, k


def test_window_at_an_ineligible_length_takes_the_dense_band():
    """S = 128 is not flash-eligible: both packages take the dense path with
    the window band (``llama.py:141-153``)."""
    jm, tm = _config_models("window")
    tokens = _batch()[0][:, :128]
    want = np.asarray(jm(Tensor(jnp.asarray(tokens)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    full = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_numpy_state_dict(full, {k: v.numpy()
                                 for k, v in tm.state_dict().items()})
    with torch.no_grad():
        unbanded = full(torch.from_numpy(tokens)).numpy()
    assert np.abs(unbanded - got).max() > 1e-3     # the band matters here


def test_example_trains_on_the_cpu():
    from paddle_tpu_torch.examples.train_llama_compiled import train

    res = train(LlamaConfig.tiny(**CFG), B, S, steps=3, device="cpu",
                log=None)
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]   # one repeated batch
