"""The Llama and MoE ``Layer``s of the PyTorch port against the JAX
package's, on the same weights (carried by ``load_numpy_state_dict``) and
the same numpy tokens, float32 on both sides:

* the state-dict keys, in the reference's order, equal to
  ``llama_functional.layer_keys`` under ``model.layers.{i}.`` with the
  reference's outer keys, fused projections included;
* the logits of ``LlamaForCausalLM`` (unfused, fused, tied, with explicit
  positions) and the outputs of ``LlamaAttention``, ``LlamaMLP``,
  ``LlamaDecoderLayer`` and ``LlamaModel`` built alone; the layers'
  forward is ``llama_functional.forward`` bit for bit (one copy of the
  arithmetic, so the kernels stay on the path);
* the open fault, closed: every parameter requires grad and
  ``model(ids).mean().backward()`` runs; one eager AdamW step (the
  everyday ``loss.backward(); opt.step(); opt.clear_grad()``) of the tiny
  Llama and the tiny MoE model moves 21 of 21 and 20 of 20 tensors, each
  within 1e-5 of the reference's step (the reference's gradients by
  ``jax.value_and_grad`` of its loss, jitted once, then its own AdamW);
* ``generate``'s greedy tokens equal the reference's; ``set_state_dict``
  round-trips the logits bit for bit; the MoE logits.

Tolerance: logits and outputs 1e-5 absolute and relative (readings below
2e-6); the parameters after one AdamW step 1e-5 absolute (AdamW's first
step moves each element by about lr = 1e-3 whatever its gradient's size;
reading 8.4e-6, where a gradient is as small as the f32 noise of its
sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.nlp import LlamaConfig as JConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JLlama
from paddle_tpu.models.nlp import llama as jllama
from paddle_tpu.models.nlp.moe import MoEConfig as JMoEConfig
from paddle_tpu.models.nlp.moe import MoEForCausalLM as JMoE
import paddle_tpu_torch as tp
from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.nlp import llama as tllama
from paddle_tpu_torch.models.nlp import llama_functional as tfun
from paddle_tpu_torch.models.nlp.moe import MoEConfig, MoEForCausalLM
from paddle_tpu_torch.nn import load_numpy_state_dict

TOL = dict(atol=1e-5, rtol=1e-5)
LR = 1e-3
B, S, V = 2, 8, 256


def _state(ref):
    return {k: np.asarray(v._value) for k, v in ref.state_dict().items()}


def _llama(**over):
    paddle.seed(0)
    jcfg = dataclasses.replace(JConfig.tiny(), **over)
    ref = JLlama(jcfg)
    state = _state(ref)
    port = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(), **over),
                            device="cpu")
    assert list(port.state_dict()) == list(state)
    return ref, load_numpy_state_dict(port, state), state


def _tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(
        np.int32)


def _ref_call(ref, *args):
    """The reference layer's forward, jitted once (one compile, not one
    per eager op)."""
    fn = jax.jit(lambda *a: ref(*[paddle.Tensor(x) if x.dtype != jnp.int32
                                  or i == 0 else x
                                  for i, x in enumerate(a)])._value)
    return np.asarray(fn(*[jnp.asarray(a) for a in args]))


def _ref_logits(ref, ids, positions=None):
    if positions is None:
        return _ref_call(ref, ids)
    return _ref_call(ref, ids, positions)


@pytest.mark.parametrize("variant", ["plain", "fused", "tied", "positions"])
def test_logits_and_keys_match_jax(variant):
    over = {"plain": {}, "positions": {},
            "fused": dict(fuse_attention_qkv=True, fuse_ffn_gate_up=True),
            "tied": dict(tie_word_embeddings=True)}[variant]
    ref, port, state = _llama(**over)
    cfg = port.config
    outer = ["model.embed_tokens.weight", "model.norm.weight"] + (
        [] if cfg.tie_word_embeddings else ["lm_head.weight"])
    keys = [f"model.layers.{i}.{k}" for i in range(cfg.num_hidden_layers)
            for k in tfun.layer_keys(cfg)]
    assert sorted(state) == sorted(outer + keys)
    ids = _tokens()
    positions = (np.arange(S)[None] + np.array([[3], [0]])).astype(np.int32) \
        if variant == "positions" else None
    want = _ref_logits(ref, ids, positions)
    got = port(torch.from_numpy(ids),
               None if positions is None else torch.from_numpy(positions))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # the layers run llama_functional's arithmetic, bit for bit
    outer_p, layers_p = tfun.param_views(dict(port.named_parameters()),
                                         cfg.num_hidden_layers)
    func = tfun.forward(cfg, outer_p, layers_p, torch.from_numpy(ids).long(),
                        remat=False, positions=None if positions is None
                        else torch.from_numpy(positions).long())
    assert torch.equal(func, got)


def test_each_layer_built_alone_matches_jax():
    paddle.seed(2)
    jcfg, cfg = JConfig.tiny(), LlamaConfig.tiny()
    x = np.random.default_rng(3).standard_normal((B, S, 64)).astype(
        np.float32)
    ids = _tokens()
    for name, arg in (("LlamaAttention", x), ("LlamaMLP", x),
                      ("LlamaDecoderLayer", x), ("LlamaModel", ids)):
        ref = getattr(jllama, name)(jcfg)
        port = getattr(tllama, name)(cfg, device="cpu")
        assert isinstance(port, tp.nn.Layer)
        state = _state(ref)
        assert list(port.state_dict()) == list(state), name
        load_numpy_state_dict(port, state)
        want = _ref_call(ref, arg)
        got = port(torch.from_numpy(arg))
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL,
                                   err_msg=name)
        assert all(p.requires_grad for p in port.parameters())


def test_backward_reaches_every_parameter():
    """The open fault: ``model(ids).mean().backward()`` raised, since no
    parameter required grad."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    params = model.parameters()
    assert len(params) == 21 and all(p.requires_grad for p in params)
    model(torch.from_numpy(_tokens())).mean().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in params)


def _ref_step(ref, loss_of, ids, labels):
    """One AdamW step of the reference: gradients by ``jax.value_and_grad``
    of ``loss_of(model, ids, labels)`` (jitted once), then its optimizer."""
    params = dict(ref.named_parameters())

    @jax.jit
    @jax.value_and_grad
    def loss(values, ids, labels):
        saved = {k: p._value for k, p in params.items()}
        for k, v in values.items():
            params[k]._value = v
        try:
            with paddle.no_grad():
                return loss_of(ref, paddle.Tensor(ids),
                               paddle.Tensor(labels))._value
        finally:
            for k, v in saved.items():
                params[k]._value = v

    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=list(params.values()))
    value, grads = loss({k: p._value for k, p in params.items()},
                        jnp.asarray(ids), jnp.asarray(labels))
    for k, g in grads.items():
        params[k]._grad = paddle.Tensor(g)
    opt.step()
    opt.clear_grad()
    return float(value)


def _port_step(port, loss_of, ids, labels):
    opt = tp.optimizer.AdamW(learning_rate=LR, parameters=port.parameters())
    loss = loss_of(port, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def _ce(pkg):
    F = (paddle if pkg == "ref" else tp).nn.functional

    def loss_of(model, ids, labels):
        logits = model(ids)
        if pkg == "ref":
            return F.cross_entropy(logits.reshape([-1, V]),
                                   labels.reshape([-1]))
        return F.cross_entropy(logits.reshape(-1, V),
                               labels.reshape(-1).long())
    return loss_of


def _moe_loss(pkg):
    ce = _ce(pkg)
    return lambda model, ids, labels: ce(model, ids, labels) \
        + model.aux_loss()


@pytest.mark.parametrize("kind", ["llama", "moe"])
def test_one_eager_adamw_step_moves_every_tensor_as_the_reference(kind):
    if kind == "llama":
        ref, port, state = _llama()
        ref_loss, port_loss, n = _ce("ref"), _ce("port"), 21
    else:
        paddle.seed(0)
        ref = JMoE(JMoEConfig.tiny())
        state = _state(ref)
        port = load_numpy_state_dict(
            MoEForCausalLM(MoEConfig.tiny(), device="cpu"), state)
        assert list(port.state_dict()) == list(state)
        ref_loss, port_loss, n = _moe_loss("ref"), _moe_loss("port"), 20
    ids, labels = _tokens(4), _tokens(5)
    want = _ref_step(ref, ref_loss, ids, labels)
    got = _port_step(port, port_loss, ids, labels)
    assert abs(got - want) <= 1e-5
    after = _state(ref)
    moved = 0
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), after[k], atol=1e-5, rtol=0,
                                   err_msg=k)
        moved += not np.array_equal(v.numpy(), state[k])
    assert moved == n == len(state)


def test_generate_matches_jax(monkeypatch):
    ref, port, _ = _llama()
    # the reference's own greedy loop, its forward jitted (one compile a
    # length, not one per eager op)
    fwd = jax.jit(lambda v: type(ref).forward(ref, paddle.Tensor(v))._value)
    monkeypatch.setattr(ref, "forward", lambda ids, positions=None:
                        paddle.Tensor(fwd(ids._value)))
    ids = _tokens(6, (2, 5))
    want = np.asarray(ref.generate(paddle.to_tensor(ids), 3)._value)
    got = port.generate(torch.from_numpy(ids), 3)
    assert got.shape == (2, 8) and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)


def test_set_state_dict_round_trip_is_bit_exact():
    _, port, _ = _llama()
    ids = torch.from_numpy(_tokens())
    with torch.no_grad():
        before = port(ids)
        sd = {k: v.clone() for k, v in port.state_dict().items()}
        for p in port.parameters():
            p.add_(1.0)
        assert port.set_state_dict(sd) == ([], [])
        assert torch.equal(port(ids), before)


def test_moe_logits_match_jax():
    paddle.seed(0)
    ref = JMoE(JMoEConfig.deepseek_tiny())
    state = _state(ref)
    port = load_numpy_state_dict(
        MoEForCausalLM(MoEConfig.deepseek_tiny(), device="cpu"), state)
    ref.eval()
    port.eval()
    ids = _tokens(7)
    want = _ref_call(ref, ids)
    got = port(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert all(isinstance(m, tp.nn.Layer) for m in port.sublayers())


def test_llama_model_is_exported_as_in_the_reference():
    """``models.nlp`` exports ``LlamaModel``, as the reference's does."""
    import paddle_tpu.models.nlp as ref_nlp
    import paddle_tpu_torch.models.nlp as port_nlp
    assert ref_nlp.LlamaModel.__name__ == port_nlp.LlamaModel.__name__
    assert port_nlp.LlamaModel is tllama.LlamaModel
