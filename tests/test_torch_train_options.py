"""The Llama training step's options in the port against the JAX package:
``remat="dots"``, ``offload_moments``, ``chunked_vocab_ce``, explicit
``positions`` and fused projection weights (``fuse_attention_qkv``,
``fuse_ffn_gate_up``).

The config is ``test_torch_train_step.py``'s: f32, hidden 256, 4 heads /
2 kv heads (head_dim 64), 2 layers, vocab 256, B=2, S=256 (the flash
path: the Pallas GQA kernel in interpret mode on the JAX side, the plain
version in the port), with the same weights (carried by
``load_numpy_state_dict``, fused keys included) and the same numpy batch.

* 3 steps of ``llama_train_step_factory`` in both packages (a one-device
  CPU mesh on the JAX side) under each option alone, and under the long
  context example's set (tied, fused, "dots", chunked): losses, then every
  parameter, by ``test_torch_train_step.py``'s AdamW rule;
* logits with explicit positions, (S,) and (B, S), against the JAX
  model's; positions move the rotary only;
* fused against unfused on concatenated weights, as
  ``tests/test_llama_fused_proj.py`` does for the JAX package;
* offloaded moments against moments on the device: bit-equal on the CPU,
  where the staging loop runs too (chunks of 4, two slots);
* the three remat modes give the same bits, "dots" saves the projections'
  products and recomputes the attention forward (twice a layer a step);
* the refusals: untied weights with ``chunked_vocab_ce``, a fused model
  given to the decode factory, positions of a wrong shape.

Tolerances (f32 on both sides, apart by the order of sums only): losses of
3 steps atol 1e-5 (reading 3.8e-6); parameters after 3 steps by the AdamW
rule of ``test_torch_train_step.py``: at most 1e-4 of each parameter's
elements beyond 1e-5 (reading 6.1e-5, layer 0's k_proj under chunked CE,
4 of 65,536) and none beyond lr = 1e-3 (reading 3.8e-4); logits atol 1e-4
(readings 6.0e-6 with positions, 4.1e-6 fused); fused against unfused on
concatenated weights atol 1e-5 (reading 0: the same bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.nlp import LlamaConfig as JConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JLlama
from paddle_tpu.models.nlp.llama import \
    llama_train_step_factory as jax_train_factory
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_paged_decode_factory,
                                         llama_train_step_factory,
                                         load_numpy_state_dict, param_views)
from paddle_tpu_torch.models.nlp import llama_functional as tfun
from paddle_tpu_torch.models.nlp import train_utils
import paddle_tpu_torch.ops.flash_attention_gqa as fa

CFG = dict(vocab=256, hidden=256, layers=2, heads=4, kv_heads=2)
B, S = 2, 256
LR = 1e-3
TIED = dict(tie_word_embeddings=True)
FUSED = dict(fuse_attention_qkv=True, fuse_ffn_gate_up=True)
# 256 = 5 x 48 + 16: the last chunk is padded
CHUNK = 48
# option set -> (config fields, factory keywords)
OPTIONS = {
    "dots": ({}, dict(remat="dots")),
    "chunked": (TIED, dict(remat=False, chunked_vocab_ce=CHUNK)),
    "offload": ({}, dict(remat=False, offload_moments=True)),
    "fused": (FUSED, dict(remat=False)),
    "long_context": ({**TIED, **FUSED},
                     dict(remat="dots", chunked_vocab_ce=CHUNK)),
}


def _models(fields=None, seed=0):
    fields = fields or {}
    paddle.seed(seed)
    jm = JLlama(dataclasses.replace(JConfig.tiny(**CFG), **fields))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(**CFG),
                                              **fields), device="cpu")
    load_numpy_state_dict(tm, state)
    return jm, tm, state


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab"], (B, S)).astype(np.int32),
            rng.integers(0, CFG["vocab"], (B, S)).astype(np.int32))


def _assert_params_close(params, j_params):
    """test_torch_train_step.py's AdamW rule."""
    assert set(params) == set(j_params)
    for k, p in params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(j_params[k]))
        assert (diff > 1e-5).mean() <= 1e-4, k
        assert diff.max() <= LR, k


@pytest.mark.parametrize("name", list(OPTIONS))
def test_three_train_steps_match_jax(name):
    fields, kw = OPTIONS[name]
    jm, tm, _ = _models(fields)
    tokens, labels = _batch()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    j_params, j_opt, j_step, _ = jax_train_factory(
        jm, mesh, learning_rate=LR, **kw)
    params, opt, step = llama_train_step_factory(
        tm, learning_rate=LR, device="cpu", **kw)
    for i in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt,
                                         jnp.asarray(tokens),
                                         jnp.asarray(labels))
        params, opt, loss = step(params, opt, tokens, labels)
        np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                                   rtol=0, err_msg=f"step {i}")
    _assert_params_close(params, j_params)


def _positions(kind):
    rng = np.random.default_rng(5)
    if kind == "S":                 # an offset start, as after a prefix
        return (np.arange(S) + 1000).astype(np.int32)
    return np.sort(rng.integers(0, 4 * S, (B, S)), -1).astype(np.int32)


@pytest.mark.parametrize("kind", ["S", "BS"])
def test_positions_match_jax(kind):
    jm, tm, _ = _models()
    tokens, _ = _batch()
    pos = _positions(kind)
    want = np.asarray(jm(Tensor(jnp.asarray(tokens)),
                         jnp.asarray(pos))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_positions_move_the_rotary_only():
    _, tm, _ = _models()
    tokens = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        default = tm(tokens)
        counted = tm(tokens, torch.arange(S))
        per_row = tm(tokens, torch.arange(S).expand(B, S))
        shifted = tm(tokens, torch.arange(S) + 7)
        spread = tm(tokens, 2 * torch.arange(S))
    assert torch.equal(default, counted) and torch.equal(default, per_row)
    # the rotary sees distances only: a shift moves nothing but roundings,
    # spreading the positions moves the logits
    assert (default - shifted).abs().max() < 1e-4
    assert (default - spread).abs().max() > 1e-3
    for bad in (torch.arange(S - 1), torch.zeros((3, S), dtype=torch.long),
                torch.zeros((B, S, 1), dtype=torch.long)):
        with pytest.raises(ValueError, match="positions"):
            tm(tokens, bad)


def _fused_from(unfused):
    """The unfused state dict with each layer's q/k/v and gate/up weights
    concatenated into qkv_proj and gate_up_proj (the reference's order)."""
    sd = {k: v.numpy() for k, v in unfused.state_dict().items()}
    folded = ("self_attn.k_proj.weight", "self_attn.v_proj.weight",
              "mlp.up_proj.weight")
    out = {}
    for k, v in sd.items():
        if k.endswith("self_attn.q_proj.weight"):
            base = k[:-len("q_proj.weight")]
            out[base + "qkv_proj.weight"] = np.concatenate(
                [v, sd[base + "k_proj.weight"], sd[base + "v_proj.weight"]],
                axis=1)
        elif k.endswith("mlp.gate_proj.weight"):
            base = k[:-len("gate_proj.weight")]
            out[base + "gate_up_proj.weight"] = np.concatenate(
                [v, sd[base + "up_proj.weight"]], axis=1)
        elif not k.endswith(folded):
            out[k] = v
    return out


def test_fused_matches_unfused_on_concatenated_weights():
    _, unfused, _ = _models()
    fused = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(**CFG),
                                                 **FUSED), device="cpu")
    load_numpy_state_dict(fused, _fused_from(unfused))
    assert "model.layers.0.self_attn.qkv_proj.weight" in \
        dict(fused.named_parameters())
    tokens = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        np.testing.assert_allclose(fused(tokens).numpy(),
                                   unfused(tokens).numpy(), atol=1e-5,
                                   rtol=0)


def test_fused_forward_matches_jax():
    jm, tm, state = _models(FUSED)
    assert tfun.layer_keys(tm.config) == [
        "input_layernorm.weight", "self_attn.qkv_proj.weight",
        "self_attn.o_proj.weight", "post_attention_layernorm.weight",
        "mlp.gate_up_proj.weight", "mlp.down_proj.weight"]
    assert state["model.layers.0.self_attn.qkv_proj.weight"].shape == \
        (256, 256 + 2 * 128)
    tokens, _ = _batch()
    want = np.asarray(jm(Tensor(jnp.asarray(tokens)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _train(offload, fields=None, steps=3):
    _, tm, _ = _models(fields)
    tokens, labels = _batch()
    params, opt, step = llama_train_step_factory(
        tm, learning_rate=LR, remat=False, offload_moments=offload,
        device="cpu")
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    return params, opt, losses


def test_offloaded_moments_are_bit_equal_to_device_moments():
    params, opt, losses = _train(offload=False)
    o_params, o_opt, o_losses = _train(offload=True)
    assert losses == o_losses
    for k in params:
        assert torch.equal(params[k], o_params[k]), k
        assert torch.equal(opt["m"][k], o_opt["m"][k]), k
        assert torch.equal(opt["v"][k], o_opt["v"][k]), k
    # one host block per moment, the views in the parameters' order
    for name in ("m", "v"):
        ptrs = {t.untyped_storage().data_ptr()
                for t in o_opt[name].values()}
        assert len(ptrs) == 1
    assert int(o_opt["step"]) == 3


def test_offloaded_update_streams_chunks_of_four():
    """The update visits the tensors in chunks of ``OFFLOAD_CHUNK`` (4, the
    reference's ``chunk_n``) in the parameters' order, each chunk's
    moments staged in one of two slots, not in the host block: chunk c
    in slot c % 2, each tensor's m at its offset in the slot's first row
    and its v at the same offset in the second. The new moments reach
    the host block."""
    _, tm, _ = _models()
    params = dict(tm.named_parameters())
    keys = list(params)
    seen = []
    real = train_utils._update_one

    def spy(params_, grads, i, k, m, v, *rest):
        seen.append((k, m.untyped_storage().data_ptr(), m.storage_offset(),
                     v.untyped_storage().data_ptr(), v.storage_offset()))
        return real(params_, grads, i, k, m, v, *rest)

    grads = [torch.ones_like(p) for p in params.values()]
    grads[1] = None                 # a parameter the loss does not reach
    opt = train_utils.make_adamw_state(params, offload=True)
    host = {opt[n][keys[0]].untyped_storage().data_ptr() for n in "mv"}
    train_utils._update_one = spy
    try:
        train_utils.apply_adamw(params, grads, opt, LR, 0.9, 0.95, 1e-8,
                                0.01, offload=True)
    finally:
        train_utils._update_one = real
    assert train_utils.OFFLOAD_CHUNK == 4
    assert [s[0] for s in seen] == [k for i, k in enumerate(keys) if i != 1]
    assert all(g is None for g in grads)

    chunks = [keys[j:j + 4] for j in range(0, len(keys), 4)]
    assert len(chunks) >= 3         # both slots taken, and one recycled
    slot_numel = max(sum(params[k].numel() for k in c) for c in chunks)
    want, slot_of = {}, {}
    for ci, chunk in enumerate(chunks):
        off = 0
        for k in chunk:
            want[k] = (off, slot_numel + off)
            slot_of[k] = ci % 2
            off += params[k].numel()
    slot_ptr = {}
    for k, m_ptr, m_off, v_ptr, v_off in seen:
        assert m_ptr == v_ptr and m_ptr not in host
        assert slot_ptr.setdefault(slot_of[k], m_ptr) == m_ptr
        assert (m_off, v_off) == want[k]
    assert len(set(slot_ptr.values())) == 2
    for i, k in enumerate(keys):
        assert bool((opt["m"][k] != 0).any()) == (i != 1)
        assert bool((opt["v"][k] != 0).any()) == (i != 1)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in tfun.SAVED_BY_DOTS:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fields", [{}, FUSED], ids=["unfused", "fused"])
def test_remat_modes_give_the_same_bits(fields, monkeypatch):
    """remat False / True / "dots": the same loss and gradients, bit for
    bit. The attention forward runs once a layer without remat and twice
    with True or "dots"; "dots" recomputes no projection (its products
    are saved); True recomputes every projection but a layer's last, the
    down projection, whose output no backward needs (the checkpoint stops
    its recomputation at the last saved tensor)."""
    _, tm, _ = _models(fields)
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    params = dict(tm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    fwd_calls = []
    real_fwd = fa.gqa_fwd
    monkeypatch.setattr(fa, "gqa_fwd",
                        lambda *a, **k: fwd_calls.append(1) or
                        real_fwd(*a, **k))
    out = {}
    for remat in (False, True, "dots"):
        fwd_calls.clear()
        outer, layers = param_views(params, CFG["layers"])
        with _CountOps() as ops:
            loss = tfun.loss_fn(tm.config, outer, layers, tokens, labels,
                                remat)
            grads = torch.autograd.grad(loss, list(params.values()))
        out[remat] = (loss.detach(), grads, len(fwd_calls), ops.mm)
    L = CFG["layers"]
    per_layer = len([k for k in tfun.layer_keys(tm.config)
                     if k.endswith("proj.weight")])
    assert [out[r][2] for r in (False, True, "dots")] == [L, 2 * L, 2 * L]
    assert out["dots"][3] == out[False][3]
    assert out[True][3] == out[False][3] + L * (per_layer - 1)
    for remat in (True, "dots"):
        assert torch.equal(out[remat][0], out[False][0])
        for a, b in zip(out[remat][1], out[False][1]):
            assert torch.equal(a, b)


def test_chunked_ce_refuses_untied_weights():
    _, tm, _ = _models()
    assert tm.lm_head is not None
    with pytest.raises(ValueError, match="tied word embeddings"):
        llama_train_step_factory(tm, device="cpu", chunked_vocab_ce=CHUNK)
    params = dict(tm.named_parameters())
    outer, layers = param_views(params, CFG["layers"])
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(ValueError, match="tied word embeddings"):
        tfun.loss_fn(tm.config, outer, layers, tokens, labels, False,
                     chunked_vocab_ce=CHUNK)


@pytest.mark.parametrize("option", ["fuse_attention_qkv",
                                    "fuse_ffn_gate_up"])
def test_decode_factory_refuses_a_fused_model(option):
    tm = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(**CFG),
                                              **{option: True}),
                          device="cpu")
    with pytest.raises(ValueError, match=option):
        llama_paged_decode_factory(tm, page_size=16, n_pool_pages=9,
                                   device="cpu")


def test_long_context_example_trains_on_the_cpu():
    from paddle_tpu_torch.examples.train_llama_long_context import main

    losses = main(["--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_update_slices_only_tensors_above_one_slice(monkeypatch):
    """A tensor within ``UPDATE_SLICE`` elements goes to ``adamw_update``
    whole, in its own shape; a larger one flat, in slices of
    ``UPDATE_SLICE`` and the rest."""
    seen = []
    plain = train_utils.adamw_update

    def update(p, *args):
        seen.append(tuple(p.shape))
        return plain(p, *args)

    monkeypatch.setattr(train_utils, "adamw_update", update)
    monkeypatch.setattr(train_utils, "UPDATE_SLICE", 100)
    params = {"small": torch.ones(10, 10), "large": torch.ones(3, 70)}
    opt = train_utils.make_adamw_state(params)
    train_utils.apply_adamw(params, [torch.ones(10, 10), torch.ones(3, 70)],
                            opt, LR, 0.9, 0.95, 1e-8, 0.01)
    assert seen == [(10, 10), (100,), (100,), (10,)]


def test_sliced_update_gives_the_same_bits(monkeypatch):
    """The update runs ``UPDATE_SLICE`` elements at a time: being
    elementwise, any slicing gives the bits of the whole-tensor update,
    parameters and both moments, with moments on the device and
    offloaded."""
    _, tm, _ = _models()
    base = {k: p.detach().clone() for k, p in tm.named_parameters()}
    g = torch.Generator().manual_seed(4)
    grads = {k: torch.randn(p.shape, generator=g) for k, p in base.items()}
    runs = []
    for slice_, offload in ((1 << 26, False), (4096, False), (1000, True)):
        monkeypatch.setattr(train_utils, "UPDATE_SLICE", slice_)
        params = {k: p.clone() for k, p in base.items()}
        opt = train_utils.make_adamw_state(params, offload=offload)
        for _ in range(2):
            train_utils.apply_adamw(params, list(grads.values()), opt, LR,
                                    0.9, 0.95, 1e-8, 0.01, offload=offload)
        runs.append((params, opt))
    (p0, o0), *rest = runs
    assert max(p.numel() for p in p0.values()) > 4096
    for params, opt in rest:
        for k in p0:
            assert torch.equal(params[k], p0[k]), k
            assert torch.equal(opt["m"][k], o0["m"][k]), k
            assert torch.equal(opt["v"][k], o0["v"][k]), k
