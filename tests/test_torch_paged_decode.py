"""The port's paged decode factory against the JAX package's, on the same
weights (carried across by ``load_numpy_state_dict``) and the same numpy
inputs: one-shot prefill, chunked prefill in gather and kernel modes with
``resume_from``, ``decode_step``, ``decode_n``, fp and int8 pools.

Tolerances (f32 model, LlamaConfig.tiny, 2 layers, 4 heads / 2 kv heads):
logits atol 1e-4 — both sides are f32 throughout, differing only in
summation order (XLA vs ATen matmuls, online vs exact softmax). Greedy
tokens must be identical. fp pools atol 1e-5; int8 pool codes may differ
by one step where a value sits within rounding noise of a .5 boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.nlp import LlamaConfig as JConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JLlama
from paddle_tpu.models.nlp.llama_decode import \
    llama_paged_decode_factory as jax_factory
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_paged_decode_factory,
                                         load_numpy_state_dict)

PS, POOL, W = 8, 16, 4
LOGIT_ATOL = 1e-4
CFG = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2)


def _models(seed=0):
    paddle.seed(seed)
    jm = JLlama(JConfig.tiny(**CFG))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu", seed=seed)
    load_numpy_state_dict(tm, state)
    return jm, tm


def _pools_np(pools):
    """Both packages' pools as a flat list of numpy arrays."""
    flat = jax.tree_util.tree_leaves(pools) if not isinstance(
        jax.tree_util.tree_leaves(pools)[0], torch.Tensor) else None
    if flat is None:
        def walk(p):
            if isinstance(p, torch.Tensor):
                return [p.numpy()]
            return [a for x in p for a in walk(x)]
        return walk(pools)
    return [np.asarray(a) for a in flat]


def _scenario(mode, kv, emit, B=2):
    rng = np.random.default_rng(7)
    lens = np.asarray([21, 13], np.int32)[:B]
    T = 32 if mode == "oneshot" else 32        # two 16-token chunks
    toks = np.zeros((B, T), np.int64)
    for b in range(B):
        toks[b, :lens[b]] = rng.integers(1, 64, lens[b])
    pt = np.stack([np.arange(1 + b * W, 1 + (b + 1) * W)
                   for b in range(B)]).astype(np.int32)
    kw = dict(page_size=PS, n_pool_pages=POOL, kv_cache_dtype=kv, emit=emit)
    if mode != "oneshot":
        kw.update(chunked_prefill=16, prefill_attention=mode)
    return toks, pt, lens, kw


def _tok(out):
    o = np.asarray(out)
    return o if o.ndim == 1 else o.argmax(-1).astype(np.int32)


def _drive(pkg, model, toks, pt, lens, kw, chunked):
    """prefill, 3 x decode_step, decode_n(3); a chunked prefill is then
    re-run with resume_from=16 over the pages it already wrote. Returns
    (list of per-call outputs as numpy, final pools as numpy)."""
    if pkg == "jax":
        outer, layers, pools, prefill, step, dn = jax_factory(model, **kw)
        cv = jnp.asarray
    else:
        outer, layers, pools, prefill, step, dn = \
            llama_paged_decode_factory(model, device="cpu", **kw)
        cv = torch.from_numpy
    outs = []
    out, pools = prefill(outer, layers, cv(toks), cv(pt), cv(lens), pools)
    outs.append(np.asarray(out))
    if chunked:
        again, pools = prefill(outer, layers, cv(toks), cv(pt), cv(lens),
                               pools, resume_from=16)
        outs.append(np.asarray(again))
    tok = _tok(out)
    ln = lens.copy()
    for _ in range(3):
        out, pools = step(outer, layers, cv(tok), cv(pt), cv(ln), pools)
        outs.append(np.asarray(out))
        tok = _tok(out)
        ln = ln + 1
    emits, nxt, pools = dn(outer, layers, cv(tok), cv(pt), cv(ln), pools, 3)
    outs += [np.asarray(emits), np.asarray(nxt)]
    return outs, _pools_np(pools)


@pytest.mark.parametrize("mode", ["oneshot", "gather", "kernel"])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_paged_decode_matches_reference(mode, kv):
    jm, tm = _models()
    toks, pt, lens, kw = _scenario(mode, kv, "logits")
    chunked = mode != "oneshot"
    jouts, jpools = _drive("jax", jm, toks, pt, lens, kw, chunked)
    touts, tpools = _drive("torch", tm, toks, pt, lens, kw, chunked)
    assert len(jouts) == len(touts)
    for i, (a, b) in enumerate(zip(jouts, touts)):
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"output {i}")
        np.testing.assert_array_equal(_tok(b), _tok(a),
                                      err_msg=f"greedy tokens {i}")
    if chunked:
        # resume_from=16 reproduces the full prefill for row 0 (length 21,
        # last position in the re-run chunk); row 1 (length 13) ends in
        # the skipped chunk, so it is not a valid resume for that row
        np.testing.assert_allclose(touts[1][0], touts[0][0], atol=1e-5)
    for a, b in zip(jpools, tpools):
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            assert np.mean(a == b) > 0.99
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["oneshot", "kernel"])
def test_token_emit_streams_identical(mode):
    jm, tm = _models(seed=3)
    toks, pt, lens, kw = _scenario(mode, None, "token")
    jouts, _ = _drive("jax", jm, toks, pt, lens, kw, mode != "oneshot")
    touts, _ = _drive("torch", tm, toks, pt, lens, kw, mode != "oneshot")
    for a, b in zip(jouts, touts):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.int32


def test_kv_quant_int8_is_the_int8_pool():
    """kv_quant="int8" is the serving tier's spelling of the int8 pool:
    the same outputs and pools as kv_cache_dtype="int8", in the port and
    against the reference."""
    jm, tm = _models(seed=4)
    toks, pt, lens, kw = _scenario("kernel", None, "logits")
    kw.pop("kv_cache_dtype")
    jouts, jpools = _drive("jax", jm, toks, pt, lens,
                           {**kw, "kv_quant": "int8"}, True)
    touts, tpools = _drive("torch", tm, toks, pt, lens,
                           {**kw, "kv_quant": "int8"}, True)
    couts, cpools = _drive("torch", tm, toks, pt, lens,
                           {**kw, "kv_cache_dtype": "int8"}, True)
    for a, b, c in zip(jouts, touts, couts):
        np.testing.assert_array_equal(b, c)
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0)
    for b, c in zip(tpools, cpools):
        np.testing.assert_array_equal(b, c)


def test_bridge_carries_weights_bit_exact():
    jm, tm = _models()
    for name, p in tm.named_parameters():
        want = np.asarray(jm.state_dict()[name]._value)
        np.testing.assert_array_equal(p.detach().numpy(), want)


def test_bridge_round_trips_bf16():
    """A bf16 state dict (what np.asarray of JAX bf16 arrays gives) loads
    bit-exactly and reads back to the same bits, untransposed."""
    cfg = LlamaConfig.tiny(**CFG)
    cfg.dtype = torch.bfloat16
    tm = LlamaForCausalLM(cfg, device="cpu")
    rng = np.random.default_rng(5)
    state = {k: np.asarray(jnp.asarray(rng.normal(0, 1, tuple(p.shape)),
                                       jnp.bfloat16))
             for k, p in tm.named_parameters()}
    assert state["lm_head.weight"].dtype == ml_dtypes.bfloat16
    load_numpy_state_dict(tm, state)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        back = p.detach().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(back.view(np.uint16),
                                      state[name].view(np.uint16))


def test_bridge_refuses_wrong_keys_and_shapes():
    _, tm = _models()
    state = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    with pytest.raises(KeyError):
        load_numpy_state_dict(tm, {**state, "extra.weight": np.zeros(1)})
    bad = dict(state)
    bad["lm_head.weight"] = bad["lm_head.weight"].T
    with pytest.raises(ValueError):
        load_numpy_state_dict(tm, bad)


def test_state_dict_keys_match_reference():
    jm, tm = _models()
    assert list(tm.state_dict()) == list(jm.state_dict())
    for k, v in jm.state_dict().items():
        assert tuple(tm.state_dict()[k].shape) == tuple(v.shape), k


def test_factory_refuses_unported_options():
    _, tm = _models()
    with pytest.raises(TypeError):
        llama_paged_decode_factory(tm, tp=2, device="cpu")
    # a model with fused projection weights: the decode programs read the
    # unfused keys, as the reference's do (explicit positions, refused
    # here before, are ported: tests/test_torch_train_options.py)
    fused = LlamaForCausalLM(dataclasses.replace(tm.config,
                                                 fuse_attention_qkv=True),
                             device="cpu")
    with pytest.raises(ValueError, match="fuse_attention_qkv"):
        llama_paged_decode_factory(fused, device="cpu")
