"""The dense decode options of the port (int8 weights, the rolling cache
of a sliding window, the speculative decode factory) against the JAX
package's, on the CPU.

* ``quantize_stacked`` and ``int8_matmul`` give the reference's bits (the
  int32 sums are exact and every rounding is the reference's).
* ``llama_decode_factory(weight_dtype="int8")``, alone and with
  ``kv_cache_dtype="int8"``, on untied and tied tiny f32 Llamas: greedy
  tokens equal the reference's, prefill and decode-step logits within
  ``LOGIT_TOL``; the weights it holds are int8 with f32 scales.
* The rolling cache (window 8; a 12-token prompt, whose prefill rolls,
  and a 5-token one with the int8 cache): tokens equal, logits within
  ``LOGIT_TOL``, and generation runs past ``max_len``.
* ``llama_speculative_decode_factory`` with a small draft and with the
  target as its own draft: ``generate`` equals the reference's output
  and ``last_stats`` and the target's plain greedy tokens;
  ``generate.compiled`` equals ``generate``, and the reference's
  compiled output and stats with the small draft.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.nlp import LlamaConfig as JaxConfig
from paddle_tpu.models.nlp import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.nlp.llama_decode import (
    llama_decode_factory as jax_dense_factory,
    llama_speculative_decode_factory as jax_spec_factory)
from paddle_tpu.quantization.int8 import int8_matmul as jax_int8_matmul
from paddle_tpu.quantization.int8 import quantize_stacked_jnp
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_decode_factory,
                                         llama_speculative_decode_factory,
                                         load_numpy_state_dict)
from paddle_tpu_torch.quantization import int8_matmul, quantize_stacked

# f32 logits, port against reference: the same terms, summed in another
# order (the port's dense steps attend the live slots only)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(seed, window=None, tie=False, **tiny):
    """A JAX tiny Llama seeded with ``seed`` and the port's on its
    weights."""
    paddle.seed(seed)
    jcfg = JaxConfig.tiny(**tiny)
    jcfg.sliding_window = window
    jcfg.tie_word_embeddings = tie
    jm = JaxLlama(jcfg)
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = dataclasses.replace(LlamaConfig.tiny(**tiny), sliding_window=window,
                              tie_word_embeddings=tie)
    return jm, load_numpy_state_dict(LlamaForCausalLM(cfg, device="cpu"),
                                     state)


# --- the int8 codec and product -------------------------------------------

@pytest.mark.parametrize("shape", [(2, 32, 24), (48, 40), (1, 9, 7)])
def test_quantize_stacked_is_bit_equal(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0                       # an all-zero output channel
    q, s = quantize_stacked(torch.from_numpy(w))
    rq, rs = quantize_stacked_jnp(w)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.numpy().tobytes() == np.asarray(rq).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()


@pytest.mark.parametrize("rows,act_scale", [(8, None), (17, None),
                                            (32, None), (5, 0.05)])
def test_int8_matmul_is_bit_equal(rows, act_scale):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    q, s = quantize_stacked(torch.from_numpy(w))
    got = int8_matmul(torch.from_numpy(x)[None], q, s, act_scale)
    want = jax_int8_matmul(jnp.asarray(x)[None], jnp.asarray(q.numpy()),
                           jnp.asarray(s.numpy()), act_scale)
    assert got.shape == (1, rows, 24)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


# --- the dense factory's options -------------------------------------------

def _hold(jm, tm, prompts, new, **kw):
    """``generate`` and ``generate.compiled`` of both factories: greedy
    tokens equal; prefill and one decode step's logits within
    LOGIT_TOL. Returns the port's factory."""
    ref = jax_dense_factory(jm, **kw)
    gen = llama_decode_factory(tm, device="cpu", **kw)
    want = np.asarray(ref(prompts, new))
    assert (gen(prompts, new).numpy() == want).all()
    assert (gen.compiled(prompts, new)
            == np.asarray(ref.compiled(prompts, new))).all()
    jp, tp = ref._parts, gen._parts
    assert tp["rolling"] == jp["rolling"]
    B, S0 = prompts.shape
    if jp["rolling"]:
        jl, jk, jv = jp["prefill"](jp["outer"], jp["layers"], prompts)
        tl, tk, tv = tp["prefill"](tp["outer"], tp["layers"], prompts)
    else:
        dt = tp["outer"]["model.embed_tokens.weight"].dtype
        jd = jm.config.dtype
        jl, jk, jv = jp["prefill"](jp["outer"], jp["layers"], prompts,
                                   jp["init_caches"](B, jd),
                                   jp["init_caches"](B, jd))
        tl, tk, tv = tp["prefill"](tp["outer"], tp["layers"], prompts,
                                   tp["init_caches"](B, dt),
                                   tp["init_caches"](B, dt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    tok = np.asarray(jl).argmax(-1)
    for pos in range(S0, S0 + 3):
        jl, jk, jv = jp["decode_step"](jp["outer"], jp["layers"], tok,
                                       jnp.asarray(pos), jk, jv)
        tl, tk, tv = tp["decode_step"](tp["outer"], tp["layers"], tok, pos,
                                       tk, tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jl).argmax(-1)
    return gen


@pytest.mark.parametrize("tie,kv_cache_dtype", [(False, None),
                                                (True, "int8")])
def test_int8_weights_match_the_reference(tie, kv_cache_dtype):
    jm, tm = _pair(3, tie=tie, vocab=97, hidden=32, layers=2, heads=4,
                   kv_heads=2)
    prompts = np.random.default_rng(5).integers(1, 97, (3, 9)) \
        .astype(np.int32)
    gen = _hold(jm, tm, prompts, 10, max_len=48, weight_dtype="int8",
                kv_cache_dtype=kv_cache_dtype)
    outer, layers = gen._parts["outer"], gen._parts["layers"]
    for k in ("self_attn.q_proj.weight", "mlp.down_proj.weight"):
        q, s = layers[k]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert s.shape == (2, q.shape[-1])
    head = outer.get("lm_head.weight")
    assert head is None if tie else head[0].dtype == torch.int8
    assert outer["model.embed_tokens.weight"].dtype == torch.float32
    with pytest.raises(ValueError, match="weight_dtype"):
        llama_decode_factory(tm, weight_dtype="fp8", device="cpu")


@pytest.mark.parametrize("kv_cache_dtype,S0,new", [(None, 12, 10),
                                                   ("int8", 5, 20)])
def test_rolling_cache_matches_the_reference(kv_cache_dtype, S0, new):
    """Window 8 under max_len 16: a 12-token prompt rolls its last 8
    positions into the buffer; a 5-token one fills slots 0..4 and its
    decode wraps past max_len."""
    jm, tm = _pair(13, window=8, vocab=61, hidden=32, layers=2, heads=2,
                   kv_heads=2)
    prompts = np.random.default_rng(1).integers(1, 61, (2, S0)) \
        .astype(np.int32)
    gen = _hold(jm, tm, prompts, new, max_len=16,
                kv_cache_dtype=kv_cache_dtype)
    assert gen._parts["rolling"] and S0 + new > 16
    cache = gen._parts["init_caches"](2, torch.float32)
    leaf = cache[0] if isinstance(cache, tuple) else cache
    assert leaf.shape[3] == 8                   # O(window) slots


# --- the speculative factory ------------------------------------------------

@pytest.fixture(scope="module")
def spec_models():
    jt, tt = _pair(31, vocab=97, hidden=64, layers=3, heads=4, kv_heads=2)
    jd, td = _pair(32, vocab=97, hidden=32, layers=1, heads=2, kv_heads=2)
    return {"target": (jt, tt), "draft": (jd, td)}


@pytest.mark.parametrize("which", ["draft", "target"])
def test_speculative_factory_matches_the_reference(spec_models, which):
    (jt, tt), (jd, td) = spec_models["target"], spec_models[which]
    prompt = np.random.default_rng(2).integers(0, 97, (1, 6)) \
        .astype(np.int32)
    oracle = np.asarray(jax_dense_factory(jt, max_len=64)(prompt, 24))
    ref = jax_spec_factory(jt, jd, max_len=64, n_draft=4)
    spec = llama_speculative_decode_factory(tt, td, max_len=64, n_draft=4,
                                            device="cpu")
    got, want = spec(prompt, 24), ref(prompt, 24)
    assert (got == np.asarray(want)).all() and (got == oracle).all()
    assert spec.last_stats == ref.last_stats
    got_c = spec.compiled(prompt, 24)
    assert (got_c == got).all()
    if which == "draft":
        # the reference's one-program loop: the same rounds and stats
        assert (got_c == np.asarray(ref.compiled(prompt, 24))).all()
        assert spec.compiled.last_stats == ref.compiled.last_stats
    else:
        # every proposal accepted: about 5 tokens a target step
        assert spec.last_stats["target_steps"] < 24 // 3
        assert spec.compiled.last_stats["accept_rate"] == 1.0


def test_speculative_factory_refusals():
    """The reference's refusals, word for word."""
    _, t = _pair(0, vocab=97)
    _, d = _pair(0, vocab=61)
    _, w = _pair(0, window=8, vocab=97)
    jt, jd, jw = (JaxLlama(JaxConfig.tiny(vocab=97)),
                  JaxLlama(JaxConfig.tiny(vocab=61)), None)
    wc = JaxConfig.tiny(vocab=97)
    wc.sliding_window = 8
    jw = JaxLlama(wc)
    for got, want in ((lambda: llama_speculative_decode_factory(
                          t, d, device="cpu"),
                       lambda: jax_spec_factory(jt, jd)),
                      (lambda: llama_speculative_decode_factory(
                          t, w, device="cpu"),
                       lambda: jax_spec_factory(jt, jw)),
                      (lambda: llama_speculative_decode_factory(
                          t, t, n_draft=0, device="cpu"),
                       lambda: jax_spec_factory(jt, jt, n_draft=0))):
        with pytest.raises(ValueError) as g:
            got()
        with pytest.raises(ValueError) as r:
            want()
        assert str(g.value) == str(r.value)
    spec = llama_speculative_decode_factory(t, t, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="batch 1"):
        spec(np.ones((2, 4), np.int32), 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        spec.compiled(np.ones((1, 4), np.int32), 4)
