"""The port's decoder half of ``nn`` and ``FusedMultiTransformer`` against
the JAX package, on the same weights (the reference's ``state_dict()``
through ``nn.load_numpy_state_dict``) and the same numpy inputs, float32
on both sides, at dropout 0 and tiny widths (d 32, 4 heads):

* ``MultiHeadAttention``'s caches: every branch of ``gen_cache``, a
  forward with a ``Cache`` and with a ``StaticCache`` (output and new
  cache, in the reference's order with ``need_weights``), a ``Cache``
  step of two tokens (not causal unless masked, as in the reference), and
  a bfloat16 layer over an empty float32 ``Cache``, which promotes the
  output and the cache to float32 as ``jnp.concatenate`` does;
* ``TransformerEncoderLayer`` / ``TransformerEncoder`` with caches;
  ``TransformerDecoderLayer`` pre- and post-LN (output and gradients
  with a causal ``tgt_mask`` and an additive ``memory_mask``, and with a
  cache); ``TransformerDecoder``'s ``gen_cache`` (``do_zip``) and a
  token-by-token decode through its caches, equal to the no-cache causal
  forward; ``Transformer`` (output and gradients, its final norms only
  under ``normalize_before``, custom stacks) and its mask helper;
* the fused layers' ``cache``: dropped by ``FusedMultiHeadAttention``,
  never read by ``FusedFeedForward``, so the encoder layer returns its
  output alone;
* ``FusedMultiTransformer``: forward and gradients (pre- and post-LN,
  gelu and relu), token-by-token decode equal to the no-cache forward,
  the reference's masks (a cached block is not causal, ``attn_mask``
  replaces the causal mask without caches and is ignored with them,
  caches without ``time_step`` leave the cache alone, a start past the
  end is clamped), its dtypes (an f32 cache under a bf16 step raises),
  its unread arguments, its tanh GELU, its initial weights, and 3 AdamW
  steps against the reference's.

Tolerance: f32 on both sides, apart by the order of sums only: 1e-5
absolute and relative for outputs and gradients; the decode against the
forward 1e-5 absolute. The 3 steps: losses 1e-5, parameters at most 1e-4
of a tensor's elements beyond 1e-5 and none beyond lr (the rule of
``tests/test_torch_train_step.py``). The bf16 promotion: the f32 output
of one bf16 layer, bf16 roundings of its projections apart: 2e-2
absolute and relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate import nn as ref_inc
from paddle_tpu.models.nlp.train_utils import adamw_update
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.incubate import nn as port_inc
from paddle_tpu_torch.models.nlp import make_adamw_state
from paddle_tpu_torch.models.nlp.train_utils import apply_adamw

TOL = dict(atol=1e-5, rtol=1e-5)
E, H, FF = 32, 4, 64
RMHA, TMHA = ref_nn.MultiHeadAttention, tnn.MultiHeadAttention


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _port_of(ref, make):
    port = make()
    tnn.load_numpy_state_dict(port, _state(ref))
    return port


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def _same(got, want, **tol):
    """Nested tuples / lists / namedtuples of tensors, equal in structure,
    types and values."""
    if isinstance(want, (tuple, list)):
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, **tol)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


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


def _mha():
    paddle.seed(0)
    ref = RMHA(E, H)
    return ref, _port_of(ref, lambda: TMHA(E, H, device="cpu"))


def _causal(S):
    return np.where(np.tril(np.ones((S, S), bool)), 0.0,
                    -np.inf).astype(np.float32)


# --- MultiHeadAttention's caches ------------------------------------------

def test_mha_gen_cache_branches_match_jax():
    ref, port = _mha()
    x = _x((2, 5, E), 1)
    rx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    for kw in ({}, {"type": RMHA.StaticCache}):
        tkw = {"type": TMHA.StaticCache} if kw else {}
        r, t = ref.gen_cache(rx, **kw), port.gen_cache(tx, **tkw)
        assert isinstance(t, TMHA.StaticCache) and t.k.shape == (2, 5, H, 8)
        _same(t, r)
    for key in (rx, 2):
        r = ref.gen_cache(key, type=RMHA.Cache)
        t = port.gen_cache(tx if key is rx else 2, type=TMHA.Cache)
        assert isinstance(t, TMHA.Cache) and t.k.shape == (2, 0, H, 8)
        assert t.k.dtype == torch.float32 and str(r.k.dtype) == "float32"
    t = port.gen_cache(tx, tx)
    assert isinstance(t, TMHA.Cache) and t.k is tx and t.v is tx


MHA_CASES = ["cache", "static", "cache_need_weights", "cache_masked"]


@pytest.mark.parametrize("case", MHA_CASES)
def test_mha_forward_with_a_cache_matches_jax(case):
    ref, port = _mha()
    x, prev = _x((2, 3, E), 2), _x((2, 4, E), 3)
    rx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    if case == "static":
        r_cache = ref.gen_cache(paddle.to_tensor(prev))
        t_cache = port.gen_cache(torch.from_numpy(prev))
    else:        # a Cache already holding 4 positions
        r_cache = ref.gen_cache(*(ref.gen_cache(paddle.to_tensor(prev))))
        t_cache = port.gen_cache(*(port.gen_cache(torch.from_numpy(prev))))
        assert isinstance(t_cache, TMHA.Cache)
    ref.need_weights = port.need_weights = case == "cache_need_weights"
    mask = None
    if case == "cache_masked":     # the 3 new queries causal over 4 + 3
        mask = np.triu(np.full((3, 7), -1e9, np.float32), k=5)
    r = ref(rx, rx, rx, None if mask is None else paddle.to_tensor(mask),
            r_cache)
    t = port(tx, tx, tx, None if mask is None else torch.from_numpy(mask),
             t_cache)
    assert len(t) == (3 if port.need_weights else 2)
    _same(t, r)
    if case != "static":
        assert t[-1].k.shape == (2, 7, H, 8)


def test_mha_cache_step_of_two_tokens_is_not_causal():
    """Deliberate, as the reference: a ``Cache`` step attends to all of
    cache + step, so its first token sees the second; with a causal
    ``attn_mask`` it equals the no-cache causal forward."""
    ref, port = _mha()
    port.requires_grad_(False)
    x = _x((2, 3, E), 4)
    tx = torch.from_numpy(x)
    full = port(tx, attn_mask=torch.from_numpy(_causal(3)))
    _, cache = port(tx[:, :1], cache=port.gen_cache(tx, type=TMHA.Cache))
    t, _ = port(tx[:, 1:], cache=cache)
    _, r_cache = ref(paddle.to_tensor(x[:, :1]),
                     cache=ref.gen_cache(paddle.to_tensor(x),
                                         type=RMHA.Cache))
    r, _ = ref(paddle.to_tensor(x[:, 1:]), cache=r_cache)
    _same(t, r)
    assert float((t[:, 0] - full[:, 1]).abs().max()) > 1e-2
    np.testing.assert_allclose(_np(t[:, 1]), _np(full[:, 2]), atol=1e-5)
    masked, _ = port(tx[:, 1:], attn_mask=torch.from_numpy(
        _causal(3)[1:]), cache=cache)
    np.testing.assert_allclose(_np(masked), _np(full[:, 1:]), atol=1e-5)


def test_bf16_layer_promotes_an_f32_cache_as_jax():
    """A bfloat16 layer over ``gen_cache(type=Cache)`` (float32, as the
    reference's ``zeros``): the concatenation promotes K/V to float32, so
    the new cache and the output are float32 in both packages (the
    port's products promote as ``jnp``'s, where ``torch.matmul`` would
    refuse)."""
    ref, port = _mha()
    ref.bfloat16()
    port.to(torch.bfloat16)
    x = _x((2, 3, E), 5)
    rx = paddle.to_tensor(x).astype("bfloat16")
    tx = torch.from_numpy(x).to(torch.bfloat16)
    r, r_cache = ref(rx, cache=ref.gen_cache(rx, type=RMHA.Cache))
    t, t_cache = port(tx, cache=port.gen_cache(tx, type=TMHA.Cache))
    assert str(r.dtype) == "float32" and str(r_cache.k.dtype) == "float32"
    assert t.dtype == torch.float32 and t_cache.k.dtype == torch.float32
    assert t_cache.v.dtype == torch.float32
    np.testing.assert_allclose(_np(t), _np(r), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(t_cache.k), _np(r_cache.k), atol=2e-2,
                               rtol=2e-2)


# --- the encoder and decoder layers with caches --------------------------

@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_encoder_layer_and_stack_with_caches_match_jax(pre):
    paddle.seed(0)
    ref = ref_nn.TransformerEncoder(ref_nn.TransformerEncoderLayer(
        E, H, FF, dropout=0.0, normalize_before=pre), 2)
    port = _port_of(ref, lambda: tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(E, H, FF, dropout=0.0,
                                    normalize_before=pre, device="cpu"), 2))
    x = _x((2, 4, E), 6)
    rx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    layer, r_layer = port.layers[0], ref.layers[0]
    _same(layer(tx, cache=layer.gen_cache(tx)),
          r_layer(rx, cache=r_layer.gen_cache(rx)))
    t = port(tx, cache=port.gen_cache(tx))
    _same(t, ref(rx, cache=ref.gen_cache(rx)))
    assert isinstance(t[1], list) and len(t[1]) == 2
    assert t[1][1].k.shape == (2, 4, H, 8)


DEC_CASES = [(pre, act) for pre in (False, True) for act in ("relu", "gelu")]


@pytest.mark.parametrize("pre,act", DEC_CASES,
                         ids=[f"{'pre' if p else 'post'}-{a}"
                              for p, a in DEC_CASES])
def test_decoder_layer_matches_jax(pre, act):
    paddle.seed(0)
    ref = ref_nn.TransformerDecoderLayer(E, H, FF, dropout=0.0,
                                         activation=act,
                                         normalize_before=pre)
    port = _port_of(ref, lambda: tnn.TransformerDecoderLayer(
        E, H, FF, dropout=0.0, activation=act, normalize_before=pre,
        device="cpu"))
    tgt, mem = _x((2, 5, E), 7), _x((2, 6, E), 8)
    mem_mask = np.zeros((2, 1, 1, 6), np.float32)
    mem_mask[1, ..., 4:] = np.finfo(np.float32).min
    r_args = [paddle.to_tensor(a) for a in (tgt, mem, _causal(5), mem_mask)]
    t_args = [torch.from_numpy(a) for a in (tgt, mem, _causal(5), mem_mask)]
    r = ref(*r_args)
    (r ** 2).mean().backward()
    t = port(*t_args)
    (t ** 2).mean().backward()
    _same(t, r)
    _grads_match(ref, port)
    with torch.no_grad():
        got = port(t_args[0], t_args[1], cache=port.gen_cache(t_args[1]))
    _same(got, ref(r_args[0], r_args[1], cache=ref.gen_cache(r_args[1])))
    assert isinstance(got[1][0], TMHA.Cache)
    assert isinstance(got[1][1], TMHA.StaticCache)


def test_decoder_stack_decodes_token_by_token_as_its_causal_forward():
    """``gen_cache(memory)`` then one-token steps: each output equals the
    no-cache forward under the causal ``tgt_mask`` at its position
    (1e-5), in the port as in the reference, and the caches equal the
    reference's; ``do_zip`` groups the pairs."""
    paddle.seed(0)
    ref = ref_nn.TransformerDecoder(ref_nn.TransformerDecoderLayer(
        E, H, FF, dropout=0.0), 2, ref_nn.LayerNorm(E))
    port = _port_of(ref, lambda: tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(E, H, FF, dropout=0.0, device="cpu"), 2,
        tnn.LayerNorm(E, device="cpu")))
    tgt, mem = _x((2, 4, E), 9), _x((2, 6, E), 10)
    rt, rm = paddle.to_tensor(tgt), paddle.to_tensor(mem)
    tt, tm = torch.from_numpy(tgt), torch.from_numpy(mem)
    with torch.no_grad():
        full = port(tt, tm, torch.from_numpy(_causal(4)))
        cache, r_cache = port.gen_cache(tm), ref.gen_cache(rm)
        for s in range(4):
            out, cache = port(tt[:, s:s + 1], tm, cache=cache)
            r_out, r_cache = ref(rt[:, s:s + 1], rm, cache=r_cache)
            np.testing.assert_allclose(_np(out[:, 0]), _np(full[:, s]),
                                       atol=1e-5, rtol=0)
            _same(out, r_out)
    _same(cache, r_cache)
    zipped = port.gen_cache(tm, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert all(isinstance(c, TMHA.Cache) for c in zipped[0])
    assert all(isinstance(c, TMHA.StaticCache) for c in zipped[1])


@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_transformer_matches_jax(pre):
    paddle.seed(0)
    ref = ref_nn.Transformer(E, H, 2, 2, FF, dropout=0.0,
                             normalize_before=pre)
    port = _port_of(ref, lambda: tnn.Transformer(
        E, H, 2, 2, FF, dropout=0.0, normalize_before=pre, device="cpu"))
    assert ("encoder.norm.weight" in port.state_dict()) == pre
    assert ("decoder.norm.weight" in port.state_dict()) == pre
    src, tgt = _x((2, 6, E), 11), _x((2, 5, E), 12)
    mask = tnn.Transformer.generate_square_subsequent_mask(5, device="cpu")
    r = ref(paddle.to_tensor(src), paddle.to_tensor(tgt),
            tgt_mask=ref.generate_square_subsequent_mask(5))
    (r ** 2).mean().backward()
    t = port(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=mask)
    (t ** 2).mean().backward()
    _same(t, r)
    _grads_match(ref, port)
    # the layers of each stack start from one set of weights
    assert torch.equal(port.decoder.layers[0].linear1.weight,
                       port.decoder.layers[1].linear1.weight)


def test_transformer_custom_stacks_and_mask_helper():
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, H, FF, dropout=0.0, device="cpu"), 1)
    dec = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        E, H, FF, dropout=0.0, device="cpu"), 1)
    model = tnn.Transformer(E, H, custom_encoder=enc, custom_decoder=dec,
                            device="cpu")
    assert model.encoder is enc and model.decoder is dec
    assert sorted(model.state_dict()) == sorted(
        [f"encoder.{k}" for k in enc.state_dict()]
        + [f"decoder.{k}" for k in dec.state_dict()])
    for n in (1, 5):
        t = tnn.Transformer.generate_square_subsequent_mask(n, device="cpu")
        r = ref_nn.Transformer.generate_square_subsequent_mask(n)
        assert t.dtype == torch.float32 and t.shape == (n, n)
        np.testing.assert_array_equal(t.numpy(), r.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tnn.Transformer.generate_square_subsequent_mask(3)


# --- the fused layers' cache ----------------------------------------------

def test_fused_layers_drop_the_cache_as_jax():
    """Deliberate, as the reference: ``FusedMultiHeadAttention`` hands
    ``cache`` to its attention and keeps the output alone (the updated
    cache is dropped); ``FusedFeedForward`` never reads it; the encoder
    layer returns a tensor."""
    paddle.seed(0)
    ref = ref_inc.FusedTransformerEncoderLayer(E, H, FF, dropout_rate=0.0)
    port = _port_of(ref, lambda: port_inc.FusedTransformerEncoderLayer(
        E, H, FF, dropout_rate=0.0, device="cpu")).requires_grad_(False)
    x, prev = _x((2, 3, E), 13), _x((2, 4, E), 14)
    rx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    r_attn, t_attn = ref.fused_attn.attn, port.fused_attn.attn
    r_cache = r_attn.gen_cache(*r_attn.gen_cache(paddle.to_tensor(prev)))
    t_cache = t_attn.gen_cache(*t_attn.gen_cache(torch.from_numpy(prev)))
    for r_c, t_c in ((r_cache, t_cache),
                     (r_attn.gen_cache(rx, type=RMHA.Cache),
                      t_attn.gen_cache(tx, type=TMHA.Cache))):
        t = port.fused_attn(tx, cache=t_c)
        assert isinstance(t, torch.Tensor)
        _same(t, ref.fused_attn(rx, cache=r_c))
        t = port(tx, cache=t_c)
        assert isinstance(t, torch.Tensor)
        _same(t, ref(rx, cache=r_c))
    # a cache holding 4 positions changes the output: it was used
    assert float((port(tx, cache=t_cache) - port(tx)).abs().max()) > 1e-3
    assert torch.equal(port.ffn(tx, cache=object()), port.ffn(tx))


# --- FusedMultiTransformer ------------------------------------------------

def _fmt(pre=True, act="gelu", layers=2, **kw):
    paddle.seed(0)
    ref = ref_inc.FusedMultiTransformer(E, H, FF, activation=act,
                                        normalize_before=pre,
                                        num_layers=layers)
    port = _port_of(ref, lambda: port_inc.FusedMultiTransformer(
        E, H, FF, activation=act, normalize_before=pre, num_layers=layers,
        device="cpu", **kw))
    return ref, port


FMT_CASES = [(pre, act) for pre in (True, False) for act in ("gelu", "relu")]


@pytest.mark.parametrize("pre,act", FMT_CASES,
                         ids=[f"{'pre' if p else 'post'}-{a}"
                              for p, a in FMT_CASES])
def test_fused_multi_transformer_forward_matches_jax(pre, act):
    ref, port = _fmt(pre, act)
    x = _x((2, 5, E), 15)
    r = ref(paddle.to_tensor(x))
    (r ** 2).mean().backward()
    t = port(torch.from_numpy(x))
    (t ** 2).mean().backward()
    _same(t, r)
    _grads_match(ref, port)


@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_fused_multi_transformer_decodes_as_its_forward(pre):
    """One token at a time through ``caches`` / ``time_step``: each
    output equals the no-cache forward at its position (1e-5; the port
    reads 0 here), and the outputs and caches equal the reference's."""
    ref, port = _fmt(pre)
    x = _x((2, 5, E), 16)
    with torch.no_grad():
        full = port(torch.from_numpy(x))
        cache, r_cache = port.gen_cache(2, 8), ref.gen_cache(2, 8)
        assert cache.shape == (2, 2, 2, H, 8, 8)
        assert cache.dtype == torch.float32
        for s in range(5):
            out, cache = port(torch.from_numpy(x[:, s:s + 1]), caches=cache,
                              time_step=s)
            r_out, r_cache = ref(paddle.to_tensor(x[:, s:s + 1]),
                                 caches=r_cache, time_step=s)
            np.testing.assert_allclose(_np(out[:, 0]), _np(full[:, s]),
                                       atol=1e-5, rtol=0)
            _same(out, r_out)
    _same(cache, r_cache)
    assert not cache[:, :, :, :, 5:].any()


def test_fused_multi_transformer_masks_as_jax():
    """Each deliberate, as the reference: a 4-token block through the
    cache at ``time_step=0`` sees every key below 4 (not causal: apart
    from the forward but at the last position of the first layer); an
    ``attn_mask`` replaces the causal mask without caches and is ignored
    with them; ``caches`` without ``time_step`` attend over the step
    alone (the causal forward) and come back unchanged; a start past
    ``max_len - T`` is clamped."""
    ref, port = _fmt(layers=1)
    x = _x((2, 4, E), 17)
    rx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    full = port(tx)
    block, cache = port(tx, caches=port.gen_cache(2, 8), time_step=0)
    _same((block, cache), ref(rx, caches=ref.gen_cache(2, 8), time_step=0))
    apart = (block - full).abs().amax(dim=(0, 2))
    assert (apart[:3] > 1e-2).all() and float(apart[3]) < 1e-5
    mask = _x((4, 4), 18)                 # additive, no causal part
    t = port(tx, attn_mask=torch.from_numpy(mask))
    _same(t, ref(rx, attn_mask=paddle.to_tensor(mask)))
    assert float((t[:, 0] - full[:, 0]).abs().max()) > 1e-2
    masked, _ = port(tx, attn_mask=torch.from_numpy(mask),
                     caches=port.gen_cache(2, 8), time_step=0)
    assert torch.equal(masked, block)
    filled = torch.randn(1, 2, 2, H, 8, 8)
    alone, same = port(tx, caches=filled)
    _same((alone, same), ref(rx, caches=paddle.to_tensor(filled.numpy())))
    assert torch.equal(same, filled)
    np.testing.assert_allclose(_np(alone), _np(full), atol=1e-6, rtol=0)
    _same(port(tx, caches=filled, time_step=6),
          ref(rx, caches=paddle.to_tensor(filled.numpy()), time_step=6))


def test_fused_multi_transformer_dtypes_and_unread_arguments():
    """An f32 cache under a bf16 step raises TypeError in both packages
    (no silent cast); cast, it runs in bf16. ``dropout_rate``, ``nranks``
    and ``ring_id`` are never read; ``"gelu"`` is the tanh approximation
    (not the exact form); an unknown activation raises KeyError at the
    call; the weights start uniform within ±sqrt(6 / fan_in) under the
    reference's names and shapes."""
    ref, port = _fmt()
    ref.bfloat16()
    port.to(torch.bfloat16)
    x = _x((2, 1, E), 19)
    with pytest.raises(TypeError, match="same dtypes"):
        ref(paddle.to_tensor(x).astype("bfloat16"),
            caches=ref.gen_cache(2, 8), time_step=0)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        port(tx, caches=port.gen_cache(2, 8), time_step=0)
    out, cache = port(tx, caches=port.gen_cache(2, 8).to(torch.bfloat16),
                      time_step=0)
    assert out.dtype == cache.dtype == torch.bfloat16

    x = torch.from_numpy(_x((2, 5, E), 20))
    base = _fmt()[1]
    odd = _fmt(dropout_rate=0.5, nranks=4, ring_id=3)[1].train()
    assert torch.equal(odd(x), base(x))
    z = np.linspace(-4, 4, 101, dtype=np.float32)
    tanh = port_inc._ACTIVATIONS["gelu"](torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(tanh, np.asarray(jax.nn.gelu(z)), atol=1e-6)
    assert np.abs(tanh - np.asarray(jax.nn.gelu(z, approximate=False))) \
        .max() > 1e-4
    base.activation = "swish"
    with pytest.raises(KeyError):
        base(x)

    big = port_inc.FusedMultiTransformer(64, 4, 256, num_layers=3,
                                         device="cpu")
    assert {k: tuple(v.shape) for k, v in big.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref_inc.FusedMultiTransformer(
            64, 4, 256, num_layers=3).state_dict().items()}
    for name, fan_in in (("qkv_weight", 64), ("ffn2_weight", 256)):
        w = getattr(big, name)
        limit = (6.0 / fan_in) ** 0.5
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.95 * limit
    assert not big.qkv_bias.any() and torch.equal(
        big.ffn_ln_scale, torch.ones(3, 64))


def test_fused_multi_transformer_three_train_steps_match_jax():
    """3 AdamW steps (lr 1e-3, betas (0.9, 0.95), weight decay 0.01) of
    the MSE of the no-cache forward against a target: the reference's
    through ``jax.value_and_grad`` and its ``adamw_update``, the port's
    through autograd and ``apply_adamw``."""
    lr = 1e-3
    ref, port = _fmt()
    x, tgt = _x((2, 6, E), 21), _x((2, 6, E), 22)
    params = ref.tree_flatten_params()
    m = {k: jnp.zeros_like(v) for k, v in params.items()}
    v2 = {k: jnp.zeros_like(v) for k, v in params.items()}

    def ref_loss(p):
        saved = ref.tree_flatten_params()
        ref.load_tree(p)
        try:
            with no_grad():
                out = ref(Tensor(jnp.asarray(x)))._value
        finally:
            ref.load_tree(saved)
        return jnp.mean(jnp.square(out - tgt))

    t_params = dict(port.named_parameters())
    opt = make_adamw_state(t_params)
    tx, ttgt = torch.from_numpy(x), torch.from_numpy(tgt)
    for step in range(1, 4):
        loss, grads = jax.value_and_grad(ref_loss)(params)
        for k in params:
            params[k], m[k], v2[k] = adamw_update(
                params[k], grads[k], m[k], v2[k], jnp.float32(step), lr,
                0.9, 0.95, 1e-8, 0.01)
        t_loss = torch.square(port(tx) - ttgt).mean()
        apply_adamw(t_params, list(torch.autograd.grad(
            t_loss, list(t_params.values()))), opt, lr, 0.9, 0.95, 1e-8,
            0.01)
        np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                                   atol=1e-5, rtol=0, err_msg=f"step {step}")
    for k, p in t_params.items():
        diff = np.abs(p.detach().numpy() - np.asarray(params[k]))
        if k == "qkv_bias":
            # the key bias shifts all of a query's scores alike, which the
            # softmax does not see: its gradient is rounding noise, which
            # AdamW steps by about lr a step each way
            assert diff[:, E:2 * E].max() <= 2 * 3 * lr, k
            diff = np.concatenate([diff[:, :E], diff[:, 2 * E:]], 1)
        assert (diff > 1e-5).mean() <= 1e-4, k
        assert diff.max() <= lr, k
