"""The port's Mixture-of-Experts slice against the JAX package, on the same
numpy inputs and weights (the reference's ``state_dict()`` through
``load_numpy_state_dict``), float32 on both sides:

* every gating function (``top1_gating``, ``top2_gating``,
  ``_topk_picks``, ``topk_gating``, ``topk_gating_idx``,
  ``expert_choice_gating``) at k = 1, 2, 4, with capacities that drop
  pairs and capacities that drop none: expert ids, positions, keep flags
  and dense dispatch exactly; probabilities, weights, combine and aux
  within 1e-6; the top-1 noise as the reference's formula on the port's
  own draw;
* ``indexed_dispatch``, ``inverted_dispatch`` and ``indexed_combine``,
  with a dropped pair aimed at a slot a kept token holds (the case a copy
  in place of the scatter-add gets wrong, shown in the test);
* ``MoELayer`` for every gate and dispatch mode, and top-k overrides:
  output, aux and the gradients of the input and every weight (the
  reference's autograd, ``jax.vjp``);
* ``MoEForCausalLM`` at ``tiny()``, ``deepseek_tiny()``, a config with
  dense layers between MoE ones, and a flash-eligible config at S = 256
  with kv groups of 2 (the JAX Pallas kernels in interpret mode, the
  port's plain versions): logits and ``aux_loss()``;
* 3 steps of ``moe_train_step_factory`` against the reference's on a
  one-device mesh, plain, with ``chunked_vocab_ce`` and with ``remat``:
  losses, parameters and both AdamW moments;
* the presets, ``activated_params()``, the state-dict keys and shapes, the
  initial distributions (the 3-D fan rule), a first loss near ln V, the
  example and the refusals.

Tolerances (readings from a CPU run of these cases). The router's
arithmetic is the same f32 operations in the same order on both sides,
apart from ``softmax``'s last bit: ids, positions, keep and dispatch
must be equal; probabilities, weights, combine and aux within 1e-6
absolute (reading 1.2e-7). Layer outputs and gradients: order of f32
sums only, 1e-5 absolute and relative (reading 0.017 of it). Logits:
1e-4 absolute, the port's Llama tests' limit (reading 2.0e-6 at S = 256,
3.1e-7 at the tiny configs), aux 1e-6 (reading 3.7e-9). The 3 steps:
losses 1e-5 (reading 9.5e-7); parameters by the port's train-step rule:
at most 1e-4 of a tensor's elements, or one element of a smaller
tensor, beyond 1e-5, none beyond lr. AdamW moves a weight by about lr
whatever its gradient's size, so a gradient within f32 noise of 0 may
step apart (reading: one element of a (64, 96) dense gate_proj whose
first gradient, 1.0e-8, is about AdamW's eps, 2.0e-5 apart; every other
element within 1.4e-5). First moments 1e-6 absolute (reading 7.8e-8);
second moments 1e-8 + 1e-4 relative (reading 0.091 of it).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as ref_moe
from paddle_tpu.models import nlp as ref_nlp
from paddle_tpu_torch.core import Generator
from paddle_tpu_torch.incubate.distributed.models import moe as port_moe
from paddle_tpu_torch.models import nlp as port_nlp

EXACT_TOL = dict(atol=1e-6, rtol=0)
TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS_ATOL = 1e-4
LR = 1e-3


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _logits(T, E, seed, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal((T, E))
            ).astype(np.float32)


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


# --- gating ----------------------------------------------------------------

# (k, capacity): T = 32 tokens over E = 8 experts; capacity 3 drops pairs
# at every k, T·k drops none
GATING_CASES = [(1, 3), (1, 32), (2, 3), (2, 64), (4, 5), (4, 128)]


@pytest.mark.parametrize("k,cap", GATING_CASES)
def test_dense_gating_matches_jax(k, cap):
    lg = _logits(32, 8, seed=k * 100 + cap)
    if k == 1:
        want = ref_moe.top1_gating(jnp.asarray(lg), cap)
        got = port_moe.top1_gating(torch.from_numpy(lg), cap)
    elif k == 2:
        want = ref_moe.top2_gating(jnp.asarray(lg), cap)
        got = port_moe.top2_gating(torch.from_numpy(lg), cap)
        # topk_gating at k = 2 is top2_gating, in both packages
        got_k = port_moe.topk_gating(torch.from_numpy(lg), cap, 2)
        for a, b in zip(got_k, got):
            np.testing.assert_array_equal(_np(a), _np(b))
    else:
        want = ref_moe.topk_gating(jnp.asarray(lg), cap, k)
        got = port_moe.topk_gating(torch.from_numpy(lg), cap, k)
    (d, c, aux), (jd, jc, jaux) = got, want
    np.testing.assert_array_equal(_np(d), _np(jd))
    np.testing.assert_allclose(_np(c), _np(jc), **EXACT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **EXACT_TOL)
    dropped = 32 * k - int(_np(d).sum())
    assert (dropped > 0) == (cap < 32 * k)


@pytest.mark.parametrize("k,cap", GATING_CASES)
def test_index_gating_matches_jax(k, cap):
    lg = _logits(32, 8, seed=k * 10 + cap)
    want = ref_moe.topk_gating_idx(jnp.asarray(lg), cap, k)
    got = port_moe.topk_gating_idx(torch.from_numpy(lg), cap, k)
    for name, a, b in zip(("eids", "pos", "keep"), got[:3], want[:3]):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    assert got[0].dtype == got[1].dtype == torch.int32
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), **EXACT_TOL)
    np.testing.assert_allclose(float(got[4]), float(want[4]), **EXACT_TOL)
    keep = _np(got[2])
    assert (keep.sum() < 32 * k) == (cap < 32 * k)
    assert not _np(got[1])[~keep].any() and not _np(got[3])[~keep].any()


@pytest.mark.parametrize("k", [1, 2, 4])
def test_topk_picks_match_jax(k):
    probs = np.array(jax.nn.softmax(jnp.asarray(_logits(32, 8, 7)), -1))
    picks, aux = port_moe._topk_picks(torch.from_numpy(probs), k)
    jpicks, jaux = ref_moe._topk_picks(jnp.asarray(probs), k)
    for (g, p, oh), (jg, jp, joh) in zip(picks, jpicks):
        np.testing.assert_array_equal(_np(g), _np(jg))
        np.testing.assert_array_equal(_np(p), _np(jp))
        np.testing.assert_array_equal(_np(oh), _np(joh))
    np.testing.assert_allclose(float(aux), float(jaux), **EXACT_TOL)


def test_first_maximum_wins_ties():
    lg = np.zeros((4, 6), np.float32)
    lg[:, 2] = lg[:, 4] = 1.0           # a tie between experts 2 and 4
    eids = port_moe.topk_gating_idx(torch.from_numpy(lg), 8, 2)[0]
    jeids = ref_moe.topk_gating_idx(jnp.asarray(lg), 8, 2)[0]
    np.testing.assert_array_equal(_np(eids), _np(jeids))
    assert (_np(eids) == [2, 4]).all()


@pytest.mark.parametrize("cap", [3, 40])
def test_expert_choice_gating_matches_jax(cap):
    lg = _logits(32, 8, seed=cap)
    d, c, aux = port_moe.expert_choice_gating(torch.from_numpy(lg), cap)
    jd, jc, jaux = ref_moe.expert_choice_gating(jnp.asarray(lg), cap)
    np.testing.assert_array_equal(_np(d), _np(jd))
    np.testing.assert_allclose(_np(c), _np(jc), **EXACT_TOL)
    assert float(aux) == float(jaux) == 0.0
    assert d.shape == (32, 8, min(cap, 32))     # capacity capped at T


def test_top1_noise_is_the_reference_formula_on_the_ports_draw():
    """In training the top-1 gates add eps_std·N(0, 1) to the logits,
    drawn from the generator given; the reference's gate on the noised
    logits gives the same routing."""
    lg = _logits(32, 8, seed=3, scale=0.01)     # near-ties: noise decides
    noise = torch.randn((32, 8), generator=torch.Generator().manual_seed(9))
    noised = jnp.asarray((torch.from_numpy(lg) + 0.01 * noise).numpy())
    got = port_moe.topk_gating_idx(torch.from_numpy(lg), 3, 1,
                                   torch.Generator().manual_seed(9), 0.01)
    want = ref_moe.topk_gating_idx(noised, 3, 1)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), **EXACT_TOL)
    d, c, _ = port_moe.top1_gating(torch.from_numpy(lg), 3,
                                   torch.Generator().manual_seed(9), 0.01)
    jd, jc, _ = ref_moe.top1_gating(noised, 3)
    np.testing.assert_array_equal(_np(d), _np(jd))
    np.testing.assert_allclose(_np(c), _np(jc), **EXACT_TOL)
    plain = port_moe.topk_gating_idx(torch.from_numpy(lg), 3, 1)[0]
    assert not torch.equal(plain, got[0])       # the noise moved a choice


# --- dispatch and combine --------------------------------------------------

def _routing(T, E, k, cap, seed):
    lg = _logits(T, E, seed)
    return (ref_moe.topk_gating_idx(jnp.asarray(lg), cap, k),
            port_moe.topk_gating_idx(torch.from_numpy(lg), cap, k))


@pytest.mark.parametrize("k,cap", [(1, 4), (2, 5), (4, 9), (2, 64)])
def test_dispatch_and_combine_match_jax(k, cap):
    T, E, H = 24, 6, 16
    (jr, pr) = _routing(T, E, k, cap, seed=k + cap)
    x = np.random.default_rng(1).standard_normal((T, H)).astype(np.float32)
    for port_fn, ref_fn in ((port_moe.indexed_dispatch,
                             ref_moe.indexed_dispatch),
                            (port_moe.inverted_dispatch,
                             ref_moe.inverted_dispatch)):
        got = port_fn(torch.from_numpy(x), *pr[:3], cap, E)
        want = ref_fn(jnp.asarray(x), *jr[:3], cap, E)
        np.testing.assert_array_equal(_np(got), _np(want))
    eo = np.random.default_rng(2).standard_normal((E, cap, H)).astype(
        np.float32)
    got = port_moe.indexed_combine(torch.from_numpy(eo), pr[0], pr[1], pr[3],
                                   cap)
    want = ref_moe.indexed_combine(jnp.asarray(eo), jr[0], jr[1], jr[3], cap)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_dropped_pair_on_an_occupied_slot():
    """Token 0 holds expert 1's slot 0; token 2's second choice (expert
    1) is dropped, so its pair points at the same slot 1·C + 0. The
    reference adds a zero row there and token 0's row stays; a copy in
    place of the add would write token 2's zeroed row over it."""
    C, E, H = 2, 3, 4
    x = np.arange(1, 4 * H + 1, dtype=np.float32).reshape(4, H)
    eids = np.array([[1, 0], [1, 2], [0, 1], [2, 0]], np.int32)
    pos = np.array([[0, 0], [1, 0], [1, 0], [1, 0]], np.int32)
    keep = np.array([[1, 1], [1, 1], [1, 0], [1, 0]], bool)
    args = [torch.from_numpy(a) for a in (eids, pos, keep)]
    want = np.asarray(ref_moe.indexed_dispatch(
        jnp.asarray(x), *(jnp.asarray(a) for a in (eids, pos, keep)), C, E))
    for fn in (port_moe.indexed_dispatch, port_moe.inverted_dispatch):
        got = _np(fn(torch.from_numpy(x), *args, C, E))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[1, 0], x[0])    # token 0 kept
    # what a copy would leave there: the dropped pair's zero row
    flat = (args[0].long() * C + args[1].long()).reshape(-1)
    upd = torch.from_numpy(x)[:, None].expand(4, 2, H).reshape(8, H) \
        * args[2].reshape(8, 1)
    copied = torch.zeros(E * C, H).index_copy(0, flat, upd).reshape(E, C, H)
    assert not np.array_equal(_np(copied), want)
    assert not copied[1, 0].any()
    # the combine reads that slot with weight 0 for the dropped pair
    w = torch.tensor([[0.7, 0.3], [0.6, 0.4], [1.0, 0.0], [1.0, 0.0]])
    out = port_moe.indexed_combine(torch.from_numpy(want.copy()), *args[:2],
                                   w, C)
    np.testing.assert_allclose(_np(out)[2], want[0, 1] * 1.0, **TOL)


# --- MoELayer --------------------------------------------------------------

LAYER_CASES = [(gate, None, mode) for gate in ("gshard", "switch", "naive",
                                                 "expert_choice")
               for mode in ("indexed", "inverted", "einsum")]
LAYER_CASES += [("switch", 4, "indexed"), ("switch", 4, "einsum"),
                ("gshard", 3, "inverted")]


def _layers(gate, top_k, mode, H=16, F=32, E=8, seed=0):
    paddle.seed(seed)
    ref = ref_moe.MoELayer(H, F, E, gate=gate, top_k=top_k,
                           dispatch_mode=mode)
    port = port_moe.MoELayer(H, F, E, gate=gate, top_k=top_k,
                             dispatch_mode=mode, device="cpu")
    port_nlp.load_numpy_state_dict(port, _state(ref))
    return ref, port


@pytest.mark.parametrize("gate,top_k,mode", LAYER_CASES)
def test_moe_layer_matches_jax(gate, top_k, mode):
    """Output, aux and the gradients of x and every weight of
    sum(out · gout) + 3 · aux, in eval mode (no top-1 noise)."""
    ref, port = _layers(gate, top_k, mode)
    ref.eval()
    port.eval()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    gout = rng.standard_normal((2, 12, 16)).astype(np.float32)

    rx = paddle.to_tensor(x, stop_gradient=False)
    rout = ref(rx)
    ((rout * paddle.to_tensor(gout)).sum() + ref.aux_loss * 3.0).backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = port(tx)
    ((tout * torch.from_numpy(gout)).sum() + port.aux_loss * 3.0).backward()

    np.testing.assert_allclose(_np(tout), rout.numpy(), **TOL)
    np.testing.assert_allclose(float(port.aux_loss.detach()),
                               float(ref.aux_loss),
                               **EXACT_TOL)
    np.testing.assert_allclose(_np(tx.grad), rx.grad.numpy(), **TOL)
    ref_params = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(_np(p.grad), ref_params[name].grad.numpy(),
                                   **TOL, err_msg=name)
    assert port.top_k == ref.top_k and port.capacity(24) == ref.capacity(24)


def test_moe_layer_top1_noise_in_training():
    """A Switch layer in training draws its noise from its generator: the
    same seed gives the same output, and the output is the eval output
    of the noised logits' routing (checked through the gate function)."""
    outs = []
    for _ in range(2):
        layer = port_moe.MoELayer(16, 32, 8, gate="switch", device="cpu",
                                  generator=Generator(5))
        outs.append(layer(torch.ones(1, 6, 16)))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 24, 16)).astype(np.float32))
    layer = port_moe.MoELayer(16, 32, 8, gate="switch", device="cpu",
                              generator=torch.Generator().manual_seed(1))
    layer.gate.wg.weight.data *= 1e-3           # near-tie logits
    state = layer.generator.get_state()
    got = layer(x)
    glt = (x.reshape(24, 16) @ layer.gate.wg.weight).float()
    layer.generator.set_state(state)
    eids, pos, keep, w, _ = port_moe.topk_gating_idx(
        glt, layer.capacity(24), 1, layer.generator, 0.01)
    expert_in = port_moe.indexed_dispatch(x.reshape(24, 16), eids, pos, keep,
                                          layer.capacity(24), 8)
    want = port_moe.indexed_combine(layer.expert_ffn(expert_in), eids, pos, w,
                                    layer.capacity(24))
    torch.testing.assert_close(got.reshape(24, 16), want, atol=0, rtol=0)
    layer.eval()
    assert not torch.equal(layer(x), got)


def test_moe_layer_refusals():
    with pytest.raises(ValueError, match="dispatch_mode"):
        port_moe.MoELayer(8, 16, 4, dispatch_mode="sparse", device="cpu")


def test_expert_gelu_is_the_tanh_form():
    layer = port_moe.MoELayer(8, 16, 2, device="cpu")
    x = torch.randn(2, 3, 8)
    h = torch.bmm(x, layer.w_in.detach())
    want = torch.bmm(0.5 * h * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                               * (h + 0.044715 * h ** 3))),
                     layer.w_out.detach())
    torch.testing.assert_close(layer.expert_ffn(x).detach(), want,
                               atol=1e-6, rtol=1e-6)
    exact = torch.bmm(torch.nn.functional.gelu(h), layer.w_out.detach())
    assert not torch.allclose(layer.expert_ffn(x).detach(), exact,
                              atol=1e-7, rtol=0)


# --- the model -------------------------------------------------------------

# hidden 256, 4 / 2 heads: head_dim 64, kv groups of 2, flash-eligible at
# S = 256 (the JAX Pallas kernels in interpret mode)
FLASH = dict(vocab_size=256, hidden_size=256, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, num_experts=8, top_k=2, moe_every=1,
             num_shared_experts=1)
# dense SwiGLU layers between MoE ones, a switch gate, the einsum dispatch
MIXED = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, num_experts=4, top_k=1, moe_every=2,
             dispatch_mode="einsum")
CONFIGS = {"tiny": lambda m: m.MoEConfig.tiny(),
           "deepseek_tiny": lambda m: m.MoEConfig.deepseek_tiny(),
           "mixed": lambda m: m.MoEConfig(**MIXED),
           "flash": lambda m: m.MoEConfig(**FLASH)}


def _models(name, seed=0):
    paddle.seed(seed)
    ref = ref_nlp.MoEForCausalLM(CONFIGS[name](ref_nlp))
    port = port_nlp.MoEForCausalLM(CONFIGS[name](port_nlp), device="cpu")
    port_nlp.load_numpy_state_dict(port, _state(ref))
    return ref, port


@pytest.mark.parametrize("name,B,S", [("tiny", 2, 8), ("deepseek_tiny", 2, 8),
                                      ("mixed", 2, 16), ("flash", 1, 256)])
def test_model_logits_and_aux_match_jax(name, B, S):
    ref, port = _models(name)
    ref.eval()
    port.eval()
    ids = np.random.default_rng(5).integers(0, 256, (B, S)).astype(np.int32)
    want = ref(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(got), want, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(port.aux_loss()),
                               float(ref.aux_loss().numpy()), **EXACT_TOL)
    assert float(port.aux_loss()) > 0


@pytest.mark.parametrize("name", ["tiny", "deepseek_tiny", "mixed"])
def test_state_dict_keys_shapes_and_activated_params(name):
    ref, port = _models(name)
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert list(got) == list(want) and got == want
    assert port.activated_params() == ref.activated_params()


def test_presets_equal_the_references():
    for preset in ("tiny", "qwen2_57b_a14b", "deepseek_tiny"):
        got = dataclasses.asdict(getattr(port_nlp.MoEConfig, preset)())
        want = dataclasses.asdict(getattr(ref_nlp.MoEConfig, preset)())
        assert got == want, preset
        lc = getattr(port_nlp.MoEConfig, preset)().as_llama()
        assert lc.dtype == torch.float32 and lc.sliding_window is None
    q = port_nlp.MoEConfig.qwen2_57b_a14b()
    assert (q.shared_intermediate(), q.num_experts, q.top_k) == (20480, 64, 8)


def test_init_distributions_follow_the_reference():
    """Embedding N(0, 0.02), norms ones, projections and the router
    XavierNormal by (in, out), experts by the 3-D fan rule: std
    sqrt(2 / (H·F + E·F)) for w_in (E, H, F). Sample stds of the port's
    and the reference's draws against the formula, within 3 %."""
    cfg = dict(vocab_size=512, hidden_size=128, intermediate_size=192,
               num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=2, num_experts=16, moe_every=1,
               num_shared_experts=1)
    paddle.seed(0)
    ref = ref_nlp.MoEForCausalLM(ref_nlp.MoEConfig(**cfg))
    port = port_nlp.MoEForCausalLM(port_nlp.MoEConfig(**cfg), device="cpu",
                                   seed=3)
    H, F, E = 128, 192, 16
    want = {"embed_tokens.weight": 0.02,
            "layers.0.mlp.w_in": math.sqrt(2 / (H * F + E * F)),
            "layers.0.mlp.w_out": math.sqrt(2 / (F * H + E * H)),
            "layers.0.mlp.gate.wg.weight": math.sqrt(2 / (H + E)),
            "layers.0.self_attn.k_proj.weight": math.sqrt(2 / (H + 64)),
            "layers.0.shared_mlp.down_proj.weight": math.sqrt(2 / (F + H))}
    ref_sd = _state(ref)
    for name, std in want.items():
        for sd in (port.state_dict(), ref_sd):
            v = np.asarray(sd[name], np.float64)
            assert abs(v.std() / std - 1) < 0.03, (name, v.std(), std)
            assert abs(v.mean()) < 3 * std / math.sqrt(v.size) + 1e-9, name
    for name in ("norm.weight", "layers.0.input_layernorm.weight"):
        assert (port.state_dict()[name] == 1).all()
    # the 3-D rule at Qwen2-57B-A14B's widths, against per-expert Xavier
    q = port_moe.xavier_normal_std((64, 3584, 2560))
    assert abs(q - 4.63e-4) < 1e-6
    assert abs(port_moe.xavier_normal_std((3584, 2560)) - 1.80e-2) < 1e-4
    # a seed makes the same model, another a different one
    again = port_nlp.MoEForCausalLM(port_nlp.MoEConfig(**cfg), device="cpu",
                                    seed=3)
    assert all(torch.equal(a, b) for a, b in
               zip(port.state_dict().values(), again.state_dict().values()))


# --- the train step --------------------------------------------------------

def _factories(name, chunked, remat):
    ref, port = _models(name)
    if port.config.top_k == 1:
        # in training each package draws its own top-1 noise
        # (test_remat_equals_no_remat_with_top1_noise holds the port's)
        ref.eval()
        port.eval()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    j = ref_nlp.moe_train_step_factory(ref, mesh, learning_rate=LR,
                                       remat=remat,
                                       chunked_vocab_ce=chunked)
    p = port_nlp.moe_train_step_factory(port, learning_rate=LR, remat=remat,
                                        chunked_vocab_ce=chunked,
                                        device="cpu")
    return j, p, port


@pytest.mark.parametrize("name,chunked,remat", [
    ("tiny", None, False), ("deepseek_tiny", None, False),
    ("deepseek_tiny", 48, False), ("deepseek_tiny", None, True),
    ("mixed", 48, True)])
def test_three_factory_steps_match_jax(name, chunked, remat):
    (j_params, j_opt, j_step), (params, opt, step), port = _factories(
        name, chunked, remat)
    assert sorted(params) == sorted(j_params)
    assert params["embed_tokens.weight"] is port.embed_tokens.weight
    tok = np.random.default_rng(6).integers(0, 256, (2, 17)).astype(np.int32)
    ids, labels = tok[:, :-1], tok[:, 1:]
    losses = []
    for i in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt, jnp.asarray(ids),
                                         jnp.asarray(labels))
        params, opt, loss = step(params, opt, ids, labels)
        np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5,
                                   rtol=0, err_msg=f"step {i}")
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert int(opt["step"]) == int(j_opt["step"]) == 3
    for k, p in params.items():
        diff = np.abs(_np(p) - np.asarray(j_params[k]))
        assert (diff > 1e-5).sum() <= max(1, 1e-4 * diff.size), k
        assert diff.max() <= LR, k
        np.testing.assert_allclose(_np(opt["m"][k]),
                                   np.asarray(j_opt["m"][k]), atol=1e-6,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(_np(opt["v"][k]),
                                   np.asarray(j_opt["v"][k]), atol=1e-8,
                                   rtol=1e-4, err_msg=k)


def test_remat_equals_no_remat_with_top1_noise():
    """A Switch model in training: the checkpointed step recomputes with
    the forward's own router noise, so its losses and parameters equal
    those without remat."""
    cfg = port_nlp.MoEConfig(**MIXED)
    runs = []
    for remat in (False, True):
        model = port_nlp.MoEForCausalLM(cfg, device="cpu", seed=2,
                                        generator=Generator(4))
        params, opt, step = port_nlp.moe_train_step_factory(
            model, learning_rate=LR, remat=remat, device="cpu")
        tok = np.random.default_rng(1).integers(0, 256, (2, 17))
        losses = [float(step(params, opt, tok[:, :-1], tok[:, 1:])[2])
                  for _ in range(2)]
        runs.append((losses, {k: p.detach().clone()
                              for k, p in params.items()}))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], atol=0, rtol=0, msg=k)


def test_first_loss_near_ln_vocab():
    """The tied head over the N(0, 0.02) table starts near uniform
    prediction: the first loss within 2 % of ln V (the reference's own
    test allows 2x)."""
    cfg = port_nlp.MoEConfig.deepseek_tiny()
    model = port_nlp.MoEForCausalLM(cfg, device="cpu", seed=0)
    params, opt, step = port_nlp.moe_train_step_factory(model, device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    _, _, loss = step(params, opt, tok[:, :-1], tok[:, 1:])
    assert abs(float(loss) / math.log(cfg.vocab_size) - 1) < 0.02


def test_factory_refusals_and_the_default_device():
    model = port_nlp.MoEForCausalLM(port_nlp.MoEConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        port_nlp.moe_train_step_factory(model, object(), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        port_nlp.moe_train_step_factory(model, remat="dots", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    for device in (None, "cuda"):
        for make in (lambda: port_nlp.MoEForCausalLM(
                port_nlp.MoEConfig.tiny(), device=device),
                lambda: port_nlp.moe_train_step_factory(model,
                                                        device=device),
                lambda: port_moe.MoELayer(8, 16, 4, device=device)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


def test_example_trains_on_the_cpu():
    from paddle_tpu_torch.examples import train_moe

    losses = train_moe.main(["--device", "cpu", "--steps", "4"])
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_example_counts_and_fits_the_qwen_cut():
    """The example's parameter count equals the model's, and at Qwen2-57B-
    A14B's widths the depth rule takes 3 of 28 layers for the free memory
    an 80 GB H100 showed before the step (77.9-78.66 GiB): 1.424 B
    parameters a layer and 0.545 B in the tied embedding hold 53.8 GiB of
    state at 3 layers and 69.75 at 4, and 4 also need the step's 3 GiB
    above the state and 6 GiB for the allocator's fragments."""
    from paddle_tpu_torch.examples import train_moe

    for name in ("tiny", "deepseek_tiny", "mixed", "flash"):
        cfg = CONFIGS[name](port_nlp)
        model = port_nlp.MoEForCausalLM(cfg, device="cpu")
        assert train_moe.param_count(cfg) == sum(
            p.numel() for p in model.parameters()), name
    q = port_nlp.MoEConfig.qwen2_57b_a14b()
    per_layer = train_moe.param_count(q, 1) - train_moe.param_count(q, 0)
    assert abs(per_layer / 1e9 - 1.424) < 1e-3
    assert abs(train_moe.param_count(q, 0) / 1e9 - 0.545) < 1e-3
    for free_gib in (77.9, 78.66):
        assert train_moe.fitting_depth(q, int(free_gib * 2 ** 30)) == 3
    need = (12 * train_moe.param_count(q, 4) + train_moe.ABOVE_STATE
            + train_moe.DEPTH_MARGIN)
    assert abs(need / 2 ** 30 - 78.75) < 0.01
    assert train_moe.fitting_depth(q, need) == 4
    assert train_moe.fitting_depth(q, need - 1) == 3
