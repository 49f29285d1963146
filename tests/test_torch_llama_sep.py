"""The Llama train step and attention layer on a "sep" (context-parallel)
axis: the port against the JAX package.

``llama_train_step_factory(model, mesh=build_mesh(dims))`` runs in one
world of 4 gloo ranks on the CPU (``torch_dist_ranks``, started once for
the module) at a tiny f32 config (2 layers, hidden 256, 4 / 2 heads,
head_dim 64; S / sep = 256, so each rank's chunk takes the flash engine's
plain versions) on {sep 2, data 2} and {sep 2, model 2} with ring
attention, {sep 2, sharding 2} with Ulysses, and {sep 4} with a sliding
window of 300 (the window ring: 3 of 4 pair distances). Each is held
against the reference factory on the same mesh of 4 of the 8 host devices,
the same weights and the same batch:

* the 3 losses, on every rank, within 1e-5 relative;
* each rank took the route the reference's attention takes
  (``ring_attention``, ``ulysses_attention`` or ``ring_window_attention``
  once a layer);
* the rank at sep coordinate c holds its columns of the batch: parameters
  stay equal over "sep";
* ``remat=True`` on {sep 2, data 2} gives the same bits as ``False``.

The Layer path: ``LlamaAttention`` under ``set_context_parallel_mesh`` on
{sep 4} (ring and Ulysses) and, windowed, on {data 2, sep 2}: each rank's
output chunk within 1e-5 (relative and absolute) of the reference
layer's output on the whole sequence (the rotary at the chunk's global
positions), its input gradient within the same of the port's
single-process layer's on the whole sequence, and the weight gradients
summed over the sep ranks within 1e-5 relative, 1e-5 of the largest
element absolute, of that layer's (each is a sum over the 1024 positions,
which the ranks add up in parts).
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=2048,
           dtype=torch.float32)
WINDOW = 300
B, STEPS, LR = 2, 3, 1e-3
# name: (mesh, S, flag context_parallel_backend, sliding window)
RUNS = {"sep_data": ({"sep": 2, "data": 2}, 512, "ring", None),
        "sep_model": ({"sep": 2, "model": 2}, 512, "ring", None),
        "sep_sharding_ulysses": ({"sep": 2, "sharding": 2}, 512, "ulysses",
                                 None),
        "sep4_window": ({"sep": 4}, 1024, "ring", WINDOW)}
ROUTE = {"ring": "ring_attention", "ulysses": "ulysses_attention"}
LAYER_S = 1024
LAYER_RUNS = {"layer": ({"sep": 4}, None, ("ring", "ulysses")),
              "layer_window": ({"data": 2, "sep": 2}, WINDOW, ("ring",))}
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(window):
    return dict(CFG, sliding_window=window)


def _ref_model(cfg, seed=0):
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.models.nlp import LlamaConfig as JConfig
    from paddle_tpu.models.nlp import LlamaForCausalLM as JLlama
    kw = {k: v for k, v in cfg.items() if k != "dtype"}
    paddle.seed(seed)
    jm = JLlama(JConfig(**kw, dtype=jnp.float32))
    return jm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _batch(S, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32),
            rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32))


def _layer_inputs(seed=2):
    rng = np.random.default_rng(seed)
    H = CFG["hidden_size"]
    return (rng.standard_normal((1, LAYER_S, H)).astype(np.float32),
            rng.standard_normal((1, LAYER_S, H)).astype(np.float32))


def _attention_state(state):
    pre = "model.layers.0.self_attn."
    return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def states():
    return {w: _ref_model(_cfg(w))[1] for w in (None, WINDOW)}


@pytest.fixture(scope="module")
def world(tmp_path_factory, states):
    scenarios = []
    for name, (dims, S, backend, window) in RUNS.items():
        tokens, labels = _batch(S)
        scenarios.append((name, "llama_mesh", dict(
            dims=dims, cfg=_cfg(window), state=states[window],
            tokens=tokens, labels=labels, steps=STEPS, lr=LR,
            backend=backend)))
    dims, S, backend, window = RUNS["sep_data"]
    tokens, labels = _batch(S)
    scenarios.append(("sep_data_remat", "llama_mesh", dict(
        dims=dims, cfg=_cfg(window), state=states[window], tokens=tokens,
        labels=labels, steps=STEPS, lr=LR, backend=backend, remat=True)))
    x, dout = _layer_inputs()
    for name, (dims, window, backends) in LAYER_RUNS.items():
        scenarios.append((name, "llama_sep_attention", dict(
            dims=dims, cfg=_cfg(window),
            state=_attention_state(states[window]), x=x, dout=dout,
            backends=backends)))
    return R.run_world(tmp_path_factory.mktemp("llama_sep"), 4, scenarios)


def _readings(world, name):
    out = [r[name] for r in world]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o.get('error')}"
    return out


def _jax_mesh(dims):
    import jax
    from paddle_tpu.distributed.topology import build_mesh
    return build_mesh(dims, np.asarray(jax.devices())[:4])


def _ref_losses(name):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import flags
    from paddle_tpu.models.nlp.llama import llama_train_step_factory
    dims, S, backend, window = RUNS[name]
    jm, _ = _ref_model(_cfg(window))
    flags.set_flags({"context_parallel_backend": backend})
    try:
        params, opt, step, bsh = llama_train_step_factory(
            jm, _jax_mesh(dims), learning_rate=LR, remat=False)
        tokens, labels = (jax.device_put(jnp.asarray(a), bsh)
                          for a in _batch(S))
        losses = []
        for _ in range(STEPS):
            params, opt, loss = step(params, opt, tokens, labels)
            losses.append(float(loss))
    finally:
        flags.set_flags({"context_parallel_backend": "ring"})
    return losses


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    assert all(r["_loaded"] == [] for r in world)


@pytest.mark.parametrize("name", list(RUNS))
def test_sep_losses_match_the_reference(world, name):
    want = _ref_losses(name)
    for r, o in enumerate(_readings(world, name)):
        np.testing.assert_allclose(o["losses"], want, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r}")
        assert o["losses"][-1] < o["losses"][0]


@pytest.mark.parametrize("name", list(RUNS))
def test_each_layer_took_the_references_route(world, name):
    _, _, backend, window = RUNS[name]
    want = "ring_window_attention" if window else ROUTE[backend]
    for o in _readings(world, name):
        assert o["routes"] == [want] * CFG["num_hidden_layers"], name


@pytest.mark.parametrize("name", list(RUNS))
def test_parameters_stay_replicated_over_sep(world, name):
    outs = _readings(world, name)
    by_rest = {}
    for o in outs:
        key = tuple(v for a, v in o["coords"].items() if a != "sep")
        by_rest.setdefault(key, []).append(o)
    for same in by_rest.values():
        assert sorted(o["coords"]["sep"] for o in same) == \
            list(range(len(same)))
        for o in same[1:]:
            for k in o["params"]:
                np.testing.assert_array_equal(o["params"][k],
                                              same[0]["params"][k])


def test_remat_under_sep_gives_the_same_bits(world):
    """``remat=True`` re-runs each layer's forward, ring and all, inside
    the backward: the same losses and parameters, bit for bit."""
    for a, b in zip(_readings(world, "sep_data"),
                    _readings(world, "sep_data_remat")):
        assert a["losses"] == b["losses"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])


def _ref_layer_out(window, x):
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor
    jm, _ = _ref_model(_cfg(window))
    attn = jm.model.layers[0].self_attn
    return np.asarray(attn(Tensor(jnp.asarray(x)))._value)


def _port_layer(window, state, x, dout):
    from paddle_tpu_torch.models.nlp import (LlamaConfig,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.models.nlp.llama import LlamaAttention
    layer = LlamaAttention(LlamaConfig(**_cfg(window)), device="cpu")
    load_numpy_state_dict(layer, _attention_state(state))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    y.backward(torch.from_numpy(dout))
    return (y.detach().numpy(), xt.grad.numpy(),
            {k: p.grad.numpy() for k, p in layer.named_parameters()})


@pytest.mark.parametrize("name", list(LAYER_RUNS))
def test_layer_path_matches_the_reference(world, states, name):
    dims, window, backends = LAYER_RUNS[name]
    x, dout = _layer_inputs()
    want = _ref_layer_out(window, x)
    _, want_dx, want_grads = _port_layer(window, states[window], x, dout)
    n = dims["sep"]
    s = LAYER_S // n
    summed = {}
    for backend in backends:
        for o in _readings(world, name):
            i = o["sep"]
            mine = slice(i * s, (i + 1) * s)
            got = o[backend]
            np.testing.assert_allclose(got["out"], want[:, mine], **TOL)
            np.testing.assert_allclose(got["dx"], want_dx[:, mine], **TOL)
            assert o["routes"][backend] == [
                "ring_window_attention" if window else ROUTE[backend]]
            # ranks that differ only in "data" hold the same chunk
            for k, g in got["grads"].items():
                summed.setdefault((backend, k), {})[i] = g
        for k, w in want_grads.items():
            # each rank's weight gradient is its chunk's part: their sum
            # over the sep ranks is the whole sequence's
            total = sum(summed[(backend, k)].values())
            np.testing.assert_allclose(total, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)
