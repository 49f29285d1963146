"""The MoE train step and layer on a mesh (expert parallelism, global
routing over "data", ZeRO-1): the port against the JAX package.

``moe_train_step_factory(model, mesh=build_mesh(dims))`` runs in one world
of 4 gloo ranks on the CPU (``torch_dist_ranks``, started once for the
module) on {data 2, expert 2}, {expert 2, model 2} and {data 2, sharding
2} at ``MoEConfig.deepseek_tiny()`` (8 routed experts top-2 beside a
shared one, hidden 64, 4 heads), B=4 x S=16, f32, and once more on
{data 2, expert 2} with the chunked CE. Each is held against the
reference factory on the same mesh of 4 of the 8 host devices, the same
weights and the same global batch:

* the 3 losses, on every rank, within 1e-5 relative;
* each rank's parameters before the first step: bit-equal to the
  reference's ``addressable_shards[r]`` under its ``param_shardings``
  (``shard_moe_state_dict``; the experts over "expert" and "model", the
  attention and shared SwiGLU over "model");
* each MoE layer's routing in the first step: the global capacity, the
  expert ids, queue positions and keep flags of the rank's tokens equal
  to the reference's ``topk_gating_idx`` on the global batch (pairs
  dropped past the capacity included), and the aux loss within 1e-6;
* the expert shard's share of the routed weights (1/2, 1/4), the ZeRO
  moments halved, the parameters equal over the ranks that replicate
  them.

``MoELayer.distribute`` alone, on 4 ranks: every gate and dispatch form
on {data 2, expert 2} and {expert 2, model 2} against the reference's
layer on the global batch (the rank's output rows, the x and router
gradients of the data-parallel loss, the aux loss); the top-1 noise over
"data" against the port's own layer on one device (the same draw);
expert-choice routing over "data" refused by name. Then the example
``paddle_tpu_torch.examples.train_moe_ep`` at world 4.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=32,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
           num_experts=8, top_k=2, moe_every=1, num_shared_experts=1)
MESHES = {"de": {"data": 2, "expert": 2}, "em": {"expert": 2, "model": 2},
          "ds": {"data": 2, "sharding": 2}}
RUNS = {"de": ("de", None), "em": ("em", None), "ds": ("ds", None),
        "de_chunked": ("de", 64)}
B, S, STEPS, LR = 4, 16, 3, 1e-3
H, F, E = 16, 32, 8
LAYER_RUNS = {  # name: (mesh, gate, top_k, dispatch mode)
    "de_gshard_indexed": ("de", "gshard", None, "indexed"),
    "de_top4_inverted": ("de", "switch", 4, "inverted"),
    "de_gshard_einsum": ("de", "gshard", None, "einsum"),
    "de_top3_einsum": ("de", "gshard", 3, "einsum"),
    "em_gshard_indexed": ("em", "gshard", None, "indexed"),
    "em_switch_einsum": ("em", "switch", None, "einsum"),
    "em_choice_indexed": ("em", "expert_choice", None, "indexed"),
    "em_choice_einsum": ("em", "expert_choice", None, "einsum")}


def _ref_model():
    import paddle_tpu as paddle
    from paddle_tpu.models import nlp
    paddle.seed(3)
    return nlp.MoEForCausalLM(nlp.MoEConfig(**CFG))


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _batch():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, CFG["vocab_size"], (B, S + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _layer_inputs():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((4, 6, H)).astype(np.float32),
            rng.standard_normal((4, 6, H)).astype(np.float32))


def _ref_layer(gate, top_k, mode):
    import paddle_tpu as paddle
    from paddle_tpu.incubate.distributed.models import moe
    paddle.seed(0)
    return moe.MoELayer(H, F, E, gate=gate, top_k=top_k, dispatch_mode=mode)


def _jax_mesh(dims):
    import jax
    from paddle_tpu.distributed.topology import build_mesh
    return build_mesh(dims, np.asarray(jax.devices())[:4])


@pytest.fixture(scope="module")
def state():
    return _state(_ref_model())


@pytest.fixture(scope="module")
def world(tmp_path_factory, state):
    tokens, labels = _batch()
    scenarios = [(name, "moe_mesh", dict(
        dims=MESHES[mesh], cfg=CFG, state=state, tokens=tokens,
        labels=labels, steps=STEPS, lr=LR, chunked=chunked))
        for name, (mesh, chunked) in RUNS.items()]
    x, dout = _layer_inputs()
    for name, (mesh, gate, top_k, mode) in LAYER_RUNS.items():
        scenarios.append((name, "moe_layer_mesh", dict(
            dims=MESHES[mesh], d_model=H, d_hidden=F, n_experts=E,
            gate=gate, top_k=top_k, mode=mode, x=x, dout=dout,
            state=_state(_ref_layer(gate, top_k, mode)))))
    scenarios.append(("noise", "moe_layer_mesh", dict(
        dims=MESHES["de"], d_model=H, d_hidden=F, n_experts=E,
        gate="switch", top_k=None, mode="indexed", x=x, dout=dout,
        state=_state(_ref_layer("switch", None, "indexed")), train=True,
        seed=7)))
    scenarios.append(("choice_refused", "moe_expert_choice_refused",
                      dict(dims=MESHES["de"])))
    return R.start_world(tmp_path_factory.mktemp("moe_mesh"), 4, scenarios)


def _readings(world, name):
    out = [r[name] for r in world.result()]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o.get('error')}"
    return out


def _ref_losses(name):
    import jax.numpy as jnp
    from paddle_tpu.models import nlp
    mesh, chunked = RUNS[name]
    params, opt, step = nlp.moe_train_step_factory(
        _ref_model(), _jax_mesh(MESHES[mesh]), learning_rate=LR,
        chunked_vocab_ce=chunked)
    tokens, labels = (jnp.asarray(a) for a in _batch())
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def example():
    """``train_moe_ep`` at world 4 ({data 2, expert 2}, 4 steps on one
    repeated batch), started in a thread: a future of its result."""
    from concurrent.futures import ThreadPoolExecutor

    # imported in this thread: two threads importing one package at once
    # can deadlock on its module locks
    import paddle_tpu_torch.models.nlp  # noqa: F401
    from paddle_tpu_torch.examples import train_moe_ep
    pool = ThreadPoolExecutor(1)
    future = pool.submit(train_moe_ep.main, ["--data", "2", "--expert", "2",
                                             "--steps", "4", "--repeat",
                                             "--device", "cpu"])
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def refs(world, example):
    """The reference factory's losses of every run, computed while the
    world and the example run."""
    return {name: _ref_losses(name) for name in RUNS}


@pytest.fixture(scope="module")
def ref_routing(refs):
    """Each MoE layer's routing of the global batch by the reference's
    first forward (its own layers, eagerly): the capacity, expert ids,
    positions, keep flags and aux loss."""
    import paddle_tpu as paddle
    from paddle_tpu.incubate.distributed.models import moe
    model = _ref_model()
    tokens, _ = _batch()
    T = B * S
    out = []
    with paddle.no_grad():
        x = model.embed_tokens(paddle.to_tensor(tokens))
        for layer in model.layers:
            h = layer.post_attention_layernorm(
                x + layer.self_attn(layer.input_layernorm(x)))
            glt = np.asarray(layer.mlp.gate.wg(h).numpy()) \
                .reshape(T, -1).astype(np.float32)
            cap = layer.mlp.capacity(T)
            eids, pos, keep, _, aux = moe.topk_gating_idx(
                glt, cap, layer.mlp.top_k)
            out.append({"capacity": cap, "eids": np.asarray(eids),
                        "pos": np.asarray(pos), "keep": np.asarray(keep),
                        "aux": float(aux)})
            x = layer(x)
    return out


def test_ranks_import_neither_jax_nor_the_jax_package(world, refs):
    assert all(r["_loaded"] == [] for r in world.result())


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_losses_match_the_reference(world, refs, name):
    want = refs[name]
    for r, o in enumerate(_readings(world, name)):
        np.testing.assert_allclose(o["losses"], want, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r}")
        assert o["losses"][-1] < o["losses"][0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_hold_the_reference_shards(world, state, mesh):
    import jax
    from paddle_tpu.models.nlp.llama import param_shardings
    from paddle_tpu_torch.models.nlp.moe import (param_shardings as tps,
                                                 shard_moe_state_dict)
    dims = MESHES[mesh]
    jsh = param_shardings(_ref_model(), _jax_mesh(dims))
    specs = tps(type("M", (), {"state_dict": lambda self: state})(), dims)
    for k in state:
        assert specs[k] == tuple(jsh[k].spec) + (None,) * (
            len(specs[k]) - len(jsh[k].spec)), k
    for r, o in enumerate(_readings(world, mesh)):
        want = shard_moe_state_dict(state, dims, r)
        assert sorted(o["first"]) == sorted(want)
        for k, v in o["first"].items():
            ref = np.asarray(jax.device_put(state[k], jsh[k])
                             .addressable_shards[r].data)
            np.testing.assert_array_equal(want[k], ref, err_msg=(r, k))
            np.testing.assert_array_equal(v, ref, err_msg=(r, k))


@pytest.mark.parametrize("name", ["de", "em", "ds"])
def test_routing_is_the_global_batchs(world, ref_routing, name):
    """Under "data" each rank routes its rows with the global capacity
    and queues (its positions continue the earlier ranks'); the aux loss
    is the global batch's on every rank."""
    T = B * S
    dims = MESHES[RUNS[name][0]]
    n = dims.get("data", 1)
    assert any((~ref["keep"]).any() for ref in ref_routing)  # drops occur
    for r, o in enumerate(_readings(world, name)):
        row = o["coords"].get("data", 0)
        rows = slice(row * T // n, (row + 1) * T // n)
        for got, ref in zip(o["routing"], ref_routing):
            assert got["capacity"] == ref["capacity"]
            for key in ("eids", "pos", "keep"):
                np.testing.assert_array_equal(got[key], ref[key][rows],
                                              err_msg=(r, key))
        np.testing.assert_allclose(o["aux"], [x["aux"] for x in ref_routing],
                                   rtol=1e-6, atol=1e-7)


def test_expert_shards_and_zero_moments(world):
    shares = {"de": 0.5, "em": 0.25, "ds": 1.0}
    for name, share in shares.items():
        outs = _readings(world, name)
        for o in outs:
            assert o["expert_share"] == share, name
            full = sum(v.size * 4 for v in o["params"].values())
            halved = 2 if name == "ds" else 1
            assert o["moment_bytes"] * halved == full, name
        # ranks that differ only by "sharding" or "data" hold the same
        # parameters after the steps
        by_shard = {}
        for o in outs:
            key = tuple(v for a, v in o["coords"].items()
                        if a in ("expert", "model"))
            by_shard.setdefault(key, []).append(o)
        for same in by_shard.values():
            for o in same[1:]:
                for k, v in o["params"].items():
                    np.testing.assert_array_equal(v, same[0]["params"][k],
                                                  err_msg=(name, k))


@pytest.mark.parametrize("name", list(LAYER_RUNS))
def test_distributed_layer_matches_the_reference(world, name):
    """Each rank's output rows against the reference's layer on the
    global batch; the rank's loss is sum(out * dout) over its rows plus
    the aux loss, so the x gradient is the reference's of sum(out * dout)
    + n_data · aux, and the router's, summed over the data ranks, too."""
    import paddle_tpu as paddle
    mesh, gate, top_k, mode = LAYER_RUNS[name]
    dims = MESHES[mesh]
    n = dims.get("data", 1)
    x, dout = _layer_inputs()
    ref = _ref_layer(gate, top_k, mode)
    ref.eval()
    rx = paddle.to_tensor(x, stop_gradient=False)
    rout = ref(rx)
    ((rout * paddle.to_tensor(dout)).sum() + ref.aux_loss * n).backward()
    want = {"out": rout.numpy(), "dx": rx.grad.numpy()}
    outs = _readings(world, name)
    b = x.shape[0] // n
    experts = E // dims.get("expert", 1)
    cols = F // dims.get("model", 1)
    for r, o in enumerate(outs):
        assert o["shapes"] == [(experts, H, cols), (experts, cols, H)]
        row = r // 2 if n > 1 else 0
        for key in ("out", "dx"):
            np.testing.assert_allclose(o[key], want[key][row * b:(row + 1)
                                                         * b],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=(r, key))
        np.testing.assert_allclose(o["aux"], float(ref.aux_loss),
                                   rtol=1e-6, atol=1e-7)
    # {data 2, expert 2}: ranks 0, 1 hold data 0; {expert 2, model 2}:
    # every rank the whole batch
    peers = [outs[0], outs[2]] if n > 1 else [outs[0]]
    np.testing.assert_allclose(sum(o["dwg"] for o in peers),
                               ref.gate.wg.weight.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["dwg"],
                                      outs[r - r % 2 if n > 1 else 0]["dwg"])


def test_top1_noise_is_the_global_draws_rows(world):
    """In training, the switch gate's noise: each data rank's rows of the
    one (T, E) draw the layer makes on one device from the same
    generator, so the ranks' outputs are the single layer's rows."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.nn import load_numpy_state_dict
    x, _ = _layer_inputs()
    layer = MoELayer(H, F, E, gate="switch", device="cpu",
                     generator=torch.Generator().manual_seed(7))
    load_numpy_state_dict(layer, _state(_ref_layer("switch", None,
                                                   "indexed")))
    layer.train()
    with torch.no_grad():
        want = layer(torch.from_numpy(x)).numpy()
        layer.eval()
        quiet = layer(torch.from_numpy(x)).numpy()
    assert not np.allclose(want, quiet)   # the noise moves the routing
    for r, o in enumerate(_readings(world, "noise")):
        row = r // 2
        np.testing.assert_allclose(o["out"], want[row * 2:(row + 1) * 2],
                                   rtol=1e-5, atol=1e-6, err_msg=r)


def test_expert_choice_over_data_is_refused(world):
    for o in _readings(world, "choice_refused"):
        assert o["refused"] is not None and "item 15" in o["refused"] \
            and "data" in o["refused"]


def test_the_example_trains_on_an_expert_mesh(example):
    """Each rank holds half of the 16 experts; the losses (the global
    batch's) are finite and fall on the repeated batch."""
    got = example.result()
    assert got["shard_fraction"] == 0.5
    losses = got["losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert all(b < a for a, b in zip(losses, losses[1:]))


def test_the_example_defaults_to_the_card():
    """Without ``--device`` the example runs on the card: with none it
    raises before it starts a rank."""
    from paddle_tpu_torch.examples import train_moe_ep
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_moe_ep.main(["--data", "1", "--expert", "2"])
