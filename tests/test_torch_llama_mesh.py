"""The Llama train step on a mesh: the port against the JAX package.

``llama_train_step_factory(model, mesh=build_mesh(dims))`` runs in one
world of 4 gloo ranks on the CPU (``torch_dist_ranks``, started once for
the module) on {data 2, model 2}, {data 2, sharding 2} and {model 2,
sharding 2} at a tiny f32 config (2 layers, hidden 256, 4 / 2 heads,
head_dim 64, S=256: the grouped flash path's plain version on each rank's
heads), and on {data 2, model 2} at a fused-projection config whose one kv
head does not divide the model axis (the kv projections gathered, each
rank reading the head its query heads use). Each is held against the
reference factory on the same mesh of 4 of the 8 host devices, the same
weights and the same batch:

* the 3 losses, on every rank, within 1e-5 relative (parameters after
  AdamW are not compared: its first steps take the sign of gradients as
  small as f32 noise);
* each rank's parameters before the first step: bit-equal to the
  converter's shards (``shard_llama_state_dict``), which are bit-equal to
  the reference's ``addressable_shards[r]`` under its ``param_shardings``
  except for the fused keys, cut by component (the rank's q, k and v
  columns side by side; the test cuts each component as the reference
  shards it);
* ZeRO-1: under "sharding" each rank keeps half of every moment; the
  parameters stay equal over the sharding ranks; moments in host memory
  (``offload_moments``) give the same losses bit for bit;
* the attention ran on the rank's heads (``pallas_sharding.ENGAGED``);
* the refusals: "pipe" above 1 and ``chunked_vocab_ce`` with a model
  axis ("sep" trains: ``test_torch_llama_sep.py``).
"""
import types

import numpy as np
import pytest
import torch

import torch_dist_ranks as R

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=512,
           dtype=torch.float32)
FUSED = dict(CFG, hidden_size=128, intermediate_size=256,
             num_attention_heads=2, num_key_value_heads=1,
             fuse_attention_qkv=True, fuse_ffn_gate_up=True)
B, S, STEPS, LR = 4, 256, 3, 1e-3
MESHES = {"dm": {"data": 2, "model": 2}, "ds": {"data": 2, "sharding": 2},
          "ms": {"model": 2, "sharding": 2}}
RUNS = {"dm": ("dm", CFG), "ds": ("ds", CFG), "ms": ("ms", CFG),
        "dm_fused": ("dm", FUSED)}


def _ref_config(cfg):
    import jax.numpy as jnp
    from paddle_tpu.models.nlp import LlamaConfig as JConfig
    kw = {k: v for k, v in cfg.items() if k != "dtype"}
    return JConfig(**kw, dtype=jnp.float32)


def _ref_model(cfg, seed=0):
    import paddle_tpu as paddle
    from paddle_tpu.models.nlp import LlamaForCausalLM as JLlama
    paddle.seed(seed)
    jm = JLlama(_ref_config(cfg))
    return jm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32),
            rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32))


def _jax_mesh(dims):
    import jax
    from paddle_tpu.distributed.topology import build_mesh
    return build_mesh(dims, np.asarray(jax.devices())[:4])


@pytest.fixture(scope="module")
def states():
    return {"CFG": _ref_model(CFG)[1], "FUSED": _ref_model(FUSED)[1]}


@pytest.fixture(scope="module")
def world(tmp_path_factory, states):
    tokens, labels = _batch()
    scenarios = []
    for name, (mesh, cfg) in RUNS.items():
        state = states["FUSED" if cfg is FUSED else "CFG"]
        scenarios.append((name, "llama_mesh", dict(
            dims=MESHES[mesh], cfg=cfg, state=state, tokens=tokens,
            labels=labels, steps=STEPS, lr=LR)))
    scenarios.append(("ds_offload", "llama_mesh", dict(
        dims=MESHES["ds"], cfg=CFG, state=states["CFG"], tokens=tokens,
        labels=labels, steps=STEPS, lr=LR, offload=True)))
    return R.run_world(tmp_path_factory.mktemp("llama_mesh"), 4, scenarios)


def _readings(world, name):
    out = [r[name] for r in world]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o.get('error')}"
    return out


def _ref_losses(name):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models.nlp.llama import llama_train_step_factory
    mesh, cfg = RUNS[name]
    jm, _ = _ref_model(cfg)
    params, opt, step, bsh = llama_train_step_factory(
        jm, _jax_mesh(MESHES[mesh]), learning_rate=LR, remat=False)
    tokens, labels = (jax.device_put(jnp.asarray(a), bsh) for a in _batch())
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    return losses


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    assert all(r["_loaded"] == [] for r in world)


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_losses_match_the_reference(world, name):
    want = _ref_losses(name)
    for r, o in enumerate(_readings(world, name)):
        np.testing.assert_allclose(o["losses"], want, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r}")
        assert o["losses"][-1] < o["losses"][0]


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_hold_the_converters_shards(world, states, name):
    from paddle_tpu_torch.models.nlp.llama import shard_llama_state_dict
    from paddle_tpu_torch.models.nlp import LlamaConfig
    mesh, cfg = RUNS[name]
    state = states["FUSED" if cfg is FUSED else "CFG"]
    for r, o in enumerate(_readings(world, name)):
        want = shard_llama_state_dict(LlamaConfig(**cfg), state,
                                      MESHES[mesh], r)
        assert list(o["first"]) == list(want)
        for k, v in want.items():
            np.testing.assert_array_equal(o["first"][k], v, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fused", [False, True])
def test_converter_matches_the_reference_shards(mesh, fused):
    """Bit-equal to ``addressable_shards[r].data`` under the reference's
    ``param_shardings``; a fused key cut by component: each component's
    reference shard, side by side. Deliberate (ROADMAP Queue 3): the
    reference's device holds a contiguous block of the fused columns,
    which mixes q and k; a rank of the port holds whole heads."""
    import jax
    from paddle_tpu.models.nlp.llama import param_shardings
    from paddle_tpu_torch.models.nlp import LlamaConfig
    from paddle_tpu_torch.models.nlp.llama import (param_shardings as tps,
                                                   shard_llama_state_dict)
    cfg = FUSED if fused else CFG
    jm, state = _ref_model(cfg)
    dims = MESHES[mesh]
    jsh = param_shardings(jm, _jax_mesh(dims))
    tcfg = LlamaConfig(**cfg)
    specs = tps(types.SimpleNamespace(state_dict=lambda: state), dims)
    widths = {"self_attn.qkv_proj.weight": (128, 64, 64),
              "mlp.gate_up_proj.weight": (256, 256)}
    for k in state:
        assert specs[k] == tuple(jsh[k].spec) + (None,) * (
            len(specs[k]) - len(jsh[k].spec)), k
    for r in range(4):
        got = shard_llama_state_dict(tcfg, state, dims, r)
        for k, v in state.items():
            split = next((w for key, w in widths.items()
                          if k.endswith(key)), None)
            if split is None or "model" not in dims:
                want = np.asarray(jax.device_put(v, jsh[k])
                                  .addressable_shards[r].data)
            else:
                parts = np.split(v, np.cumsum(split)[:-1], axis=1)
                want = np.concatenate(
                    [np.asarray(jax.device_put(p, jsh[k])
                                .addressable_shards[r].data) for p in parts],
                    axis=1)
            np.testing.assert_array_equal(got[k], want, err_msg=(r, k))


def test_zero_moments_are_halved_and_params_stay_replicated(world):
    for name, shard_n in (("ds", 2), ("ms", 2)):
        outs = _readings(world, name)
        for o in outs:
            full = sum(np.prod(v.shape) * 4 for v in o["params"].values())
            assert o["moment_bytes"] * shard_n == full, name
        by_rest = {}
        for o in outs:
            key = tuple(v for a, v in o["coords"].items() if a != "sharding")
            by_rest.setdefault(key, []).append(o)
        for same in by_rest.values():
            for k in same[0]["params"]:
                np.testing.assert_array_equal(same[0]["params"][k],
                                              same[1]["params"][k])


def test_offloaded_moments_give_the_same_bits(world):
    for a, b in zip(_readings(world, "ds"), _readings(world, "ds_offload")):
        assert a["losses"] == b["losses"]
        assert a["moment_shapes"] == b["moment_shapes"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_attention_ran_on_the_local_heads(world):
    for name, heads in (("dm", (2, 1)), ("ms", (2, 1)), ("dm_fused", (1, 1)),
                        ("ds", None)):
        for o in _readings(world, name):
            assert o["engaged"]["flag"] == (heads is not None), name
            assert (tuple(o["engaged"]["heads"]) if heads else None) == heads


def test_unported_axes_and_options_are_refused():
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.nlp.llama import (llama_train_step_factory,
                                                   set_context_parallel_mesh)
    tied = LlamaConfig(**dict(CFG, tie_word_embeddings=True))
    model = LlamaForCausalLM(tied, device="cpu")
    fake = types.SimpleNamespace(shape={"data": 1, "pipe": 2},
                                 axis_names=("data", "pipe"))
    with pytest.raises(NotImplementedError, match="item 15"):
        llama_train_step_factory(model, mesh=fake, device="cpu")
    fake = types.SimpleNamespace(shape={"model": 2}, axis_names=("model",))
    with pytest.raises(ValueError, match="chunked_vocab_ce"):
        llama_train_step_factory(model, mesh=fake, device="cpu",
                                 chunked_vocab_ce=64)
    # a context-parallel mesh is taken (ring / Ulysses attention,
    # test_torch_llama_sep.py)
    set_context_parallel_mesh(types.SimpleNamespace(shape={"sep": 2}))
    set_context_parallel_mesh(None)


def test_zero_like_sharded_matches_the_reference_shards():
    """Each rank's moment buffer has the shape of the reference's moment
    shard on the same device: the largest free dimension of the full
    parameter that "sharding" divides, after the model split."""
    import jax
    from paddle_tpu.models.nlp.llama import param_shardings
    from paddle_tpu.models.nlp.train_utils import \
        zero_like_sharded as jzero
    from paddle_tpu_torch.distributed.topology import coords_of
    from paddle_tpu_torch.models.nlp import LlamaConfig
    from paddle_tpu_torch.models.nlp.llama import (param_shardings as tps,
                                                   shard_llama_state_dict)
    from paddle_tpu_torch.models.nlp.train_utils import zero_like_sharded

    jm, state = _ref_model(CFG)
    for dims in (MESHES["ms"], MESHES["ds"]):
        jmesh = _jax_mesh(dims)
        jsh = param_shardings(jm, jmesh)
        specs = tps(types.SimpleNamespace(state_dict=lambda: state), dims)
        for r in range(4):
            coords = coords_of(dims, r)
            mesh = types.SimpleNamespace(shape=dims,
                                         coordinate=coords.__getitem__)
            shards = shard_llama_state_dict(LlamaConfig(**CFG), state, dims,
                                            r)
            for k, v in state.items():
                want = jzero(jmesh, jsh, k, jax.numpy.asarray(v))
                got = zero_like_sharded(mesh, specs, k,
                                        torch.from_numpy(np.array(shards[k])))
                assert tuple(got.shape) == \
                    want.addressable_shards[r].data.shape, (dims, r, k)


def test_local_heads_cover_every_query_head():
    """Each rank's query heads read the kv heads the whole model's do:
    split kv heads where they divide the axis, else the gathered ones by
    index (one a local group, or one a query head where the groups do
    not line up); a query count that does not divide raises."""
    from paddle_tpu_torch.parallel import local_heads
    for nh, nkv, n in ((32, 8, 2), (4, 1, 2), (6, 2, 3), (12, 3, 2),
                       (8, 8, 4)):
        for r in range(n):
            h = local_heads(nh, nkv, n, r)
            assert h.q_count * n == nh and h.q_start == r * h.q_count
            g = h.q_count // h.kv_count
            for i in range(h.q_count):
                kv = (h.kv_start + i // g if h.kv_index is None
                      else h.kv_index[i // g])
                assert kv == (h.q_start + i) // (nh // nkv), (nh, nkv, n, r)
    with pytest.raises(ValueError, match="do not divide"):
        local_heads(6, 2, 4, 0)
