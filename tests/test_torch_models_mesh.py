"""The BERT, GPT and ResNet train steps on a mesh, and ``nn.SyncBatchNorm``:
the port against the JAX package.

``bert_pretrain_step_factory``, ``gpt_pretrain_step_factory`` and
``resnet_train_step_factory`` with ``mesh=build_mesh(dims)`` run in one
world of 4 gloo ranks on the CPU (``torch_dist_ranks``, started once for
the module) on {data 2, sharding 2} and {data 4}, at small f32 configs
(BERT: 2 layers, hidden 128, S=32; GPT ``tiny()``, S=16; a two-block
ResNet of widths 16 and 32 at 32 x 32, batch norms in every block). Each
is held against the reference factory on the same mesh of 4 of the 8
host devices, the same weights and the same global batch:

* the 3 losses, on every rank, within 1e-5 relative;
* each rank's parameters before the first step: bit-equal to the
  reference's ``addressable_shards[r]`` (every parameter replicated);
* ZeRO-1 under "sharding": each rank keeps half of every moment, and the
  parameters stay equal over the ranks;
* BERT's masked mean is the global batch's: the ranks' rows hold
  different counts of masked tokens, where the mean of the ranks' own
  losses is checked to miss the reference's;
* ResNet's batch norms take the global batch's statistics: its running
  buffers after 3 steps within 1e-5 of the reference's, equal on every
  rank;
* two data ranks draw different dropout masks, the ranks of one data
  coordinate the same ones, and remat replays them;
* ``nn.SyncBatchNorm`` over the world, and a ``BatchNorm2D`` over a mesh
  axis as the ResNet step syncs it, against the
  reference's ``BatchNorm2D`` on the global batch (output, gradients,
  running statistics), ``BatchNorm`` outside a group, and
  ``convert_sync_batchnorm``.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R

BERT_SMALL = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=512,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  max_position_embeddings=256)
GPT_TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128, dropout=0.0)
MESHES = {"ds": {"data": 2, "sharding": 2}, "d4": {"data": 4}}
KINDS = ("bert", "gpt", "resnet")
B, STEPS, LR = 8, 3, 1e-3
S = {"bert": 32, "gpt": 16}
# each row's share of masked tokens: every data rank's rows hold a
# different count
MASKED = (0.5, 0.5, 0.3, 0.3, 0.1, 0.1, 0.05, 0.05)
RUNS = [(kind, mesh) for kind in KINDS for mesh in MESHES]


def _ref_model(kind):
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.models import nlp
    from paddle_tpu.vision.models.resnet import BasicBlock
    paddle.seed(11)
    if kind == "bert":
        model = nlp.BertForPretraining(nlp.BertConfig(**BERT_SMALL))
        model.eval()
    elif kind == "gpt":
        model = nlp.gpt.GPTForCausalLM(nlp.gpt.GPTConfig(**GPT_TINY))
    else:
        model = R.small_resnet(nn, BasicBlock)
    return model


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _batch(kind):
    rng = np.random.default_rng(7)
    if kind == "resnet":
        return (rng.standard_normal((B, 3, 32, 32)).astype(np.float32),
                rng.integers(0, 10, (B,)).astype(np.int32))
    V = (BERT_SMALL if kind == "bert" else GPT_TINY)["vocab_size"]
    ids = rng.integers(0, V, (B, S[kind])).astype(np.int32)
    if kind == "gpt":
        return ids, rng.integers(0, V, (B, S[kind])).astype(np.int32)
    types = np.zeros_like(ids)
    types[:, S[kind] // 2:] = 1
    masked = rng.random(ids.shape) < np.asarray(MASKED)[:, None]
    mlm = np.where(masked, rng.integers(0, V, ids.shape), -100) \
        .astype(np.int32)
    return ids, types, mlm, rng.integers(0, 2, (B,)).astype(np.int32)


def _jax_mesh(dims):
    import jax
    from paddle_tpu.distributed.topology import build_mesh
    return build_mesh(dims, np.asarray(jax.devices())[:4])


@pytest.fixture(scope="module")
def states():
    return {kind: _state(_ref_model(kind)) for kind in KINDS}


@pytest.fixture(scope="module")
def world(tmp_path_factory, states):
    scenarios = [(f"{kind}_{mesh}", "models_mesh", dict(
        kind=kind, dims=MESHES[mesh],
        cfg=BERT_SMALL if kind == "bert" else GPT_TINY,
        state=states[kind], batch=_batch(kind), steps=STEPS, lr=LR))
        for kind, mesh in RUNS]
    scenarios.append(("dropout", "bert_dropout_masks", dict(
        dims=MESHES["ds"], cfg=dict(BERT_SMALL, hidden_dropout_prob=0.1))))
    x, dout, w, b = _bn_inputs()
    scenarios.append(("sync_bn", "sync_batch_norm", dict(
        x=x, dout=dout, weight=w, bias=b)))
    scenarios.append(("sync_bn_data", "sync_batch_norm", dict(
        x=x, dout=dout, weight=w, bias=b, group_of="data")))
    return R.start_world(tmp_path_factory.mktemp("models_mesh"), 4,
                         scenarios)


def _readings(world, name):
    out = [r[name] for r in world.result()]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o.get('error')}"
    return out


def _ref_run(kind, mesh):
    """The reference factory's losses and, for ResNet, buffers."""
    import jax.numpy as jnp
    from paddle_tpu.models import nlp
    from paddle_tpu.vision.models.resnet import resnet_train_step_factory
    model = _ref_model(kind)
    jmesh = _jax_mesh(MESHES[mesh])
    batch = [jnp.asarray(a) for a in _batch(kind)]
    losses = []
    if kind == "resnet":
        params, buffers, opt, step = resnet_train_step_factory(
            model, jmesh, learning_rate=LR)
        for _ in range(STEPS):
            params, buffers, opt, loss = step(params, buffers, opt, *batch)
            losses.append(float(loss))
        return losses, {k: np.asarray(v) for k, v in buffers.items()}
    make = nlp.bert_pretrain_step_factory if kind == "bert" \
        else nlp.gpt.gpt_pretrain_step_factory
    params, opt, step = make(model, jmesh, learning_rate=LR)
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, *batch)
        losses.append(float(loss))
    return losses, None


@pytest.fixture(scope="module")
def refs(world):
    """The reference runs, computed while the world runs."""
    return {run: _ref_run(*run) for run in RUNS}


def test_ranks_import_neither_jax_nor_the_jax_package(world, refs):
    assert all(r["_loaded"] == [] for r in world.result())


@pytest.mark.parametrize("kind,mesh", RUNS)
def test_mesh_losses_match_the_reference(world, refs, kind, mesh):
    want, _ = refs[(kind, mesh)]
    for r, o in enumerate(_readings(world, f"{kind}_{mesh}")):
        np.testing.assert_allclose(o["losses"], want, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r}")
        assert o["losses"][-1] < o["losses"][0]


@pytest.mark.parametrize("kind,mesh", RUNS)
def test_ranks_hold_the_reference_shards(world, states, kind, mesh):
    """Every parameter replicated, as the reference places it: each
    rank's before the first step is the reference's
    ``addressable_shards[r]`` bit for bit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from paddle_tpu.models.nlp.llama import param_shardings
    model = _ref_model(kind)
    jmesh = _jax_mesh(MESHES[mesh])
    jsh = param_shardings(model, jmesh) if kind != "resnet" else \
        {k: NamedSharding(jmesh, P()) for k in states[kind]}
    for r, o in enumerate(_readings(world, f"{kind}_{mesh}")):
        assert sorted(o["first"]) == sorted(
            k for k in states[kind] if not k.endswith(("_mean",
                                                       "_variance")))
        for k, v in o["first"].items():
            assert tuple(jsh[k].spec) == (), k
            want = np.asarray(jax.device_put(states[kind][k], jsh[k])
                              .addressable_shards[r].data)
            np.testing.assert_array_equal(v, want, err_msg=(r, k))


def test_zero_moments_are_halved_and_params_stay_replicated(world):
    for kind in ("bert", "gpt"):
        for mesh, shard_n in (("ds", 2), ("d4", 1)):
            outs = _readings(world, f"{kind}_{mesh}")
            for o in outs:
                full = sum(v.size * 4 for v in o["params"].values())
                assert o["moment_bytes"] * shard_n == full, (kind, mesh)
            for o in outs[1:]:
                for k, v in o["params"].items():
                    np.testing.assert_array_equal(v, outs[0]["params"][k],
                                                  err_msg=(kind, mesh, k))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_bert_takes_the_global_masked_mean(world, refs, mesh):
    """The data ranks' rows hold different counts of masked tokens
    (``MASKED``): the mean of the ranks' own losses misses the global
    masked mean by far more than the tolerance, and the step's loss is
    the reference's."""
    outs = _readings(world, f"bert_{mesh}")
    ids, types, mlm, nsp = _batch("bert")
    n = MESHES[mesh]["data"]
    counts = [(mlm[r * B // n:(r + 1) * B // n] != -100).sum()
              for r in range(n)]
    assert len(set(counts)) == n
    own = {o["coords"]["data"]: o["own_first"] for o in outs}
    per_rank_mean = np.mean([own[r] for r in range(n)])
    want = refs[("bert", mesh)][0][0]
    assert abs(per_rank_mean - want) / want > 1e-3
    for o in outs:
        np.testing.assert_allclose(o["losses"][0], want, rtol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resnet_buffers_are_the_global_batchs(world, refs, mesh):
    _, want = refs[("resnet", mesh)]
    outs = _readings(world, f"resnet_{mesh}")
    for r, o in enumerate(outs):
        assert sorted(o["buffers"]) == sorted(want)
        for k, v in o["buffers"].items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=(r, k))
            np.testing.assert_array_equal(v, outs[0]["buffers"][k])


def test_data_ranks_draw_their_own_dropout(world):
    outs = _readings(world, "dropout")
    masks = [o["mask"] for o in outs]
    # {data 2, sharding 2}: ranks 0, 1 at data 0 and ranks 2, 3 at data 1
    np.testing.assert_array_equal(masks[0], masks[1])
    np.testing.assert_array_equal(masks[2], masks[3])
    assert not np.array_equal(masks[0], masks[2])
    for o in outs:
        assert 0 < o["mask"].mean() < 1
        assert o["losses_remat0"] == o["losses_remat1"]
        assert o["losses_remat0"][1] != o["losses_remat0"][0]
    assert outs[0]["losses_remat0"] == outs[3]["losses_remat0"]


# --- nn.SyncBatchNorm -------------------------------------------------------

def _bn_inputs():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((8, 6, 5, 5)).astype(np.float32) * 2 + 1,
            rng.standard_normal((8, 6, 5, 5)).astype(np.float32),
            rng.uniform(0.5, 1.5, 6).astype(np.float32),
            rng.standard_normal(6).astype(np.float32))


def _ref_bn(x, dout, w, b):
    """The reference's ``BatchNorm2D`` in training on the whole batch:
    output, the gradients of sum(out * dout) and the running
    statistics."""
    import paddle_tpu as paddle
    from paddle_tpu import nn
    layer = nn.BatchNorm2D(x.shape[1])
    layer.weight.set_value(paddle.to_tensor(w))
    layer.bias.set_value(paddle.to_tensor(b))
    layer.train()
    xt = paddle.to_tensor(x, stop_gradient=False)
    y = layer(xt)
    (y * paddle.to_tensor(dout)).sum().backward()
    return {"out": y.numpy(), "dx": xt.grad.numpy(),
            "dw": layer.weight.grad.numpy(), "db": layer.bias.grad.numpy(),
            "mean": layer._mean.numpy(), "var": layer._variance.numpy()}


@pytest.mark.parametrize("name", ["sync_bn", "sync_bn_data"])
def test_sync_batch_norm_is_the_global_batchs(world, name):
    """Each rank holds its rows of the batch (over the world, or over the
    "data" axis of {data 2, sharding 2}, whose sharding peers hold the
    same rows): its output and x gradient are the reference's rows on the
    whole batch, the weight and bias gradients sum over the group's ranks
    to the reference's, and the running statistics are the reference's
    on every rank."""
    want = _ref_bn(*_bn_inputs())
    outs = _readings(world, name)
    group = list(range(4)) if name == "sync_bn" else [0, 2]
    for key in ("out", "dx"):
        got = np.concatenate([outs[r][key] for r in group])
        np.testing.assert_allclose(got, want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    for key in ("dw", "db"):
        np.testing.assert_allclose(sum(outs[r][key] for r in group),
                                   want[key], rtol=1e-5, atol=1e-4,
                                   err_msg=key)
    for o in outs:
        for key in ("mean", "var"):
            np.testing.assert_allclose(o[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_array_equal(o[key], outs[0][key])


def test_sync_batch_norm_outside_a_group_is_batch_norm():
    from paddle_tpu_torch import nn
    x, dout, w, b = (torch.from_numpy(a) for a in _bn_inputs())
    runs = []
    for cls in (nn.BatchNorm2D, nn.SyncBatchNorm):
        layer = cls(6, device="cpu")
        with torch.no_grad():
            layer.weight.copy_(w)
            layer.bias.copy_(b)
        xi = x.clone().requires_grad_(True)
        y = layer(xi)
        (y * dout).sum().backward()
        runs.append((y, xi.grad, layer.weight.grad, layer._mean,
                     layer._variance))
        layer.eval()
        runs[-1] += (layer(x),)
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_convert_sync_batchnorm_copies_weights_and_statistics():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models.resnet import BasicBlock
    model = R.small_resnet(nn, BasicBlock, device="cpu").to(torch.bfloat16)
    x = torch.randn(4, 3, 32, 32, dtype=torch.bfloat16)
    model(x)                            # the running statistics move
    model.eval()
    want = model(x)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    converted = nn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert converted is model
    norms = [m for m in model.modules()
             if isinstance(m, nn.layer.norm._BatchNormBase)]
    assert len(norms) == 6
    assert all(type(m) is nn.SyncBatchNorm for m in norms)
    assert not any(m.training for m in norms)
    after = model.state_dict()
    assert list(after) == list(before)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
    assert torch.equal(model(x), want)
    single = nn.BatchNorm2D(3, device="cpu")
    new = nn.SyncBatchNorm.convert_sync_batchnorm(single)
    assert type(new) is nn.SyncBatchNorm and new is not single
    assert nn.SyncBatchNorm.convert_sync_batchnorm(new) is new
