"""fleet's collective path of the port against the JAX package.

One world of 4 gloo ranks on the CPU (data 2 x model 2 through
``fleet.init``; ``torch_dist_ranks``) runs the scenarios once for the
module:

* the model-parallel layers at tp = 2 (``ColumnParallelLinear`` with and
  without ``gather_output``, ``RowParallelLinear`` with and without
  ``input_is_parallel``, ``VocabParallelEmbedding``,
  ``ParallelCrossEntropy`` with an ignored label), loaded with full
  weights through ``TensorParallel.set_state_dict``: outputs, input and
  weight gradients against the reference's layers (full weights, the
  reference's tape) with the global mesh {model: 2} set, each rank's
  weight gradient against its block of the reference's; the state dict
  gathered back whole under the reference's keys and specs;
* ``fleet.init`` -> ``distributed_model`` -> ``distributed_optimizer`` on
  a Column -> tanh -> Row MLP: 2 SGD steps with a global-norm clip that
  engages, each data rank its half of the batch, against the reference
  model on the whole batch in one process (losses, then the full
  parameters);
* the model-parallel random state: alike over data ranks, apart over
  model ranks.

Tolerance: f32 1e-5 relative (orders of sums only).
"""
import numpy as np
import pytest

import torch_dist_ranks as R

RTOL, ATOL = 1e-5, 1e-6


def _inputs():
    rng = np.random.default_rng(3)
    f = np.float32
    layers = dict(
        w_col=rng.standard_normal((16, 8)).astype(f),
        b_col=rng.standard_normal(8).astype(f),
        w_row=rng.standard_normal((8, 6)).astype(f),
        b_row=rng.standard_normal(6).astype(f),
        table=rng.standard_normal((32, 4)).astype(f),
        x=rng.standard_normal((4, 16)).astype(f),
        dy_col=rng.standard_normal((4, 8)).astype(f),
        dy_row=rng.standard_normal((4, 6)).astype(f),
        ids=np.array([[1, 20, 31], [16, 15, 0]]),
        logits=rng.standard_normal((5, 32)).astype(f),
        labels=np.array([1, 31, -100, 16, 0]))
    mlp = dict(state={"fc1.weight": (rng.standard_normal((16, 32)) * .3)
                      .astype(f),
                      "fc1.bias": rng.standard_normal(32).astype(f),
                      "fc2.weight": (rng.standard_normal((32, 16)) * .3)
                      .astype(f),
                      "fc2.bias": rng.standard_normal(16).astype(f)},
               x=rng.standard_normal((8, 16)).astype(f),
               y=rng.standard_normal((8, 16)).astype(f), steps=2, lr=0.1,
               clip=0.5)
    return layers, mlp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    layers, mlp = _inputs()
    ranks = R.run_world(tmp_path_factory.mktemp("fleet"), 4,
                        [("mp_layers", "mp_layers", layers),
                         ("fleet_mlp", "fleet_mlp", mlp),
                         ("rng", "rng_tracker", {})])
    return {"ranks": ranks, "layers": layers, "mlp": mlp}


def _readings(world, name):
    out = [r[name] for r in world["ranks"]]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o.get('error')}"
    return out


@pytest.fixture(scope="module")
def reference(world):
    """The reference's layers on the full weights, {model: 2} as the
    global mesh: outputs and gradients through its tape."""
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.distributed import topology as jtopo
    from paddle_tpu.distributed.fleet import meta_parallel as mpu

    a = world["layers"]
    prev = jtopo.get_global_mesh()
    jtopo.set_global_mesh(jtopo.build_mesh({"model": 2},
                                           np.asarray(jax.devices())[:2]))
    out = {}
    try:
        def run(layer, state, inp, dy):
            layer.set_state_dict({k: paddle.to_tensor(v)
                                  for k, v in state.items()})
            x = paddle.to_tensor(inp, stop_gradient=False)
            y = layer(x)
            (y * paddle.to_tensor(dy)).sum().backward()
            return {"y": y.numpy(), "dx": x.grad.numpy(),
                    "grads": {k: p.grad.numpy()
                              for k, p in layer.named_parameters()},
                    "state": {k: v.numpy()
                              for k, v in layer.state_dict().items()},
                    "specs": {k: tuple(p.sharding_spec)
                              if p.sharding_spec is not None else None
                              for k, p in layer.named_parameters()}}

        col = {"weight": a["w_col"], "bias": a["b_col"]}
        out["col"] = run(mpu.ColumnParallelLinear(16, 8), col, a["x"],
                         a["dy_col"])
        h = np.tanh(a["x"] @ a["w_col"])
        out["row"] = run(mpu.RowParallelLinear(8, 6),
                         {"weight": a["w_row"], "bias": a["b_row"]}, h,
                         a["dy_row"])
        emb = mpu.VocabParallelEmbedding(32, 4)
        emb.set_state_dict({"weight": paddle.to_tensor(a["table"])})
        y = emb(paddle.to_tensor(a["ids"]))
        y.sum().backward()
        out["emb"] = {"y": y.numpy(), "grad": emb.weight.grad.numpy()}
        lg = paddle.to_tensor(a["logits"], stop_gradient=False)
        loss = mpu.ParallelCrossEntropy()(lg, paddle.to_tensor(a["labels"]))
        loss.sum().backward()
        out["ce"] = {"loss": loss.numpy(), "dlogits": lg.grad.numpy()}
    finally:
        jtopo.set_global_mesh(prev)
    return out


def _block(a, r, axis, n=2):
    return np.split(a, n, axis=axis)[r]


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    assert all(r["_loaded"] == [] for r in world["ranks"])


@pytest.mark.parametrize("case", ["col_gather", "col_local"])
def test_column_parallel_linear(world, reference, case):
    """Deliberate (ROADMAP Queue 3): ``gather_output=False`` leaves each
    rank its columns, which the reference's GSPMD layer does not read."""
    want = reference["col"]
    for o in _readings(world, "mp_layers"):
        r = o["mp_rank"]
        got = o[case]
        y = want["y"] if case == "col_gather" else _block(want["y"], r, -1)
        np.testing.assert_allclose(got["y"], y, rtol=RTOL, atol=ATOL)
        # the input's gradient is summed over the model group (c_identity)
        np.testing.assert_allclose(got["dx"], want["dx"], rtol=RTOL,
                                   atol=ATOL)
        for k, axis in (("weight", 1), ("bias", 0)):
            np.testing.assert_allclose(got["grads"][k],
                                       _block(want["grads"][k], r, axis),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(got["full_state"][k],
                                          want["state"][k])
        assert got["specs"] == {"weight": (None, "model"),
                                "bias": ("model",)} == want["specs"]


@pytest.mark.parametrize("case", ["row_full", "row_parallel"])
def test_row_parallel_linear(world, reference, case):
    """Deliberate (ROADMAP Queue 3): ``input_is_parallel=True`` takes each
    rank's columns of the input, which the reference's layer does not
    read."""
    want = reference["row"]
    for o in _readings(world, "mp_layers"):
        r = o["mp_rank"]
        got = o[case]
        np.testing.assert_allclose(got["y"], want["y"], rtol=RTOL, atol=ATOL)
        dx = want["dx"] if case == "row_full" else _block(want["dx"], r, -1)
        np.testing.assert_allclose(got["dx"], dx, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["grads"]["weight"],
                                   _block(want["grads"]["weight"], r, 0),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["grads"]["bias"],
                                   want["grads"]["bias"], rtol=RTOL,
                                   atol=ATOL)
        assert got["specs"] == {"weight": ("model", None), "bias": None} \
            == want["specs"]


def test_layers_from_one_seed_hold_the_slices_of_the_whole(world):
    for o in _readings(world, "mp_layers"):
        assert o["seeded"] == {"column": True, "row": True,
                               "embedding": True}


def test_vocab_parallel_embedding(world, reference):
    want = reference["emb"]
    for o in _readings(world, "mp_layers"):
        np.testing.assert_array_equal(o["embedding"]["y"], want["y"])
        np.testing.assert_array_equal(o["embedding"]["grad"],
                                      _block(want["grad"], o["mp_rank"], 0))


def test_parallel_cross_entropy(world, reference):
    want = reference["ce"]
    for o in _readings(world, "mp_layers"):
        got = o["cross_entropy"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["dlogits"],
                                   _block(want["dlogits"], o["mp_rank"], -1),
                                   rtol=RTOL, atol=ATOL)
        assert got["loss"][2, 0] == 0.0        # the ignored label


def test_fleet_hybrid_training_matches_one_process(world):
    """2 SGD steps, the clip engaging, against the reference model on the
    whole batch. Deliberate (ROADMAP Queue 3): the port's
    ``HybridParallelClipGrad`` sums the split parameters' squares over the
    model group and the replicated ones once, the norm of the whole model
    that the reference's single process clips by; the reference's would
    count each replicated parameter once a model rank in a run of several
    processes."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu import nn, optimizer
    from paddle_tpu.distributed.fleet import meta_parallel as mpu

    m = world["mlp"]

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = mpu.ColumnParallelLinear(16, 32, gather_output=False)
            self.fc2 = mpu.RowParallelLinear(32, 16, input_is_parallel=True)

        def forward(self, x):
            return self.fc2(paddle.tanh(self.fc1(x)))

    net = MLP()
    net.set_state_dict({k: paddle.to_tensor(v)
                        for k, v in m["state"].items()})
    opt = optimizer.SGD(learning_rate=m["lr"], parameters=net.parameters(),
                        grad_clip=nn.ClipGradByGlobalNorm(m["clip"]))
    x, y = paddle.to_tensor(m["x"]), paddle.to_tensor(m["y"])
    losses, norms = [], []
    for _ in range(m["steps"]):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        norms.append(float(jnp.sqrt(sum(jnp.sum(p.grad._value ** 2)
                                        for p in net.parameters()))))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert min(norms) > m["clip"]           # the clip engaged
    want = {k: v.numpy() for k, v in net.state_dict().items()}
    outs = _readings(world, "fleet_mlp")
    for o in outs:
        assert (o["wrapper"], o["optimizer"]) == ("TensorParallel",
                                                  "HybridParallelOptimizer")
        for k, v in want.items():
            np.testing.assert_allclose(o["state"][k], v, rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    # each data rank's loss is its half's; their mean is the batch's
    by_dp = {}
    for o in outs:
        by_dp.setdefault(o["worker"][0] // 2, o["losses"])
    np.testing.assert_allclose(np.mean([by_dp[0], by_dp[1]], axis=0),
                               losses, rtol=RTOL)
    assert [o["worker"] for o in outs] == [(r, 4, r == 0) for r in range(4)]


def test_model_parallel_rng_differs_over_model_ranks_only(world):
    outs = _readings(world, "rng")
    by = {(o["dp_rank"], o["mp_rank"]): o for o in outs}
    for o in outs:
        np.testing.assert_array_equal(o["plain"], outs[0]["plain"])
    for dp in (0, 1):
        assert not np.array_equal(by[(dp, 0)]["local"], by[(dp, 1)]["local"])
    for mp in (0, 1):
        np.testing.assert_array_equal(by[(0, mp)]["local"],
                                      by[(1, mp)]["local"])
