"""The port's ``distributed`` package against the JAX package and numpy.

One world of 4 gloo ranks on the CPU (``torch_dist_ranks.run_world``,
started once for the module) runs every scenario; each test holds one
scenario's readings:

* ``CommunicateTopology`` / ``HybridCommunicateGroup``: rank lists,
  coordinates and getters equal to the reference's for {data 2, pipe 1,
  sharding 2, sep 1, model 2} at each of its 8 ranks (in this process, the
  rank and world taken from the launch variables, as both packages read
  them), and the port's groups inside the world, each summing its ranks;
* every collective against numpy, ``sync_op=False`` with ``Task.wait``;
* the identity collectives of a one-rank world against the reference's
  single process;
* ``DataParallel`` with ``no_sync`` over pairs of ranks against one
  process on the whole batch (dense and sparse gradients);
* ZeRO (``group_sharded_parallel``) at "os", "os_g" and "p_g_os", with
  offload and bf16 masters: AdamW bit-equal to the unsharded update on the
  same gradients, each rank holding a quarter of every divisible
  accumulator;
* ``DistributedBatchSampler``'s defaults inside the world against the
  reference's with the world's size and rank;
* ``TCPStore`` (the native library) across the 4 processes, and the
  Python client of its protocol against the native server.

Tolerances: f32 gradients against one process 1e-6 (the order of the
average's sum); everything else exact.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R

WORLD = 4


def _state(rng):
    return {"0.weight": rng.standard_normal((6, 4)).astype(np.float32),
            "0.bias": rng.standard_normal(4).astype(np.float32),
            "2.weight": rng.standard_normal((4, 2)).astype(np.float32),
            "2.bias": rng.standard_normal(2).astype(np.float32)}


def _zero_inputs(rng):
    state = {"0.weight": rng.standard_normal((8, 16)).astype(np.float32),
             "0.bias": rng.standard_normal(16).astype(np.float32),
             "1.weight": rng.standard_normal((16, 3)).astype(np.float32),
             "1.bias": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in state.items()} for _ in range(2)]
    return state, grads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from conftest import _free_port
    rng = np.random.default_rng(0)
    dp = dict(state=_state(rng),
              x1=rng.standard_normal((8, 6)).astype(np.float32),
              y1=rng.standard_normal((8, 2)).astype(np.float32),
              x2=rng.standard_normal((8, 6)).astype(np.float32),
              y2=rng.standard_normal((8, 2)).astype(np.float32),
              table=rng.standard_normal((10, 3)).astype(np.float32),
              ids=np.array([1, 3, 3, 7, 0, 3, 9, 9]))
    zstate, zgrads = _zero_inputs(rng)
    scenarios = [("collectives", "collectives", {}),
                 ("hybrid_group", "hybrid_group", {}),
                 ("data_parallel", "data_parallel", dp),
                 ("zero", "zero", dict(state=zstate, grads=zgrads)),
                 ("sampler", "sampler", {}),
                 ("store", "store", dict(port=_free_port()))]
    ranks = R.run_world(tmp_path_factory.mktemp("dist"), WORLD, scenarios)
    return {"ranks": ranks, "dp": dp, "zero": (zstate, zgrads)}


def _readings(world, name):
    out = [r[name] for r in world["ranks"]]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o.get('error')}"
    return out


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    assert all(r["_loaded"] == [] for r in world["ranks"])


def test_topology_matches_the_reference(monkeypatch):
    """The 8 ranks of {data 2, pipe 1, sharding 2, sep 1, model 2}: every
    axis's group (ranks, this rank's index), the getters and the topology's
    arithmetic, port against reference."""
    from paddle_tpu.distributed import topology as jtopo
    from paddle_tpu_torch.distributed import topology as ttopo

    names = ["data", "pipe", "sharding", "sep", "model"]
    dims = [2, 1, 2, 1, 2]
    monkeypatch.setattr(jtopo, "_global_mesh", jtopo._global_mesh)
    monkeypatch.setattr(ttopo, "_global_mesh", ttopo._global_mesh)
    jt, tt = (m.CommunicateTopology(names, dims) for m in (jtopo, ttopo))
    for name in names:
        assert tt.get_comm_list(name) == jt.get_comm_list(name)
        for i in range(tt.get_dim(name)):
            assert tt.get_axis_list(name, i) == jt.get_axis_list(name, i)
    assert tt.coordinate == jt.coordinate and tt.world_size() == 8
    monkeypatch.setenv("PADDLE_WORLD_SIZE", "8")
    # the reference reads the launch contract's rank only while its
    # parallel env is not initialised: a test of fleet run earlier in this
    # process may have initialised it
    from paddle_tpu.distributed import env as jenv
    monkeypatch.setattr(jenv, "_initialized", False)
    getters = ["get_parallel_mode", "get_data_parallel_rank",
               "get_data_parallel_world_size",
               "get_data_parallel_group_src_rank", "get_model_parallel_rank",
               "get_model_parallel_world_size",
               "get_model_parallel_group_src_rank", "get_stage_id",
               "get_pipe_parallel_world_size", "is_first_stage",
               "is_last_stage", "get_sharding_parallel_rank",
               "get_sharding_parallel_world_size",
               "get_sharding_parallel_group_src_rank",
               "get_sep_parallel_rank", "get_sep_parallel_world_size",
               "get_global_rank"]
    for r in range(8):
        monkeypatch.setenv("PADDLE_GLOBAL_RANK", str(r))
        jh, th = jtopo.HybridCommunicateGroup(jt), \
            ttopo.HybridCommunicateGroup(tt)
        for g in getters:
            assert getattr(th, g)() == getattr(jh, g)(), (r, g)
        for name in names:
            assert th._groups[name].ranks == jh._groups[name].ranks
            assert th._groups[name].rank == jh._groups[name].rank
        assert th.get_rank_from_stage(0, model=1) == \
            jh.get_rank_from_stage(0, model=1)
        assert th.mesh.devices.shape == jh.mesh.devices.shape
        assert th.mesh.devices.ravel().tolist() == [
            d.id for d in jh.mesh.devices.ravel()]


def test_hybrid_group_inside_the_world(world):
    from paddle_tpu_torch.distributed.topology import CommunicateTopology
    t = CommunicateTopology(["data", "pipe", "sharding", "sep", "model"],
                            [2, 1, 1, 1, 2])
    for r, o in enumerate(_readings(world, "hybrid_group")):
        assert o["mode"] == "hybrid"
        for axis in ("data", "pipe", "sharding", "sep", "model"):
            ranks = next(c for c in t.get_comm_list(axis) if r in c)
            assert o[axis]["ranks"] == ranks
            assert o[axis]["rank"] == ranks.index(r)
            assert o[axis]["sum"] == sum(ranks)
        assert (o["dp_rank"], o["mp_rank"]) == tuple(
            t.get_coord(r)[i] for i in (0, 4))
        assert o["mesh_coords"]["model"] == o["mp_rank"]


def test_collectives_against_numpy(world):
    outs = _readings(world, "collectives")
    data = [R.rank_data(r) for r in range(WORLD)]
    stacked = np.stack(data)
    for r, o in enumerate(outs):
        assert o["rank"] == r and o["world"] == WORLD
        np.testing.assert_array_equal(o["all_reduce_sum"], stacked.sum(0))
        np.testing.assert_array_equal(o["all_reduce_max"], stacked.max(0))
        np.testing.assert_array_equal(o["all_reduce_min"], stacked.min(0))
        np.testing.assert_array_equal(o["all_reduce_prod"],
                                      stacked.prod(0))
        np.testing.assert_allclose(o["all_reduce_avg"], stacked.mean(0),
                                   rtol=1e-6)
        np.testing.assert_array_equal(o["broadcast"], data[2])
        np.testing.assert_array_equal(o["all_gather"], stacked)
        np.testing.assert_array_equal(o["scatter"], data[0] + 100.0 * r)
        np.testing.assert_array_equal(
            o["alltoall"], np.stack([d + 1000.0 * r for d in data]))
        np.testing.assert_array_equal(o["recv"], data[r ^ 1])
        assert o["async_ok"] and o["async_completed"]
        np.testing.assert_array_equal(o["async_all_reduce"], stacked.sum(0))
        np.testing.assert_array_equal(o["async_all_gather"], stacked)
        np.testing.assert_allclose(o["async_avg"], stacked.mean(0),
                                   rtol=1e-6)
        assert o["group_size"] == 2
        assert o["group_rank"] == {1: 0, 3: 1}.get(r, -1)
        if r in (1, 3):
            np.testing.assert_array_equal(o["group_sum"], data[1] + data[3])
        np.testing.assert_array_equal(o["split"], [2.0 * r, 2.0 * r + 1])
    ints = np.stack([R.rank_int_data(r) for r in range(WORLD)])
    for r, o in enumerate(outs):
        # every rank ends with the reduction, as in the reference
        np.testing.assert_array_equal(o["reduce"], stacked.sum(0))
        for name in ("all_reduce", "reduce"):
            got = o[f"{name}_avg_int64"]
            assert got.dtype == np.int64
            np.testing.assert_array_equal(
                got, np.trunc(ints.mean(0)).astype(np.int64))


def test_identity_collectives_match_the_reference_process():
    """No process group: a world of one rank, every collective the
    identity, as in the reference's single process."""
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor
    import paddle_tpu.distributed as JD
    import paddle_tpu_torch.distributed as TD

    assert not TD.is_initialized()
    x = R.rank_data(0)
    jx, tx = Tensor(jnp.asarray(x)), torch.from_numpy(x.copy())
    for op in (0, 1, 2, 3, 4):
        j = JD.all_reduce(jx, op=op)
        t = TD.all_reduce(tx, op=op)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j._value))
    for fn, args in ((TD.broadcast, (0,)), (TD.reduce, (0,))):
        np.testing.assert_array_equal(fn(tx, *args).numpy(), x)
    jl, tl = [], []
    JD.all_gather(jl, jx)
    TD.all_gather(tl, tx)
    assert len(tl) == len(jl) == 1
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]._value))
    ts, js = torch.zeros(2, 3), Tensor(jnp.zeros((2, 3)))
    JD.scatter(js, [Tensor(jnp.asarray(x + 5))])
    TD.scatter(ts, [torch.from_numpy(x + 5)])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js._value))
    jo, to = [], []
    JD.alltoall([jx], jo)
    TD.alltoall([tx], to)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]._value))
    TD.send(torch.from_numpy(x + 7), dst=0)
    got = torch.zeros(2, 3)
    TD.recv(got, src=0)
    np.testing.assert_array_equal(got.numpy(), x + 7)
    task = TD.all_reduce(tx, sync_op=False)
    assert isinstance(task, TD.Task) and task.is_completed() and task.wait(1)
    assert (TD.get_rank(), TD.get_world_size()) == (JD.get_rank(),
                                                    JD.get_world_size())
    np.testing.assert_array_equal(
        TD.split(torch.arange(8.0), 4, rank=1).numpy(),
        np.asarray(JD.split(Tensor(jnp.arange(8.0)), 4, rank=1)._value))
    TD.barrier()


def _one_process_grads(dp):
    """The whole batch in one process: the gradients of the mean loss of
    micro-batch 1 plus that of micro-batch 2."""
    net = R._mlp(dp["state"])
    for x, y in ((dp["x1"], dp["y1"]), (dp["x2"], dp["y2"])):
        xs, ys = torch.from_numpy(x[:4]), torch.from_numpy(y[:4])
        xs2, ys2 = torch.from_numpy(x[4:]), torch.from_numpy(y[4:])
        # each pair's rank i holds rows [4i, 4i + 4); the pair averages
        loss = (torch.mean((net(xs) - ys) ** 2)
                + torch.mean((net(xs2) - ys2) ** 2)) / 2
        loss.backward()
    return {k: p.grad.numpy() for k, p in net.named_parameters()}


def test_data_parallel_no_sync_matches_one_process(world):
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    try:
        want = _one_process_grads(world["dp"])
    finally:
        from paddle_tpu_torch.core import place
        place._default = torch.device("cuda")
    outs = _readings(world, "data_parallel")
    for r, o in enumerate(outs):
        assert o["keys"] == list(world["dp"]["state"])
        for k, w in want.items():
            np.testing.assert_allclose(o["grads"][k], w, rtol=1e-6,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
        # under no_sync each rank's gradient was its own half's
        assert not np.allclose(o["unsynced"]["0.weight"],
                               outs[r ^ 1]["unsynced"]["0.weight"])


def test_data_parallel_averages_sparse_gradients(world):
    ids = world["dp"]["ids"]
    table = world["dp"]["table"]
    want = np.zeros_like(table)
    np.add.at(want, ids, 1.0)
    for o in _readings(world, "data_parallel"):
        assert o["sparse_is_sparse"]
        np.testing.assert_allclose(o["sparse_grad"], want / 2, rtol=1e-6)


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os", "os_offload",
                                   "os_bf16"])
def test_zero_update_is_bit_equal_to_the_unsharded_one(world, level):
    outs = _readings(world, "zero")
    state, _ = world["zero"]
    # m and v (and the f32 master under bf16), f32: every tensor but the
    # (3,) bias divides over the 4 ranks, each keeping a quarter
    n_acc = 3 if level == "os_bf16" else 2
    div = sum(v.size for k, v in state.items() if k != "1.bias")
    for o in outs:
        got = o[level]
        assert got["equal"], level
        assert got["plain_bytes"] == n_acc * 4 * (div + 3)
        assert got["acc_bytes"] == n_acc * 4 * (div // WORLD + 3)
        assert got["on_host"]
        np.testing.assert_array_equal(got["params"]["0.weight"],
                                      outs[0][level]["params"]["0.weight"])
    if level == "p_g_os":
        assert outs[0][level]["specs"] == {
            "0.weight": (None, "sharding"), "0.bias": ("sharding",),
            "1.weight": ("sharding", None), "1.bias": ("sharding",)}


def test_sampler_defaults_to_the_world(world):
    from paddle_tpu.io import DistributedBatchSampler as JSampler
    for r, o in enumerate(_readings(world, "sampler")):
        assert (o["nranks"], o["local_rank"]) == (WORLD, r)
        j = JSampler(list(range(10)), 2, num_replicas=WORLD, rank=r,
                     shuffle=True)
        assert o["epoch0"] == list(j)
        j.set_epoch(1)
        assert o["epoch1"] == list(j)


def test_tcp_store_across_processes(world):
    outs = _readings(world, "store")
    for r, o in enumerate(outs):
        assert o["get"] == [f"value{i}".encode() for i in range(WORLD)]
        assert o["wait"] == f"value{(r + 1) % WORLD}".encode()
        assert o["from_python"] == b"py"
        assert o["counter"] == sum(range(1, WORLD + 1)) + 100
    assert outs[1]["py_get"] == b"value0"


def test_spawn_fails_fast_when_a_rank_fails():
    """A rank that raises fails the whole run: spawn names it and stops
    the others at once."""
    import time

    from paddle_tpu_torch.distributed import spawn
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="spawned rank 1 failed"):
        spawn(R.fail_on_rank, (1,), nprocs=2)
    assert time.monotonic() - t0 < 45


def test_gloo_bootstrap_and_parallel_env_at_world_one(monkeypatch):
    from conftest import _free_port
    import torch.distributed as tdist
    import paddle_tpu_torch.distributed as TD

    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    env = TD.gloo_init_parallel_env(0, 1, f"127.0.0.1:{_free_port()}")
    try:
        assert tdist.get_backend() == "gloo"
        assert (env.rank, env.world_size, env.nranks, env.local_rank) == \
            (0, 1, 1, 0)
        TD.gloo_barrier()
        t = torch.ones(2)
        TD.all_reduce(t)
        assert t.tolist() == [1.0, 1.0]
    finally:
        TD.gloo_release()
    assert not TD.is_initialized()
    with pytest.raises(NotImplementedError, match="item 15"):
        TD.launch
