"""Rank code of the port's multi-process CPU tests
(``test_torch_distributed.py``, ``test_torch_fleet.py``,
``test_torch_llama_mesh.py`` and the other mesh tests).

``run_world`` spawns a world of gloo ranks on the CPU through
``paddle_tpu_torch.distributed.spawn``; they meet through a ``file://``
store under the test's temporary directory (so concurrent test workers
never share a port), take one thread each, run every scenario named, and
pickle {scenario: its readings} for the test process, which holds them
against the JAX package or numpy. This module imports neither JAX nor the
JAX package, and each rank records whether either got loaded.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import traceback

import numpy as np
import torch


def run_world(tmp_dir, nprocs, scenarios, timeout=240, device="cpu"):
    """Spawn ``nprocs`` ranks running ``scenarios`` ([(name, function
    name in this module, kwargs)]) with ``device`` the default device
    (gloo either way: on one card the ranks share it); a list of each
    rank's {name: readings}."""
    from paddle_tpu_torch.distributed import spawn
    tmp_dir = str(tmp_dir)
    spawn(_rank_main, (tmp_dir, scenarios, device), nprocs=nprocs,
          init_method=f"file://{os.path.join(tmp_dir, 'store')}",
          timeout=timeout)
    out = []
    for r in range(nprocs):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def start_world(tmp_dir, nprocs, scenarios, timeout=240, device="cpu"):
    """``run_world`` in a thread of this process: a future of its result,
    so that the test process computes the reference meanwhile. The port
    is imported here first: two threads importing one package at once
    can deadlock on its module locks."""
    from concurrent.futures import ThreadPoolExecutor

    import paddle_tpu_torch.distributed  # noqa: F401
    import paddle_tpu_torch.models.nlp  # noqa: F401
    pool = ThreadPoolExecutor(1)
    future = pool.submit(run_world, tmp_dir, nprocs, scenarios, timeout,
                         device)
    pool.shutdown(wait=False)
    return future


def _rank_main(tmp_dir, scenarios, device):
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    paddle.set_device(device)
    # a collective that one rank never reaches raises after a minute
    # instead of holding the others
    D.init_parallel_env(backend="gloo",
                        timeout=datetime.timedelta(seconds=60))
    results = {}
    for name, fn, kwargs in scenarios:
        try:
            results[name] = globals()[fn](**kwargs)
        except Exception:              # noqa: BLE001 — reported per test
            results[name] = {"error": traceback.format_exc()}
    results["_loaded"] = sorted({m.split(".")[0] for m in sys.modules}
                                & {"jax", "jaxlib", "paddle_tpu"})
    with open(os.path.join(tmp_dir, f"rank{D.get_rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)
    D.barrier()
    D.destroy_process_group()


def rank_data(r, shape=(2, 3)):
    """The tensor rank ``r`` contributes to the collectives."""
    return (np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
            + 10.0 * r + 1.0)


def rank_int_data(r, shape=(2, 3)):
    """The int64 tensor rank ``r`` contributes to the integer averages:
    sums that 4 ranks do not divide, of both signs."""
    return (np.arange(np.prod(shape), dtype=np.int64).reshape(shape) * 7
            - 9 + 5 * r)


# --- test_torch_distributed.py ----------------------------------------------

def collectives():
    from paddle_tpu_torch import distributed as D
    r, w = D.get_rank(), D.get_world_size()
    x = torch.from_numpy(rank_data(r))
    out = {"rank": r, "world": w}
    for name, op in (("sum", D.ReduceOp.SUM), ("max", D.ReduceOp.MAX),
                     ("min", D.ReduceOp.MIN), ("prod", D.ReduceOp.PROD),
                     ("avg", D.ReduceOp.AVG)):
        t = x.clone()
        D.all_reduce(t, op=op)
        out[f"all_reduce_{name}"] = t.numpy()
    t = x.clone()
    D.broadcast(t, src=2)
    out["broadcast"] = t.numpy()
    lst = []
    D.all_gather(lst, x)
    out["all_gather"] = np.stack([t.numpy() for t in lst])
    t = x.clone()
    D.reduce(t, dst=1)
    out["reduce"] = t.numpy()
    # integers: the mean in the tensor's dtype, truncated, as the
    # reference's jnp.mean(...).astype(dtype)
    xi = torch.from_numpy(rank_int_data(r))
    for name, fn in (("all_reduce", lambda t: D.all_reduce(
            t, op=D.ReduceOp.AVG)), ("reduce", lambda t: D.reduce(
            t, dst=1, op=D.ReduceOp.AVG))):
        t = xi.clone()
        fn(t)
        out[f"{name}_avg_int64"] = t.numpy()
    t = torch.empty_like(x)
    D.scatter(t, [x + 100.0 * i for i in range(w)] if r == 0 else None,
              src=0)
    out["scatter"] = t.numpy()
    outs = []
    D.alltoall([x + 1000.0 * j for j in range(w)], outs)
    out["alltoall"] = np.stack([t.numpy() for t in outs])
    t = x.clone()
    peer = r + 1 if r % 2 == 0 else r - 1
    if r % 2 == 0:
        D.send(x, dst=peer)
        D.recv(t, src=peer)
    else:
        D.recv(t, src=peer)
        D.send(x, dst=peer)
    out["recv"] = t.numpy()
    t = x.clone()
    task = D.all_reduce(t, sync_op=False)
    out["async_ok"] = task.wait(timeout=60)
    out["async_completed"] = task.is_completed()
    out["async_all_reduce"] = t.numpy()
    lst = []
    task = D.all_gather(lst, x, sync_op=False)
    task.synchronize()
    out["async_all_gather"] = np.stack([t.numpy() for t in lst])
    t = x.clone()
    D.all_reduce(t, op=D.ReduceOp.AVG, sync_op=False).wait()
    out["async_avg"] = t.numpy()
    D.barrier()
    g = D.new_group([1, 3])
    out["group_rank"] = D.get_rank(g)
    out["group_size"] = D.get_world_size(g)
    if r in (1, 3):
        t = x.clone()
        D.all_reduce(t, group=g)
        out["group_sum"] = t.numpy()
    out["split"] = D.split(torch.arange(8.0), 4, axis=0).numpy()
    return out


def hybrid_group():
    from paddle_tpu_torch import distributed as D
    topo = D.CommunicateTopology(["data", "pipe", "sharding", "sep",
                                  "model"], [2, 1, 1, 1, 2])
    hcg = D.HybridCommunicateGroup(topo)
    out = {"mode": hcg.get_parallel_mode()}
    for axis in ("data", "pipe", "sharding", "sep", "model"):
        g = hcg._groups[axis]
        t = torch.tensor([float(D.get_rank())])
        D.all_reduce(t, group=g)
        out[axis] = {"ranks": g.ranks, "rank": g.rank, "nranks": g.nranks,
                     "sum": float(t)}
    out["mp_rank"] = hcg.get_model_parallel_rank()
    out["dp_rank"] = hcg.get_data_parallel_rank()
    out["mesh_coords"] = {a: hcg.mesh.coordinate(a)
                          for a in hcg.mesh.axis_names}
    return out


def _mlp(state):
    from paddle_tpu_torch import nn
    net = nn.Sequential(nn.Linear(6, 4), nn.Tanh(), nn.Linear(4, 2))
    net.set_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net


def data_parallel(state, x1, y1, x2, y2, table, ids):
    """Pairs of ranks ({0, 1}, {2, 3}) each run DataParallel over their
    pair: micro-batch 1 under no_sync, micro-batch 2 synchronised; each
    rank takes its half of each. Then a sparse embedding's gradient."""
    from paddle_tpu_torch import distributed as D
    r = D.get_rank()
    groups = [D.new_group([0, 1]), D.new_group([2, 3])]
    g = groups[r // 2]
    i = g.rank
    net = D.DataParallel(_mlp(state), group=g)

    def loss_of(x, y):
        h = len(x) // 2
        xs, ys = (torch.from_numpy(a[i * h:(i + 1) * h]) for a in (x, y))
        return torch.mean((net(xs) - ys) ** 2)

    with net.no_sync():
        loss_of(x1, y1).backward()
    unsynced = {k: p.grad.clone().numpy()
                for k, p in net.named_parameters()}
    loss_of(x2, y2).backward()
    out = {"grads": {k: p.grad.numpy() for k, p in net.named_parameters()},
           "unsynced": unsynced, "keys": list(net.state_dict())}
    emb = torch.nn.Parameter(torch.from_numpy(table.copy()))
    dp = D.DataParallel(torch.nn.ParameterList([emb]), group=g)
    h = len(ids) // 2
    mine = torch.from_numpy(ids[i * h:(i + 1) * h])
    torch.nn.functional.embedding(mine, emb, sparse=True).sum().backward()
    out["sparse_is_sparse"] = bool(emb.grad.is_sparse)
    out["sparse_grad"] = emb.grad.to_dense().numpy()
    del dp
    return out


def zero(state, grads, steps=2):
    """group_sharded_parallel over the world: the sharded AdamW step
    against a plain twin on the same gradients, at each level, with
    offload and with bf16 masters."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import nn, optimizer
    out = {}
    for name, level, offload, dtype in (
            ("os", "os", False, torch.float32),
            ("os_g", "os_g", False, torch.float32),
            ("p_g_os", "p_g_os", False, torch.float32),
            ("os_offload", "os", True, torch.float32),
            ("os_bf16", "os", False, torch.bfloat16)):
        nets = []
        for _ in range(2):
            net = nn.Sequential(nn.Linear(8, 16), nn.Linear(16, 3))
            net.to(dtype=dtype)
            net.set_state_dict({k: torch.from_numpy(v).to(dtype)
                                for k, v in state.items()})
            nets.append(net)
        mp = dtype != torch.float32
        plain = optimizer.AdamW(learning_rate=0.01,
                                parameters=nets[0].parameters(),
                                multi_precision=mp)
        opt = optimizer.AdamW(learning_rate=0.01,
                              parameters=nets[1].parameters(),
                              multi_precision=mp)
        model, opt = D.sharding.group_sharded_parallel(nets[1], opt, level,
                                                       offload=offload)
        for s in range(steps):
            for net in (nets[0], model):
                for (k, p) in net.named_parameters():
                    p.grad = torch.from_numpy(grads[s][k]).to(dtype)
            plain.step()
            opt.step()
        specs = {k: getattr(p, "sharding_spec", None)
                 for k, p in nets[1].named_parameters()}
        acc_bytes = sum(a.numel() * a.element_size()
                        for accs in opt._accumulators.values()
                        for a in accs.values())
        plain_bytes = sum(a.numel() * a.element_size()
                          for accs in plain._accumulators.values()
                          for a in accs.values())
        out[name] = {
            "equal": all(torch.equal(a, b) for a, b in
                         zip(nets[0].parameters(), nets[1].parameters())),
            "params": {k: p.detach().float().numpy()
                       for k, p in nets[1].named_parameters()},
            "acc_bytes": acc_bytes, "plain_bytes": plain_bytes,
            "specs": specs,
            "pinned": all(a.is_pinned() or not torch.cuda.is_available()
                          for accs in opt._accumulators.values()
                          for a in accs.values()) if offload else None,
            "on_host": all(a.device.type == "cpu"
                           for accs in opt._accumulators.values()
                           for a in accs.values())}
    return out


def sampler(n=10, batch_size=2):
    from paddle_tpu_torch import io
    s = io.DistributedBatchSampler(list(range(n)), batch_size, shuffle=True)
    first = list(s)
    s.set_epoch(1)
    return {"nranks": s.nranks, "local_rank": s.local_rank, "epoch0": first,
            "epoch1": list(s)}


def store(port):
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.store import _PyClient
    r, w = D.get_rank(), D.get_world_size()
    st = D.TCPStore("127.0.0.1", port, is_master=(r == 0), world_size=w,
                    timeout=60)
    st.set(f"key{r}", f"value{r}".encode())
    counts = st.add("counter", r + 1)
    st.barrier("after_set")
    out = {"get": [st.get(f"key{i}") for i in range(w)],
           "wait": st.wait(f"key{(r + 1) % w}"), "add": counts}
    if r == 1:
        py = _PyClient("127.0.0.1", port)
        py.set("from_python", b"py")
        out["py_add"] = py.add("counter", 100)
        out["py_get"] = py.get("key0")
        py.close()
    st.barrier("after_python")
    out["from_python"] = st.get("from_python")
    out["counter"] = st.add("counter", 0)
    st.barrier("end")
    st.close()
    return out


# --- test_torch_fleet.py -----------------------------------------------------

def _fleet_init(dp=2, mp=2):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet


def mp_layers(w_col, b_col, w_row, b_row, table, x, dy_col, dy_row, ids,
              logits, labels):
    """Each model-parallel layer at tp = 2 (data 2 x model 2), loaded with
    full weights through ``TensorParallel.set_state_dict``: its output and
    gradients."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    fleet = _fleet_init()
    hcg = fleet.get_hybrid_communicate_group()
    group = hcg.get_model_parallel_group()
    out = {"mp_rank": group.rank, "dp_rank": hcg.get_data_parallel_rank()}

    def run(layer, state, inp, dy, name, parallel_in=False):
        tp = mpu.TensorParallel(layer, hcg)
        tp.set_state_dict(state)
        xin = torch.from_numpy(inp).requires_grad_(True)
        if parallel_in:
            half = inp.shape[-1] // group.nranks
            xin = torch.from_numpy(inp[..., group.rank * half:(group.rank + 1)
                                       * half].copy()).requires_grad_(True)
        y = tp(xin)
        y.backward(torch.from_numpy(dy if not (name == "col_local")
                                    else _cols(dy, group)))
        out[name] = {"y": y.detach().numpy(), "dx": xin.grad.numpy(),
                     "grads": {k: p.grad.numpy()
                               for k, p in layer.named_parameters()},
                     "full_state": {k: v.numpy() for k, v in
                                    tp.state_dict().items()},
                     "specs": {k: p.sharding_spec
                               for k, p in layer.named_parameters()}}

    col_state = {"weight": w_col, "bias": b_col}
    run(mpu.ColumnParallelLinear(*w_col.shape, gather_output=True),
        col_state, x, dy_col, "col_gather")
    run(mpu.ColumnParallelLinear(*w_col.shape, gather_output=False),
        col_state, x, dy_col, "col_local")
    row_state = {"weight": w_row, "bias": b_row}
    h = np.tanh(x @ w_col)
    run(mpu.RowParallelLinear(*w_row.shape, input_is_parallel=False),
        row_state, h, dy_row, "row_full")
    run(mpu.RowParallelLinear(*w_row.shape, input_is_parallel=True),
        row_state, h, dy_row, "row_parallel", parallel_in=True)
    emb = mpu.VocabParallelEmbedding(*table.shape)
    tp = mpu.TensorParallel(emb, hcg)
    tp.set_state_dict({"weight": table})
    y = tp(torch.from_numpy(ids))
    y.backward(torch.from_numpy(np.ones(y.shape, np.float32)))
    out["embedding"] = {"y": y.detach().numpy(),
                        "grad": emb.weight.grad.numpy()}
    # from one seed a rank's layer holds its slice of the one-rank layer
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.core import generator
    alone = D.ParallelGroup([D.get_rank()], D.get_rank(), "model")
    seeded = {}
    for name, make, dim in (
            ("column", mpu.ColumnParallelLinear, 1),
            ("row", mpu.RowParallelLinear, 0),
            ("embedding", mpu.VocabParallelEmbedding, 0)):
        generator.seed(5)
        mine = make(16, 8).weight
        generator.seed(5)
        whole = make(16, 8, mp_group=alone).weight
        seeded[name] = torch.equal(mine, whole.chunk(2, dim)[group.rank])
    out["seeded"] = seeded
    ce = mpu.ParallelCrossEntropy()
    lg = torch.from_numpy(_cols(logits, group)).requires_grad_(True)
    loss = ce(lg, torch.from_numpy(labels))
    loss.sum().backward()
    out["cross_entropy"] = {"loss": loss.detach().numpy(),
                            "dlogits": lg.grad.numpy()}
    return out


def _cols(a, group):
    n = a.shape[-1] // group.nranks
    return a[..., group.rank * n:(group.rank + 1) * n].copy()


def fleet_mlp(state, x, y, steps, lr, clip):
    """fleet.init (data 2 x model 2) -> distributed_model ->
    distributed_optimizer on a Column -> tanh -> Row MLP; SGD with a
    global-norm clip; each data rank its half of the batch."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    fleet = _fleet_init()
    hcg = fleet.get_hybrid_communicate_group()

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = mpu.ColumnParallelLinear(16, 32, gather_output=False)
            self.fc2 = mpu.RowParallelLinear(32, 16, input_is_parallel=True)

        def forward(self, x):
            return self.fc2(torch.tanh(self.fc1(x)))

    net = MLP()
    model = fleet.distributed_model(net)
    model.set_state_dict(state)
    opt = fleet.distributed_optimizer(optimizer.SGD(
        learning_rate=lr, parameters=model.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(clip)))
    d = hcg.get_data_parallel_rank()
    h = len(x) // 2
    xs, ys = (torch.from_numpy(a[d * h:(d + 1) * h]) for a in (x, y))
    losses = []
    for _ in range(steps):
        loss = torch.mean((model(xs) - ys) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return {"losses": losses, "wrapper": type(model).__name__,
            "optimizer": type(opt).__name__,
            "state": {k: v.detach().numpy()
                      for k, v in model.state_dict().items()},
            "worker": (fleet.worker_index(), fleet.worker_num(),
                       fleet.is_first_worker())}


def rng_tracker():
    from paddle_tpu_torch.core import generator as gen
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    fleet = _fleet_init()
    hcg = fleet.get_hybrid_communicate_group()
    mpu.model_parallel_random_seed(123)
    g = gen.torch_generator(None, "cpu")
    plain = torch.rand(4, generator=g).numpy()
    with mpu.get_rng_state_tracker().rng_state():
        local = torch.rand(4, generator=gen.torch_generator(None,
                                                            "cpu")).numpy()
    return {"mp_rank": hcg.get_model_parallel_rank(),
            "dp_rank": hcg.get_data_parallel_rank(),
            "plain": plain, "local": local}


# --- test_torch_llama_mesh.py ------------------------------------------------

def llama_mesh(dims, cfg, state, tokens, labels, steps=3, lr=1e-3,
               offload=False, remat=False, backend="ring"):
    """``llama_train_step_factory(model, mesh=build_mesh(dims))`` from the
    full ``state``: the losses of ``steps`` steps, this rank's shards after
    them, the moments' bytes, the attention's local heads, the
    context-parallel routes taken in the first step (the flag
    ``context_parallel_backend`` set to ``backend``)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.models.nlp.llama import llama_train_step_factory
    from paddle_tpu_torch.parallel import pallas_sharding
    config = LlamaConfig(**cfg)
    model = LlamaForCausalLM(config)
    load_numpy_state_dict(model, state)
    mesh = D.build_mesh(dims)
    pallas_sharding.ENGAGED.update(flag=False, heads=None)
    params, opt, step = llama_train_step_factory(
        model, mesh=mesh, learning_rate=lr, remat=remat,
        offload_moments=offload)
    first = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
    called = _spy_routes()
    losses, routes = [], None
    set_flags({"context_parallel_backend": backend})
    try:
        for _ in range(steps):
            params, opt, loss = step(params, opt, tokens, labels)
            losses.append(float(loss))
            routes = list(called) if routes is None else routes
    finally:
        set_flags({"context_parallel_backend": "ring"})
    moment = sum(m.numel() * m.element_size() for m in opt["m"].values())
    return {"losses": losses, "first": first,
            "params": {k: v.detach().cpu().numpy()
                       for k, v in params.items()},
            "moment_bytes": moment,
            "moment_shapes": {k: tuple(m.shape) for k, m in opt["m"].items()},
            "engaged": dict(pallas_sharding.ENGAGED), "routes": routes,
            "coords": {a: mesh.coordinate(a) for a in mesh.axis_names}}


def fail_on_rank(bad_rank):
    """Rank ``bad_rank`` raises at once; the others would wait for a
    minute."""
    import time
    if int(os.environ["PADDLE_GLOBAL_RANK"]) == bad_rank:
        raise RuntimeError("this rank fails")
    time.sleep(60)


# --- test_torch_ring_attention.py --------------------------------------------

def sep_attention(cases, device="cpu"):
    """Each case ({name: dict(kind, dims, q, k, v, do, causal, window)}, the
    arrays global) on this rank's chunk of the sequence, its tensors on
    ``device``: the output chunk and the q / k / v gradients of
    sum(out * do), and the attention kernels' launches."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    from paddle_tpu_torch.ops.flash_attention_gqa import \
        grouped_flash_attention
    from paddle_tpu_torch.ops.splash_attention import splash_attention
    from paddle_tpu_torch.parallel import (ring_attention,
                                           ring_window_attention,
                                           ulysses_attention)
    out = {}
    meshes = {}
    for name, c in cases.items():
        key = tuple(c["dims"].items())
        mesh = meshes.get(key) or meshes.setdefault(key,
                                                    D.build_mesh(c["dims"]))
        n, i = mesh.shape["sep"], mesh.coordinate("sep")

        def mine(a):
            s = a.shape[2] // n
            return torch.from_numpy(a[:, :, i * s:(i + 1) * s].copy()).to(
                device)

        owners = (flash_attention, grouped_flash_attention, splash_attention)
        before = [(o.launches_fwd, o.launches_dq, o.launches_dkv)
                  for o in owners]
        q, k, v = (mine(c[x]).requires_grad_(True) for x in "qkv")
        if c["kind"] == "ring":
            o = ring_attention(q, k, v, mesh, causal=c["causal"])
        elif c["kind"] == "window":
            o = ring_window_attention(q, k, v, mesh, c["window"])
        else:
            o = ulysses_attention(q, k, v, mesh, causal=c["causal"])
        o.backward(mine(c["do"]))
        launches = {
            f"{kind}_{part}": getattr(owner, f"launches_{part}") - b[j]
            for kind, owner, b in zip(("mha", "gqa", "splash"), owners,
                                      before)
            for j, part in enumerate(("fwd", "dq", "dkv"))}
        out[name] = {"out": o.detach().cpu().numpy(),
                     "dq": q.grad.cpu().numpy(), "dk": k.grad.cpu().numpy(),
                     "dv": v.grad.cpu().numpy(), "sep": i,
                     "launches": {k_: n_ for k_, n_ in launches.items()
                                  if n_}}
    return out


def _spy_routes():
    """Wrap the three context-parallel entry points where the Llama
    attention looks them up; returns the list of the names called."""
    import importlib
    # the package's attributes of these names are the functions
    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    ul = importlib.import_module("paddle_tpu_torch.parallel.ulysses")
    called = []
    for mod, name in ((ra, "ring_attention"), (ra, "ring_window_attention"),
                      (ul, "ulysses_attention")):
        fn = getattr(mod, name)
        fn = getattr(fn, "_spied", fn)

        def spy(*a, _fn=fn, _name=name, **kw):
            called.append(_name)
            return _fn(*a, **kw)

        spy._spied = fn
        setattr(mod, name, spy)
    return called


def llama_sep_attention(dims, cfg, state, x, dout, backends):
    """``LlamaAttention`` (the Layer path) under
    ``set_context_parallel_mesh``: the rank's chunk of x (B, S, H) in, its
    output chunk and the gradients of sum(out * dout) for x's chunk and the
    weights, with each flag value of ``backends``; the routes taken."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models.nlp import (LlamaConfig,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.models.nlp.llama import (LlamaAttention,
                                                   set_context_parallel_mesh)
    mesh = D.build_mesh(dims)
    n, i = mesh.shape["sep"], mesh.coordinate("sep")
    s = x.shape[1] // n
    called = _spy_routes()
    layer = LlamaAttention(LlamaConfig(**cfg), device="cpu")
    load_numpy_state_dict(layer, state)
    out = {"sep": i, "routes": {}}
    set_context_parallel_mesh(mesh)
    try:
        for backend in backends:
            set_flags({"context_parallel_backend": backend})
            for p in layer.parameters():
                p.grad = None
            called.clear()
            xi = torch.from_numpy(x[:, i * s:(i + 1) * s].copy())
            xi.requires_grad_(True)
            y = layer(xi)
            y.backward(torch.from_numpy(dout[:, i * s:(i + 1) * s].copy()))
            out[backend] = {
                "out": y.detach().numpy(), "dx": xi.grad.numpy(),
                "grads": {k: p.grad.numpy()
                          for k, p in layer.named_parameters()}}
            out["routes"][backend] = list(called)
    finally:
        set_context_parallel_mesh(None)
        set_flags({"context_parallel_backend": "ring"})
    return out


# --- test_torch_fleet_utils.py -----------------------------------------------

def meta_optimizers(init, grads, lr, momentum, k_steps, sparsity):
    """Each of fleet's meta-optimizers around ``optimizer.Momentum`` on
    parameters ``init`` ([array]), fed this rank's gradients
    ``grads[rank][step]`` ([array]): the parameters after every step."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as M
    r = D.get_rank()
    wrappers = {
        "gradient_merge": lambda o: M.GradientMergeOptimizer(o, k_steps),
        "local_sgd": lambda o: M.LocalSGDOptimizer(o, k_steps),
        "dgc": lambda o: M.DGCMomentumOptimizer(o, sparsity=sparsity)}
    out = {}
    for name, wrap in wrappers.items():
        params = [torch.nn.Parameter(torch.from_numpy(a.copy()))
                  for a in init]
        opt = wrap(optimizer.Momentum(learning_rate=lr, momentum=momentum,
                                      parameters=params))
        seen = []
        for step_grads in grads[r]:
            for p, g in zip(params, step_grads):
                p.grad = torch.from_numpy(g.copy())
            opt.step()
            opt.clear_grad()
            seen.append([p.detach().numpy().copy() for p in params])
        out[name] = seen
    return out


# --- test_torch_models_mesh.py -----------------------------------------------

def small_resnet(nn, block, **kw):
    """A ResNet of two ``block``s at widths 16 and 32 (the second strided,
    with its 1x1 downsample) on a 16-channel stem, pooled into 10 classes:
    built alike from either package's ``nn`` and ``BasicBlock`` (``kw``:
    the port's ``device``), so the state-dict keys agree."""
    return nn.Sequential(
        nn.Conv2D(3, 16, 3, padding=1, bias_attr=False, **kw),
        nn.BatchNorm2D(16, **kw), nn.ReLU(),
        block(16, 16, **kw),
        block(16, 32, 2, nn.Sequential(
            nn.Conv2D(16, 32, 1, stride=2, bias_attr=False, **kw),
            nn.BatchNorm2D(32, **kw)), **kw),
        nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(32, 10, **kw))


def _dense_model(kind, cfg, state):
    """The port's ``kind`` model ("bert", "gpt", "resnet") from ``cfg``
    and the reference's ``state``, on the CPU."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import nlp
    from paddle_tpu_torch.vision.models.resnet import BasicBlock
    if kind == "bert":
        model = nlp.BertForPretraining(nlp.BertConfig(**cfg), device="cpu")
    elif kind == "gpt":
        model = nlp.GPTForCausalLM(nlp.GPTConfig(**cfg), device="cpu")
    else:
        model = small_resnet(nn, BasicBlock, device="cpu")
    return nn.load_numpy_state_dict(model, state)


def models_mesh(kind, dims, cfg, state, batch, steps=3, lr=1e-3):
    """``{kind}``'s train-step factory on ``build_mesh(dims)`` from the
    reference's ``state`` over the global ``batch``: the losses of
    ``steps`` steps, the parameters before the first and after the last
    (ResNet: the buffers too), the moments' bytes, and this rank's own
    loss of its rows before the first step (the mean a per-rank mean
    would give)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import nlp
    from paddle_tpu_torch.models.nlp.bert import pretrain_loss
    from paddle_tpu_torch.models.nlp.gpt import lm_loss
    from paddle_tpu_torch.vision.models import resnet_train_step_factory
    mesh = D.build_mesh(dims)
    model = _dense_model(kind, cfg, state)
    if kind != "resnet":
        model.eval()
    n, row = dims.get("data", 1), mesh.coordinate("data") \
        if "data" in dims else 0
    b = batch[0].shape[0] // n
    rows = [torch.from_numpy(a[row * b:(row + 1) * b]).long()
            if a.dtype.kind == "i" else torch.from_numpy(a[row * b:
                                                           (row + 1) * b])
            for a in batch]
    with torch.no_grad():
        if kind == "bert":
            own = float(pretrain_loss(model, *rows))
        elif kind == "gpt":
            own = float(lm_loss(model, *rows))
        else:
            own = None
    if kind == "resnet":
        params, buffers, opt, step = resnet_train_step_factory(
            model, mesh, learning_rate=lr, device="cpu")
    else:
        make = nlp.bert_pretrain_step_factory if kind == "bert" \
            else nlp.gpt_pretrain_step_factory
        params, opt, step = make(model, mesh, learning_rate=lr,
                                 device="cpu")
    first = {k: v.detach().numpy().copy() for k, v in params.items()}
    losses = []
    for _ in range(steps):
        if kind == "resnet":
            params, buffers, opt, loss = step(params, buffers, opt, *batch)
        else:
            params, opt, loss = step(params, opt, *batch)
        losses.append(float(loss))
    out = {"losses": losses, "first": first, "own_first": own,
           "params": {k: v.detach().numpy() for k, v in params.items()},
           "coords": {a: mesh.coordinate(a) for a in mesh.axis_names}}
    if kind == "resnet":
        out["buffers"] = {k: v.numpy().copy() for k, v in buffers.items()}
    else:
        out["moment_bytes"] = sum(m.numel() * m.element_size()
                                  for m in opt["m"].values())
    return out


def bert_dropout_masks(dims, cfg):
    """A BERT at dropout 0.1 after ``bert_pretrain_step_factory(mesh=)``:
    the mask its embeddings' dropout draws on ones (64,), and the losses
    of two steps with live dropout, with and without remat (each from the
    same generator states)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import nlp
    mesh = D.build_mesh(dims)
    config = nlp.BertConfig(**cfg)
    out = {}
    for remat in (False, True):
        model = nlp.BertForPretraining(config, device="cpu",
                                       generator=torch.Generator()
                                       .manual_seed(5))
        params, opt, step = nlp.bert_pretrain_step_factory(
            model, mesh, learning_rate=1e-3, remat=remat, device="cpu")
        drop = model.bert.embeddings.dropout
        gen = torch_generator_of(drop.generator)
        state = gen.get_state()
        with torch.no_grad():
            out["mask"] = (drop(torch.ones(64)) != 0).numpy()
        gen.set_state(state)
        rng = np.random.default_rng(3)
        B, S = 4, 16
        ids = rng.integers(0, config.vocab_size, (B, S))
        mlm = np.where(rng.random((B, S)) < 0.3, ids, -100)
        nsp = rng.integers(0, 2, (B,))
        out[f"losses_remat{int(remat)}"] = [
            float(step(params, opt, ids, np.zeros_like(ids), mlm, nsp)[2])
            for _ in range(2)]
    return out


def torch_generator_of(generator):
    from paddle_tpu_torch.core.generator import torch_generator
    return torch_generator(generator, "cpu")


def sync_batch_norm(x, dout, weight, bias, group_of=None):
    """A batch norm in training on this rank's rows of the global ``x``
    (N, C, H, W): ``nn.SyncBatchNorm`` over the world's default group,
    or with ``group_of`` a ``BatchNorm2D`` under the group the ResNet
    train step sets (``_sync_batch_norm``) of that axis of a
    {data 2, sharding 2} mesh, whose sharding peers hold the same rows.
    Its output rows, the gradients of sum(out * dout's rows) for x's
    rows, weight and bias, and the running statistics."""
    import contextlib

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn.functional.norm import _sync_batch_norm
    r, n = D.get_rank(), D.get_world_size()
    synced = contextlib.nullcontext()
    layer = nn.SyncBatchNorm(x.shape[1], device="cpu")
    if group_of is not None:
        mesh = D.build_mesh({"data": 2, "sharding": 2})
        synced = _sync_batch_norm(mesh.group(group_of))
        r, n = mesh.coordinate(group_of), 2
        layer = nn.BatchNorm2D(x.shape[1], device="cpu")
    b = x.shape[0] // n
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(weight))
        layer.bias.copy_(torch.from_numpy(bias))
    xi = torch.from_numpy(x[r * b:(r + 1) * b].copy()).requires_grad_(True)
    with synced:
        y = layer(xi)
    (y * torch.from_numpy(dout[r * b:(r + 1) * b])).sum().backward()
    return {"out": y.detach().numpy(), "dx": xi.grad.numpy(),
            "dw": layer.weight.grad.numpy(), "db": layer.bias.grad.numpy(),
            "mean": layer._mean.numpy().copy(),
            "var": layer._variance.numpy().copy()}


# --- test_torch_moe_mesh.py --------------------------------------------------

def moe_mesh(dims, cfg, state, tokens, labels, steps=3, lr=1e-3,
             chunked=None, gate=None, dispatch_mode=None):
    """``moe_train_step_factory(model, mesh=build_mesh(dims))`` from the
    reference's ``state``: the losses of ``steps`` steps, this rank's
    shards before the first step, each MoE layer's routing and aux loss
    of the first step, the moments' bytes and the expert shard's share."""
    import dataclasses

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import nlp
    from paddle_tpu_torch.nn import load_numpy_state_dict
    mesh = D.build_mesh(dims)
    config = nlp.MoEConfig(**cfg)
    if dispatch_mode is not None:
        config = dataclasses.replace(config, dispatch_mode=dispatch_mode)
    model = nlp.MoEForCausalLM(config, device="cpu")
    load_numpy_state_dict(model, state)
    full = sum(p.numel() for k, p in model.named_parameters()
               if ".mlp.w_" in k)
    params, opt, step = nlp.moe_train_step_factory(
        model, mesh, learning_rate=lr, chunked_vocab_ce=chunked,
        device="cpu")
    first = {k: v.detach().numpy().copy() for k, v in params.items()}
    losses, routing, aux = [], None, None
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
        if routing is None:
            moe = [layer.mlp for layer in model.layers if layer.use_moe]
            routing = [{k: (v if isinstance(v, int) else v.numpy())
                        for k, v in m.routing.items()} for m in moe]
            aux = [float(m.aux_loss) for m in moe]
    held = sum(p.numel() for k, p in params.items() if ".mlp.w_" in k)
    return {"losses": losses, "first": first, "routing": routing,
            "aux": aux, "expert_share": held / full,
            "params": {k: v.detach().numpy() for k, v in params.items()},
            "moment_bytes": sum(m.numel() * m.element_size()
                                for m in opt["m"].values()),
            "coords": {a: mesh.coordinate(a) for a in mesh.axis_names}}


def moe_expert_choice_refused(dims):
    """The refusal of expert-choice routing over "data", as its text."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    mesh = D.build_mesh(dims)
    layer = MoELayer(16, 32, 4, gate="expert_choice", device="cpu")
    layer.distribute(mesh)
    try:
        layer(torch.ones(2, 4, 16))
    except NotImplementedError as e:
        return {"refused": str(e)}
    return {"refused": None}


def moe_layer_mesh(dims, d_model, d_hidden, n_experts, gate, top_k, mode,
                   x, dout, state, train=False, seed=0):
    """A ``MoELayer`` from ``state`` (its generator a ``torch.Generator``
    seeded with ``seed``) spread over ``build_mesh(dims)``
    (``distribute``), in training mode with ``train``, on this rank's rows
    of "data" of the global ``x``: its output rows, the gradients of
    sum(out * dout's rows) + aux for x's rows and the router, and its aux
    loss."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.nn import load_numpy_state_dict
    mesh = D.build_mesh(dims)
    layer = MoELayer(d_model, d_hidden, n_experts, gate=gate, top_k=top_k,
                     dispatch_mode=mode, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    load_numpy_state_dict(layer, state)
    layer.train(train)
    layer.distribute(mesh)
    n = dims.get("data", 1)
    r = mesh.coordinate("data") if n > 1 else 0
    b = x.shape[0] // n
    xi = torch.from_numpy(x[r * b:(r + 1) * b].copy()).requires_grad_(True)
    y = layer(xi)
    ((y * torch.from_numpy(dout[r * b:(r + 1) * b])).sum()
     + layer.aux_loss).backward()
    return {"out": y.detach().numpy(), "dx": xi.grad.numpy(),
            "dwg": layer.gate.wg.weight.grad.numpy(),
            "aux": float(layer.aux_loss),
            "shapes": [tuple(layer.w_in.shape), tuple(layer.w_out.shape)]}


def card_sync_layers(bn, moe, device):
    """On ``device``, in bf16: ``nn.SyncBatchNorm`` over the world on this
    rank's rows of ``bn``'s x (its output, the gradients of sum(out *
    dout's rows) for x, weight and bias, the running statistics), and a
    ``MoELayer`` from ``moe``'s state spread over {expert: world}, in eval
    mode, on the whole x (its output and the gradients of sum(out * dout)
    + aux for x and the router)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    dev = paddle.resolve_device(device)
    bf16 = torch.bfloat16
    r, n = D.get_rank(), D.get_world_size()
    x, dout = (torch.from_numpy(a).to(dev, bf16) for a in (bn["x"],
                                                            bn["dout"]))
    b = x.shape[0] // n
    layer = nn.SyncBatchNorm(x.shape[1], device=dev).to(bf16)
    xi = x[r * b:(r + 1) * b].clone().requires_grad_(True)
    y = layer(xi)
    (y * dout[r * b:(r + 1) * b]).sum().backward()
    out = {"bn": {"out": y, "dx": xi.grad, "dw": layer.weight.grad,
                  "db": layer.bias.grad, "mean": layer._mean,
                  "var": layer._variance}}
    expert = MoELayer(moe["H"], moe["F"], moe["E"], device=dev)
    nn.load_numpy_state_dict(expert, moe["state"])
    expert = expert.to(bf16).eval()
    expert.distribute(D.build_mesh({"expert": n}))
    x, dout = (torch.from_numpy(a).to(dev, bf16) for a in (moe["x"],
                                                            moe["dout"]))
    xi = x.clone().requires_grad_(True)
    y = expert(xi)
    ((y * dout).sum() + expert.aux_loss).backward()
    out["moe"] = {"out": y, "dx": xi.grad, "dwg": expert.gate.wg.weight.grad}
    return {part: {k: v.detach().float().cpu().numpy() for k, v in d.items()}
            for part, d in out.items()}
