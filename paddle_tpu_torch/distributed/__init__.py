"""``paddle.distributed`` for the PyTorch port: process groups and
collectives over ``torch.distributed``, the hybrid topology and its mesh,
``DataParallel``, fleet's collective path with its tensor-parallel layers
and hybrid optimizer, and ZeRO (``sharding``).

Counterpart of ``paddle_tpu/distributed/__init__.py``. The reference is
one process over every device; the port runs one process per rank, as
PyTorch and Paddle do: ``spawn(func, nprocs=N)`` (or any launcher that
sets the ``PADDLE_*`` variables of ``env.py``) starts them, and each calls
``init_parallel_env()``.

Not ported yet, and refused by name (ROADMAP Queue 1 item 15): ``launch``,
``fleet_executor`` (``FleetExecutor``, ``DistModel``,
``DistModelConfig``), ``passes``, ``metric``, ``checkpoint``,
``reshard`` / ``reshard_like`` and ``entry_attr``'s parameter-server
classes.
"""
from __future__ import annotations

import os
import socket
import time

from .env import (ParallelEnv, get_local_rank,  # noqa: F401
                  init_parallel_env, is_initialized)
from .collective import (ReduceOp, Task, all_gather,  # noqa: F401
                         all_reduce, alltoall, barrier, broadcast,
                         destroy_process_group, get_group, get_rank,
                         get_world_size, new_group, recv, reduce, scatter,
                         send, split, wait)
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, Mesh, ParallelGroup,
                       build_mesh, get_global_mesh,
                       get_hybrid_communicate_group, set_global_mesh,
                       set_hybrid_communicate_group)
from .store import TCPStore  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401

_NOT_PORTED = {
    "launch", "fleet_executor", "FleetExecutor", "DistModel",
    "DistModelConfig", "passes", "metric", "checkpoint", "reshard",
    "reshard_like", "entry_attr", "CountFilterEntry", "InMemoryDataset",
    "ParallelMode", "ProbabilityEntry", "QueueDataset", "ShowClickEntry",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle.distributed.{name} is not ported yet: ROADMAP Queue 1 "
            f"item 15 (launch, the fleet executor, passes, metric, "
            f"checkpoint, reshard and the parameter server follow the "
            f"collective path)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """``paddle.distributed.spawn``: run ``func(*args)`` in ``nprocs``
    new processes (``multiprocessing``'s spawn), rank r with
    ``PADDLE_GLOBAL_RANK`` / ``PADDLE_TRAINER_ID`` = r,
    ``PADDLE_LOCAL_RANK`` = r, ``PADDLE_WORLD_SIZE`` /
    ``PADDLE_TRAINERS_NUM`` = nprocs and ``PADDLE_MASTER`` = ``master``
    (``options``; a free localhost port by default, or an ``init_method``
    URL such as ``file://...``). ``nprocs=-1`` reads ``PADDLE_WORLD_SIZE``
    (1 when unset), as the reference.

    With ``join``, waits for every rank; as soon as one exits with an
    error the others are terminated and RuntimeError names it. Returns the
    processes."""
    import multiprocessing as mp

    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_WORLD_SIZE", "1"))
    master = options.get("master") or options.get("init_method") or \
        f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_GLOBAL_RANK": str(rank), "PADDLE_TRAINER_ID": str(rank),
               "PADDLE_LOCAL_RANK": str(rank),
               "PADDLE_WORLD_SIZE": str(nprocs),
               "PADDLE_TRAINERS_NUM": str(nprocs), "PADDLE_MASTER": master}
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        _join(procs, options.get("timeout"))
    return procs


def _join(procs, timeout=None):
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"spawned rank {bad[0][0]} failed: exit "
                                   f"{bad[0][1]}")
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"spawned ranks still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawned rank {bad[0][0]} failed: exit "
                               f"{bad[0][1]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """``paddle.distributed.gloo_init_parallel_env``: join a gloo group of
    ``rank_num`` ranks through ``server_endpoint`` (host:port)."""
    os.environ["PADDLE_TRAINER_ID"] = str(rank_id)
    os.environ["PADDLE_TRAINERS_NUM"] = str(rank_num)
    os.environ["PADDLE_MASTER"] = server_endpoint
    return init_parallel_env(backend="gloo")


def gloo_barrier():
    """``paddle.distributed.gloo_barrier``: a barrier of every rank."""
    barrier()


def gloo_release():
    """``paddle.distributed.gloo_release``: leave the gloo group."""
    import torch.distributed as dist
    if is_initialized() and dist.get_backend() == "gloo":
        destroy_process_group()
