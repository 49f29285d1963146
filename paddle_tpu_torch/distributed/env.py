"""The distributed environment of the PyTorch port: rank and world
discovery, and the process group.

Counterpart of ``paddle_tpu/distributed/env.py`` (``ParallelEnv``,
``get_rank``, ``get_world_size``, ``get_local_rank``, ``is_initialized``,
``init_parallel_env``). The reference is one process driving every device
of a mesh (``jax.distributed`` joins hosts); the port follows PyTorch's
idiom and Paddle's own: one process per rank, joined by
``torch.distributed.init_process_group``.

The launch contract is the reference's (``:1-14``):

* ``PADDLE_MASTER`` (or ``PADDLE_COORDINATOR``): the rendezvous, as
  ``host:port`` (made ``tcp://host:port``) or an ``init_method`` URL
  (``tcp://...``, ``file://...``);
* ``PADDLE_GLOBAL_RANK`` (or ``PADDLE_TRAINER_ID``): this process's rank;
* ``PADDLE_WORLD_SIZE`` (or ``PADDLE_TRAINERS_NUM``): the number of ranks;
* ``PADDLE_LOCAL_RANK``: the rank on this host.

``init_parallel_env(backend=None)`` takes its backend from the default
device (``core.place``): NCCL on the card, gloo when the default device is
the CPU; without a card and without ``set_device("cpu")`` it raises, as
every entry point of the port does. An explicit ``backend`` overrides
that. On the card the process takes ``cuda:{local_rank % device_count}``
before the group is made. A world of one rank with no rendezvous named
gets a group over an in-memory store.
"""
from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist

_lock = threading.Lock()


def _env_int(*names, default=0):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return default


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank in the default group; the launch contract's
    before a group exists."""
    if is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_GLOBAL_RANK", "PADDLE_TRAINER_ID", default=0)


def get_world_size() -> int:
    if is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)


def get_local_rank() -> int:
    return _env_int("PADDLE_LOCAL_RANK", default=get_rank())


def _init_method():
    addr = os.environ.get("PADDLE_MASTER") or \
        os.environ.get("PADDLE_COORDINATOR")
    if not addr:
        return None
    return addr if "://" in addr else f"tcp://{addr}"


def _backend_of_default_device():
    from ..core.place import resolve_device
    return "nccl" if resolve_device(None).type == "cuda" else "gloo"


def init_parallel_env(backend: str | None = None, timeout=None):
    """``paddle.distributed.init_parallel_env``: join the default process
    group once (later calls return the same ``ParallelEnv``). Raises when
    the world has several ranks and no rendezvous is named."""
    with _lock:
        if is_initialized():
            return ParallelEnv()
        if backend is None:
            backend = _backend_of_default_device()
        world = _env_int("PADDLE_WORLD_SIZE", "PADDLE_TRAINERS_NUM",
                         default=1)
        rank = _env_int("PADDLE_GLOBAL_RANK", "PADDLE_TRAINER_ID",
                        default=0)
        if torch.cuda.is_available() and (backend == "nccl"
                                          or _uses_card()):
            torch.cuda.set_device(get_local_rank()
                                  % torch.cuda.device_count())
        kw = {} if timeout is None else {"timeout": timeout}
        method = _init_method()
        if method is not None:
            dist.init_process_group(backend, init_method=method, rank=rank,
                                    world_size=world, **kw)
        elif world == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, **kw)
        else:
            raise ValueError(
                f"init_parallel_env: a world of {world} ranks needs "
                f"PADDLE_MASTER (host:port or an init_method URL)")
    return ParallelEnv()


def _uses_card() -> bool:
    from ..core import place
    return place._default.type == "cuda"


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``: a view of the environment."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_local_rank()

    @property
    def dev_id(self):
        return get_local_rank()

    @property
    def device_type(self):
        from ..core import place
        return "gpu" if place._default.type == "cuda" else "cpu"

    @property
    def nranks(self):
        return get_world_size()
