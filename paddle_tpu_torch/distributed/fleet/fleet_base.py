"""The fleet singleton of the PyTorch port: ``init``,
``distributed_model``, ``distributed_optimizer``.

Counterpart of ``paddle_tpu/distributed/fleet/fleet_base.py:18-129``.
``init(role_maker, is_collective, strategy)`` joins the process group
(``init_parallel_env``) and builds the ``HybridCommunicateGroup`` of
``strategy.hybrid_configs``, the data degree filled to take the whole
world as in the reference. ``distributed_model`` wraps a model in
``TensorParallel`` under a model group of several ranks, else in
``DataParallel`` over the data group in a world of several ranks;
``distributed_optimizer`` wraps the optimizer in
``HybridParallelOptimizer`` under a model group of several ranks. A pipe
degree above 1 is refused: the pipeline is ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import env as _env
from ..parallel import DataParallel
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        get_hybrid_communicate_group as _get_hcg,
                        set_hybrid_communicate_group)
from .distributed_strategy import DistributedStrategy

PIPE_NOT_PORTED = ("a pipe degree above 1 is not ported yet: ROADMAP Queue 1 "
                   "item 15 (ring and Ulysses attention, the pipeline)")


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_collective = True

    def init(self, role_maker=None, is_collective=True, strategy=None):
        self._strategy = strategy or DistributedStrategy()
        self._is_collective = is_collective
        _env.init_parallel_env()
        hc = self._strategy.hybrid_configs
        dims = {"data": hc.dp_degree, "pipe": hc.pp_degree,
                "sharding": hc.sharding_degree,
                "sep": hc.get("sep_degree", 1), "model": hc.mp_degree}
        if dims["pipe"] > 1:
            raise NotImplementedError(PIPE_NOT_PORTED)
        world = _env.get_world_size()
        known = int(np.prod([v for k, v in dims.items() if k != "data"]))
        if dims["data"] * known != world and world % known == 0:
            dims["data"] = world // known
        topo = CommunicateTopology(list(dims), list(dims.values()))
        if topo.world_size() != world:
            raise ValueError(f"hybrid_configs {dims} need "
                             f"{topo.world_size()} ranks, the world has "
                             f"{world}")
        self._hcg = HybridCommunicateGroup(topo)
        set_hybrid_communicate_group(self._hcg)
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg or _get_hcg()

    @property
    def worker_index(self):
        return _env.get_rank()

    @property
    def worker_num(self):
        return _env.get_world_size()

    def is_first_worker(self):
        return _env.get_rank() == 0

    def barrier_worker(self):
        from .. import collective as C
        C.barrier()

    def distributed_model(self, model):
        hcg = self.get_hybrid_communicate_group()
        if hcg is not None and hcg.get_model_parallel_world_size() > 1:
            from .meta_parallel.tensor_parallel import TensorParallel
            return TensorParallel(model, hcg, self._strategy)
        if _env.get_world_size() > 1:
            return DataParallel(model, group=hcg.get_data_parallel_group()
                                if hcg else None)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        hcg = self.get_hybrid_communicate_group()
        if hcg is not None and hcg.get_model_parallel_world_size() > 1:
            from .meta_parallel.hybrid_parallel_optimizer import \
                HybridParallelOptimizer
            return HybridParallelOptimizer(
                optimizer, hcg, self._strategy or DistributedStrategy())
        return optimizer

    def state_dict(self):
        return {}


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None):
    return fleet.init(role_maker, is_collective, strategy)


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def get_hybrid_communicate_group():
    return fleet.get_hybrid_communicate_group()


def worker_index():
    return fleet.worker_index


def worker_num():
    return fleet.worker_num


def is_first_worker():
    return fleet.is_first_worker()


def barrier_worker():
    return fleet.barrier_worker()
