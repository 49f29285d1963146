"""``paddle.distributed.fleet`` of the PyTorch port: the collective path
(``init``, ``distributed_model``, ``distributed_optimizer``,
``DistributedStrategy``, the role makers) and ``meta_parallel``. The
parameter server (``heter``), ``data_generator`` and ``utils.recompute``
are not ported yet: ROADMAP Queue 1 item 15."""
from __future__ import annotations

from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import (Fleet, barrier_worker,  # noqa: F401
                         distributed_model, distributed_optimizer, fleet,
                         get_hybrid_communicate_group, init,
                         is_first_worker, worker_index, worker_num)
from .role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                         UserDefinedRoleMaker)
from . import meta_parallel  # noqa: F401

_NOT_PORTED = {"heter", "data_generator", "utils", "recompute", "elastic",
               "meta_optimizers"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle.distributed.fleet.{name} is not ported yet: ROADMAP "
            f"Queue 1 item 15")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
