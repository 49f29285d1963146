"""``paddle.distributed.fleet`` of the PyTorch port: the collective path
(``init``, ``distributed_model``, ``distributed_optimizer``,
``DistributedStrategy``, the role makers), ``meta_parallel``, ``utils``
(``recompute``: the module, as the reference exports it,
``paddle_tpu/distributed/fleet/__init__.py:15``) and
``meta_optimizers``. The parameter server (``heter``), ``data_generator``
and ``elastic`` are not ported yet: ROADMAP Queue 1 item 15."""
from __future__ import annotations

from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import (Fleet, barrier_worker,  # noqa: F401
                         distributed_model, distributed_optimizer, fleet,
                         get_hybrid_communicate_group, init,
                         is_first_worker, worker_index, worker_num)
from .role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                         UserDefinedRoleMaker)
from . import meta_parallel  # noqa: F401
from . import meta_optimizers, utils  # noqa: F401
from .utils import recompute  # noqa: F401

_NOT_PORTED = {"heter", "data_generator", "elastic"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle.distributed.fleet.{name} is not ported yet: ROADMAP "
            f"Queue 1 item 15")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
