"""``ShardingParallel`` of the PyTorch port.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
sharding_parallel.py``, the model side of ZeRO (``distributed.sharding``):
the wrapped layer's forward; after each backward its gradients averaged
over the sharding group (ZeRO is data parallelism whose optimizer state,
and at stage 3 parameters, are split over the group: each rank steps its
own batch), as ``DataParallel`` does; the state dict full, as
``TensorParallel``'s.
"""
from __future__ import annotations

from ...parallel import DataParallel
from .tensor_parallel import full_state_dict, set_full_state_dict


class ShardingParallel(DataParallel):
    def __init__(self, layers, hcg, strategy=None, group=None):
        group = group if group is not None else (
            hcg.get_sharding_parallel_group() if hcg is not None else None)
        super().__init__(layers, group=group)
        self._hcg = hcg

    def state_dict(self, *a, **kw):
        return full_state_dict(self._layers, self._hcg)

    def set_state_dict(self, state_dict, *a, **kw):
        return set_full_state_dict(self._layers, state_dict, self._hcg)
