"""DistributedStrategy of the PyTorch port: a copy of
``paddle_tpu/distributed/fleet/distributed_strategy.py`` (pure Python):
the typed config tree of ``distributed_strategy.proto``'s defaults, as
plain dicts with attribute access."""
from __future__ import annotations

import copy


class _Config(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        # ~ distributed_strategy.proto defaults
        self.amp = False
        self.amp_configs = _Config(
            init_loss_scaling=32768.0, custom_white_list=[],
            custom_black_list=[], use_pure_fp16=False, use_bf16=True)
        self.recompute = False
        self.recompute_configs = _Config(checkpoints=[])
        self.pipeline = False
        self.pipeline_configs = _Config(
            micro_batch_size=1, accumulate_steps=1, schedule_mode="1F1B")
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Config(
            tensor_parallel_degree=1, tensor_init_seed=-1)
        self.sharding = False
        self.sharding_configs = _Config(
            sharding_degree=1, stage=1, offload=False,
            segment_broadcast_MB=32.0)
        self.hybrid_configs = _Config(
            dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1,
            sep_degree=1)
        self.gradient_merge = False
        self.gradient_merge_configs = _Config(k_steps=1, avg=True)
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = _Config(scale_strategy="avg")
        self.heter_ccl_mode = False
        self.a_sync = False
        self.a_sync_configs = _Config(k_steps=-1)
        self.auto = False
        self.semi_auto = False
        self.elastic = False

    def __setattr__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, _Config):
            cur = self.__dict__.get(k)
            if isinstance(cur, _Config):
                cur.update(v)
                return
            v = _Config(v)
        object.__setattr__(self, k, v)

    def __deepcopy__(self, memo):
        new = DistributedStrategy()
        for k, v in self.__dict__.items():
            object.__setattr__(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self):
        on = [k for k, v in self.__dict__.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
