"""The parallelism primitives of the PyTorch port
(``paddle_tpu/parallel``): ``shard_map_attention`` runs the attention
kernels on a rank's own heads. The pipeline (``pipeline_apply``,
``stack_stage_params``), ring attention and Ulysses attention are not
ported yet: ROADMAP Queue 1 item 15."""
from .pallas_sharding import (LocalHeads, local_heads,  # noqa: F401
                              shard_map_attention)

_NOT_PORTED = {"pipeline", "pipeline_apply", "stack_stage_params",
               "ring_attention", "ulysses", "ulysses_attention"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle.parallel.{name} is not ported yet: ROADMAP Queue 1 item "
            f"15 (ring and Ulysses attention, the pipeline)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
