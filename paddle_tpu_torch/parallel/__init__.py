"""The parallelism primitives of the PyTorch port
(``paddle_tpu/parallel``): ``shard_map_attention`` runs the attention
kernels on a rank's own heads; ``ring_attention`` (with
``ring_window_attention``) and ``ulysses_attention`` run them over a
sequence whose chunks lie on the ranks of a "sep" axis. The pipeline
(``pipeline_apply``, ``stack_stage_params``) is not ported yet: ROADMAP
Queue 1 item 15."""
from .pallas_sharding import (LocalHeads, local_heads,  # noqa: F401
                              shard_map_attention)
from .ring_attention import (ring_attention,  # noqa: F401
                             ring_window_active_steps, ring_window_attention)
from .ulysses import ulysses_attention  # noqa: F401

_NOT_PORTED = {"pipeline", "pipeline_apply", "stack_stage_params"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle.parallel.{name} is not ported yet: ROADMAP Queue 1 item "
            f"15 (the pipeline)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
