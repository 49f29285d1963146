"""The model-parallel layers and random state of the PyTorch port
(``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers``). The
pipeline layers (``LayerDesc``, ``PipelineLayer``, ``SegmentLayers``,
``SharedLayerDesc``) are not ported yet: ROADMAP Queue 1 item 15."""
from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding)
from .random import (RNGStatesTracker,  # noqa: F401
                     get_rng_state_tracker, model_parallel_random_seed)
