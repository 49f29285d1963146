"""``fleet.meta_parallel`` of the PyTorch port: the tensor-parallel layers,
the parallel wrappers and the hybrid optimizer. ``PipelineParallel`` and
the pipeline layers are not ported yet (ROADMAP Queue 1 item 15)."""
from .parallel_layers import (ColumnParallelLinear,  # noqa: F401
                              ParallelCrossEntropy, RNGStatesTracker,
                              RowParallelLinear, VocabParallelEmbedding,
                              get_rng_state_tracker,
                              model_parallel_random_seed)
from .tensor_parallel import TensorParallel  # noqa: F401
from .sharding_parallel import ShardingParallel  # noqa: F401
from .hybrid_parallel_optimizer import (  # noqa: F401
    HybridParallelClipGrad, HybridParallelOptimizer)
