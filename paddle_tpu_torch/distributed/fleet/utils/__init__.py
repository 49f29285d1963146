"""``paddle.distributed.fleet.utils`` of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/utils/__init__.py``): the file-system
clients (``fs``: ``FS``, ``LocalFS``, ``HDFSClient``), activation
recompute (``recompute``, the module; ``recompute_fn``, its function) and
the fused buffers (``internal_storage``: ``TensorBucket``, ``GradStorage``,
``ParamStorage``, ``fused_all_reduce``). ``hybrid_parallel_inference``
(``HybridParallelInferenceHelper``) needs the fleet executor and waits for
the pipeline: ROADMAP Queue 1 item 15.4."""
from . import fs, recompute  # noqa: F401
from .fs import FS, HDFSClient, LocalFS  # noqa: F401
from .recompute import recompute as recompute_fn  # noqa: F401
from . import internal_storage  # noqa: F401,E402
from .internal_storage import (GradStorage,  # noqa: F401,E402
                               ParamStorage, TensorBucket,
                               fused_all_reduce)

_NOT_PORTED = {"hybrid_parallel_inference", "HybridParallelInferenceHelper"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle.distributed.fleet.utils.{name} is not ported yet: "
            f"ROADMAP Queue 1 item 15.4 (the pipeline and the fleet "
            f"executor)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
