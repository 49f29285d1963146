"""incubate of the PyTorch port (counterpart of ``paddle_tpu/incubate``,
whose ``__init__`` imports its subpackages, ``:7-13``): the fused
transformer layers of ``incubate.nn`` and the Mixture-of-Experts layer of
``incubate.distributed``, imported with the package, so that
``paddle.incubate.nn.FusedMultiTransformer`` resolves after ``import
paddle_tpu_torch as paddle``. The reference's other names (functional
autograd, autotune, checkpoint, multiprocessing, the graph ops, ``asp``,
``LookAhead`` / ``ModelAverage``) are not ported yet and are refused by
name: ROADMAP Queue 1 item 16."""
from . import distributed  # noqa: F401
from . import nn  # noqa: F401

_NOT_PORTED = {
    "autograd", "autotune", "checkpoint", "multiprocessing", "optimizer",
    "LookAhead", "ModelAverage", "graph_ops", "graph_khop_sampler",
    "graph_reindex", "graph_sample_neighbors", "graph_send_recv",
    "segment_max", "segment_mean", "segment_min", "segment_sum",
    "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle", "asp",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle.incubate.{name} is not ported yet: ROADMAP Queue 1 item "
            f"16")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
