"""The op layer of the PyTorch port: the op namespace and the kernels.

Counterpart of ``paddle_tpu/ops/__init__.py``: the op families
(``creation``, ``math``, ``reduction``, ``manipulation``, ``linalg``,
``activation``, ``misc``, ``array_ops``), each op going through the op
dispatch (``dispatch.apply_op``) under the reference's name; the spec
table's default group (``codegen.SPECS``) generated here; ``infer_meta``;
and the Paddle tensor methods torch lacks, attached to ``torch.Tensor``
(``tensor_methods.install``). Beside them, the wrappers of the
hand-written Hopper kernels (paged, flash and splash attention, the fused
cross-entropy, the norms).

Dtypes are the JAX package's, whose 64-bit types are off: a requested
64-bit type gives the 32-bit one (``cast(x, "int64")`` is int32), and an
op gives a 64-bit result only when handed a 64-bit tensor (torch's int64
indices and sums of int32 are int32 here: ``_util.narrow``).
"""
from .dispatch import OP_REGISTRY, apply_op, def_op  # noqa: F401
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .activation import *  # noqa: F401,F403
from .misc import *  # noqa: F401,F403
from .array_ops import *  # noqa: F401,F403
from . import (activation as _activation, array_ops as _array_ops,
               creation as _creation, linalg as _linalg,
               manipulation as _manipulation, math as _math, misc as _misc,
               reduction as _reduction)
from . import codegen as _codegen
from . import tensor_methods as _tm
from .codegen import infer_meta  # noqa: F401

from .dropout_ln import fused_dropout_add_layer_norm  # noqa: F401
from .flash_attention import flash_eligible  # noqa: F401
from .flash_attention_gqa import grouped_flash_attention  # noqa: F401
from .fused_ce import causal_lm_loss, softmax_cross_entropy  # noqa: F401
from .layer_norm import fused_layer_norm, fused_rms_norm  # noqa: F401
from .paged_attention import (PagedKVCache, paged_attention,  # noqa: F401
                              paged_attention_reference,
                              paged_prefill_attention)

# the spec table's default group, generated into this namespace
_generated_ops = _codegen.generate(globals(),
                                   exclude_groups={"math", "activation"})
_tm.install()

__all__ = ["OP_REGISTRY", "apply_op", "def_op", "infer_meta",
           *_generated_ops] + [n for m in (
               _creation, _math, _reduction, _manipulation, _linalg,
               _activation, _misc, _array_ops) for n in m.__all__]
