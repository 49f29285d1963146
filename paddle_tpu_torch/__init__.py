"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names (``paddle_tpu_torch/X`` ports ``paddle_tpu/X``) and imports
neither JAX nor ``paddle_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``. Every TPU kernel on a ported path is a
kernel written by hand for ``sm_90a`` under ``ops/kernels/``.

Ported so far (README.md, "The PyTorch/CUDA port", has the module map):
paged Llama serving and the serving engine with its options and
multi-replica layer (``serving``, ``models.nlp.llama_decode``); the Llama
training step in its GQA, multi-head and sliding-window forms and its
options; the fused transformer layers (``incubate.nn``) and fused norms;
BERT, GPT, ``nn.Transformer`` and ``FusedMultiTransformer``; the vision
models (ResNet, LeNet) and their ``nn``; the Mixture-of-Experts model; and
the eager training API: ``optimizer`` (9 optimizers, 15 schedulers in
``optimizer.lr``), ``amp`` (``auto_cast``, ``decorate``,
``GradScaler``), ``autograd`` (``grad``, ``PyLayer``), ``regularizer``,
``nn.initializer`` with ``ParamAttr``, the gradient clips, the losses, and
the op dispatch (``ops.dispatch``) the amp casts go through.
"""
from . import amp, autograd, optimizer, regularizer  # noqa: F401
from .autograd import (PyLayer, PyLayerContext, enable_grad,  # noqa: F401
                       grad, no_grad, set_grad_enabled)
from .core import convert_dtype, resolve_device, seed  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .nn import ParamAttr  # noqa: F401
from .ops.dispatch import enable_static  # noqa: F401

__version__ = "0.1.0"
