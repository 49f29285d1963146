"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names (``paddle_tpu_torch/X`` ports ``paddle_tpu/X``) and imports
neither JAX nor ``paddle_tpu``. Entry points run on the default device,
``cuda`` unless ``set_device("cpu")`` was called or the caller passes
``device="cpu"``. Every TPU kernel on a ported path is a kernel written by
hand for ``sm_90a`` under ``ops/kernels/``.

A Paddle user script runs as ``import paddle_tpu_torch as paddle``:
``paddle.set_device("gpu")``, ``paddle.to_tensor``, the op namespace
(``paddle.reshape``, ``paddle.concat``, ``paddle.zeros``, ...: the
``ops`` families, each op through the op dispatch), the dtype names as
torch dtypes, ``paddle.tensor``, the control flow (``cond``,
``while_loop``, ...), and ``x.astype(...)`` and the other Paddle tensor
methods torch lacks, attached to ``torch.Tensor``.

Ported so far (README.md, "The PyTorch/CUDA port", has the module map):
paged Llama serving and the serving engine with its options and
multi-replica layer (``serving``, ``models.nlp.llama_decode``); the Llama
training step in its GQA, multi-head and sliding-window forms and its
options; the fused transformer layers (``incubate.nn``) and fused norms;
BERT, GPT, ``nn.Transformer`` and ``FusedMultiTransformer``; the vision
models (ResNet, LeNet) and their ``nn``; the Mixture-of-Experts model; the
eager training API (``optimizer``, ``amp``, ``autograd``,
``regularizer``, ``nn.initializer`` with ``ParamAttr``, the gradient
clips, the losses, the op dispatch); the op namespace; ``nn``'s
recurrent layers with beam search; ``nn.Layer``; and a script's data and
training loop: ``io`` (datasets, samplers, ``DataLoader`` with
shared-memory worker processes), ``save`` / ``load``, ``device``,
``metric``, ``callbacks`` and hapi's ``Model`` with ``summary`` and
``flops``; and the deployment path: ``jit`` (``to_static`` with the
dy2static pass and captured control flow, ``save`` / ``load``),
``inference`` (``Config``, ``Predictor``, ``DynamicBatcher``) and
``quantization`` (QAT, PTQ, ``Int8Linear``); and static graphs:
``enable_static`` / ``disable_static``, ``static`` (``Program``,
``data``, ``Executor`` with ``append_backward`` and ``minimize``,
``static.nn``, the passes, ``save_inference_model``), ``onnx.export`` and
hapi's ``StaticGraphAdapter``; and several processes: ``distributed``
(process groups and collectives over ``torch.distributed``, the hybrid
topology and mesh, ``DataParallel``, fleet's tensor-parallel layers,
hybrid optimizer, utilities and meta-optimizers, ZeRO) with the Llama
train step on a mesh, its "sep" axis included (ring, window-ring and
Ulysses attention: ``parallel``).
Importing the package registers the kernel operators
(``paddle_tpu_torch::gqa_fwd``) that a saved program names.
"""
import torch as _torch

from .ops import *  # noqa: F401,F403
from .ops.manipulation import slice_ as slice  # noqa: F401,A001
from .ops.control_flow import (case, cond, scan,  # noqa: F401
                               switch_case, while_loop)
from .core.dtype import (finfo, get_default_dtype,  # noqa: F401
                         iinfo, set_default_dtype)
from .core.place import (CPUPlace, CUDAPinnedPlace,  # noqa: F401
                         CUDAPlace, Place, device_count, get_device,
                         set_device)
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from . import amp, autograd, fft, nn, optimizer, regularizer  # noqa: F401
from . import ops, tensor  # noqa: F401
from .autograd import (PyLayer, PyLayerContext, enable_grad,  # noqa: F401
                       grad, no_grad, set_grad_enabled)
from .core import (convert_dtype, get_rng_state,  # noqa: F401
                   resolve_device, seed, set_rng_state)
from .core.flags import get_flags, set_flags  # noqa: F401
from .nn import ParamAttr  # noqa: F401
from . import callbacks, framework, hapi, io, metric, vision  # noqa: F401
from .framework import device  # noqa: F401
from .framework.device import (get_cudnn_version,  # noqa: F401
                               is_compiled_with_cinn, is_compiled_with_cuda,
                               is_compiled_with_ipu, is_compiled_with_mlu,
                               is_compiled_with_npu, is_compiled_with_rocm,
                               is_compiled_with_xpu)
from .framework.io import load, save  # noqa: F401
from .hapi import Model, flops, summary  # noqa: F401
from . import inference, jit, quantization, static  # noqa: F401
from . import onnx  # noqa: F401
from . import distributed, incubate, parallel  # noqa: F401
from .distributed.parallel import DataParallel  # noqa: F401
from .static.graph import disable_static, enable_static  # noqa: F401

# the dtype names, as torch dtypes (paddle_tpu/__init__.py:11-14, 80-81)
float16, bfloat16, float32, float64 = (_torch.float16, _torch.bfloat16,
                                       _torch.float32, _torch.float64)
int8, int16, int32, int64, uint8 = (_torch.int8, _torch.int16, _torch.int32,
                                    _torch.int64, _torch.uint8)
complex64, complex128 = _torch.complex64, _torch.complex128
bool = bool_ = _torch.bool  # noqa: A001
dtype = _torch.dtype

__version__ = "0.1.0"

is_grad_enabled = _torch.is_grad_enabled


def in_dynamic_mode() -> bool:
    """False between ``enable_static()`` and ``disable_static()``."""
    return not static.in_static_mode()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """``paddle.set_printoptions``: torch's, which prints the port's
    tensors (the reference sets numpy's, which print its)."""
    _torch.set_printoptions(precision=precision, threshold=threshold,
                            edgeitems=edgeitems, linewidth=linewidth,
                            sci_mode=sci_mode)


def batch(reader, batch_size, drop_last=False):
    """``paddle.batch``: a reader of lists of ``batch_size`` items from
    ``reader`` (the last one shorter unless ``drop_last``)."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched
