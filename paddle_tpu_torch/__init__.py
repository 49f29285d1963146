"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names (``paddle_tpu_torch/X`` ports ``paddle_tpu/X``) and imports
neither JAX nor ``paddle_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``. Every TPU kernel on a ported path is a
kernel written by hand for ``sm_90a`` under ``ops/kernels/``.

Ported so far: paged Llama serving (``models.nlp.LlamaForCausalLM``,
``models.nlp.llama_paged_decode_factory``, ``ops.PagedKVCache``, driven
by ``examples.serve_paged_llama``); the Llama training step in its GQA,
multi-head and sliding-window forms (``models.nlp.llama_train_step_
factory``, ``examples.train_llama_compiled``); the fused transformer
encoder (``incubate.nn.FusedTransformerEncoderLayer`` over the ``nn``
layers) and the fused LayerNorm / RMSNorm entry points
(``ops.fused_layer_norm``, ``ops.fused_rms_norm``).
"""
from .core import convert_dtype, resolve_device, seed  # noqa: F401

__version__ = "0.1.0"
