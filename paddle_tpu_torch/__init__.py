"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names (``paddle_tpu_torch/X`` ports ``paddle_tpu/X``) and imports
neither JAX nor ``paddle_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``. Every TPU kernel on a ported path is a
kernel written by hand for ``sm_90a`` under ``ops/kernels/``.

Ported so far: paged Llama serving — ``models.nlp.LlamaForCausalLM``,
``models.nlp.llama_paged_decode_factory``, ``ops.PagedKVCache`` and the
paged-attention kernel, driven by ``examples.serve_paged_llama``.
"""
from .core import convert_dtype, resolve_device  # noqa: F401

__version__ = "0.1.0"
