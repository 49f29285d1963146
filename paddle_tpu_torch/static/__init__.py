"""paddle_tpu_torch.static — the static-graph API of the PyTorch port.

Counterpart of ``paddle_tpu/static/__init__.py``. Only ``InputSpec`` is
ported, which the reference re-exports from ``jit`` (``:12``); Program,
Executor, ``data``, ``save_inference_model`` and the rest of ``static``
are ROADMAP Queue 1 item 14's remainder (static, onnx).
"""
from ..jit import InputSpec  # noqa: F401

__all__ = ["InputSpec"]
