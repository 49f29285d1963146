"""paddle_tpu_torch.quantization — the int8 weight codec and product of
the port.

Counterpart of ``paddle_tpu/quantization``; only what the decode path
runs is ported: ``quantize_stacked`` (per-output-channel int8 of
layer-stacked weights) and ``int8_matmul`` (int8 x int8 -> int32 with a
dynamic per-tensor activation scale). PTQ / QAT, the observers and
``Int8Linear`` are not ported yet (ROADMAP item 14).
"""
from .int8 import QMAX, int8_matmul, quantize_stacked  # noqa: F401
