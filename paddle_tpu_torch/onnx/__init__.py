"""paddle_tpu_torch.onnx — ONNX model export of the PyTorch port.

Counterpart of ``paddle_tpu/onnx/__init__.py`` (``:16-61``): the layer's
forward is captured into a static Program, and the converter in
``exporter.py`` maps the DAG to ONNX nodes written by ``proto.py`` (no
``onnx`` package). A model with an op that has no converter (the flash
attention of a transformer, ``scaled_dot_product_attention``) is written
instead as ``jit.save``'s artifact set (``.pdmodel``, ``.pdexport`` with
the ``torch.export`` program, ``.pdiparams``, ``.pdmeta``), with a
warning that names that format, unless ``fallback_stablehlo=False`` (the
reference's name of the switch).
"""
from __future__ import annotations

import warnings

from . import proto  # noqa: F401
from .exporter import (OP_CONVERTERS, UnsupportedOp,  # noqa: F401
                       program_to_onnx)


def export(layer, path, input_spec=None, opset_version=13, **configs):
    """Write ``<path>.onnx`` (ONNX protobuf) and return its path; or, for
    an op without a converter, ``jit.save``'s artifacts at ``path`` (a
    warning) and return ``path``. Requires ``input_spec``."""
    from .. import jit
    from ..jit import InputSpec
    from ..static import graph as _sg

    fallback = configs.pop("fallback_stablehlo", True)
    if input_spec is None:
        raise ValueError("onnx.export requires input_spec")
    specs = [s if isinstance(s, InputSpec) else InputSpec(s)
             for s in input_spec]
    main, startup = _sg.Program(), _sg.Program()
    was_static = _sg.in_static_mode()
    try:
        _sg.enable_static()
        with _sg.program_guard(main, startup):
            feeds = [_sg.data(f"x{i}", s.shape, dtype=s.dtype)
                     for i, s in enumerate(specs)]
            out = layer(*feeds) if callable(layer) else layer.forward(*feeds)
        fetches = list(out) if isinstance(out, (tuple, list)) else [out]
        blob = program_to_onnx(feeds, fetches,
                               graph_name=type(layer).__name__)
    except UnsupportedOp:
        if not fallback:
            raise
        if not was_static:
            _sg.disable_static()
        warnings.warn(
            "model contains ops without ONNX converters; wrote the "
            f"torch.export artifact set of jit.save ({path}.pdexport) "
            "instead", stacklevel=2)
        jit.save(layer, path, input_spec=input_spec)
        return path
    finally:
        if not was_static:
            _sg.disable_static()

    target = path if path.endswith(".onnx") else path + ".onnx"
    with open(target, "wb") as f:
        f.write(blob)
    return target
