"""Activations of ``nn.functional`` in the PyTorch port: ``gelu``,
``relu`` and ``tanh``, the ops of the op namespace (``ops.activation``,
``ops.math``: the spec table's ``gelu``, ``relu`` and ``tanh``, whose
``gelu`` is the exact erf form unless ``approximate=True``)."""
from ...ops.activation import gelu, relu  # noqa: F401
from ...ops.math import tanh  # noqa: F401
