"""Optimizers and learning-rate schedulers of the PyTorch port
(counterpart of ``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum, Optimizer,
    RMSProp, SGD,
)
