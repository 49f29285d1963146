"""hapi of the PyTorch port (counterpart of ``paddle_tpu/hapi``): the
keras-style ``Model`` with its callbacks, ``summary`` and ``flops``."""
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger)
from .model import Model, flops, summary  # noqa: F401
