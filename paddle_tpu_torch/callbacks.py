"""``paddle.callbacks`` of the PyTorch port: hapi's callbacks
(counterpart of ``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (Callback, EarlyStopping,  # noqa: F401
                             LRScheduler, ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, VisualDL)
