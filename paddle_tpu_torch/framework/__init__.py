"""Framework utilities of the PyTorch port (counterpart of
``paddle_tpu/framework``): ``io`` (``paddle.save`` / ``paddle.load``),
``device`` and ``custom_device``."""
from . import custom_device, device, io  # noqa: F401
