"""vision of the PyTorch port (counterpart of ``paddle_tpu/vision``): the
MNIST dataset, LeNet and the ResNet family with its train step."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from .datasets import MNIST  # noqa: F401
