"""vision of the PyTorch port (counterpart of ``paddle_tpu/vision``): the
datasets, LeNet and the ResNet family with its train step."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from .datasets import (MNIST, VOC2012, Cifar10, Cifar100,  # noqa: F401
                       DatasetFolder, FashionMNIST, Flowers, ImageFolder)
