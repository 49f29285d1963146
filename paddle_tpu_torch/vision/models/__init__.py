"""Vision models of the PyTorch port (counterpart of
``paddle_tpu/vision/models``): LeNet and the ResNet family."""
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnet_train_step_factory, resnext50_32x4d,
    resnext50_64x4d, resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
    resnext152_64x4d, wide_resnet50_2, wide_resnet101_2)
