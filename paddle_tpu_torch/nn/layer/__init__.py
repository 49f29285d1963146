"""Layers of the PyTorch port (counterpart of ``paddle_tpu/nn/layer``),
each a ``torch.nn.Module`` made on an explicit device."""
from .activation import ReLU  # noqa: F401
from .common import Dropout, Embedding, Flatten, Linear  # noqa: F401
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layers import Sequential, load_numpy_state_dict  # noqa: F401
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, LayerNorm, RMSNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                      AdaptiveAvgPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                      MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
