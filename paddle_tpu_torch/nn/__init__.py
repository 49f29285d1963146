"""nn of the PyTorch port (counterpart of ``paddle_tpu/nn``): the layers
and functions the fused transformer layers of ``incubate.nn``, BERT, GPT
and the vision models are built from, and the encoder-decoder
``Transformer``. Every layer is a ``torch.nn.Module`` that takes
``device`` (``cuda`` unless ``"cpu"`` is asked for; without a card a
default or ``"cuda"`` device raises) where it holds parameters or buffers
and, where it draws random numbers, ``generator``."""
from . import functional  # noqa: F401
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                    AdaptiveAvgPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                    Conv1D, Conv2D, Conv3D, Dropout, Embedding, Flatten,
                    LayerNorm, Linear, MaxPool1D, MaxPool2D, MaxPool3D,
                    MultiHeadAttention, ReLU, RMSNorm, Sequential,
                    Transformer, TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer,
                    load_numpy_state_dict)
