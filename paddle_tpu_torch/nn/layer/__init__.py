"""Layers of the PyTorch port (counterpart of ``paddle_tpu/nn/layer``),
each a ``torch.nn.Module`` made on an explicit device."""
from .common import Dropout, Embedding, Linear  # noqa: F401
from .layers import load_numpy_state_dict  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
