"""nn of the PyTorch port (counterpart of ``paddle_tpu/nn``): the layers
and functions the fused transformer layers of ``incubate.nn`` and BERT
are built from. Every layer is a ``torch.nn.Module`` that takes
``device`` (``cuda`` unless ``"cpu"`` is asked for; without a card a
default or ``"cuda"`` device raises) and, where it draws random numbers,
``generator``."""
from . import functional  # noqa: F401
from .layer import (Dropout, Embedding, LayerNorm, Linear,  # noqa: F401
                    MultiHeadAttention, RMSNorm, TransformerEncoder,
                    TransformerEncoderLayer, load_numpy_state_dict)
