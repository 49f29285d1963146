"""nn of the PyTorch port (counterpart of ``paddle_tpu/nn``): the layers
and functions the fused transformer layers of ``incubate.nn``, BERT, GPT
and the vision models are built from, the encoder-decoder
``Transformer``, the recurrent layers with beam search (``layer.rnn``),
the losses, the initializers and ``ParamAttr``, and the gradient clips
the optimizers take. Every layer is a ``torch.nn.Module``
that takes ``device`` (``cuda`` unless ``"cpu"`` is asked for; without a
card a default or ``"cuda"`` device raises) where it holds parameters or
buffers and, where it draws random numbers, ``generator``."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                    AdaptiveAvgPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                    BCELoss, BCEWithLogitsLoss, Conv1D, Conv2D, Conv3D,
                    CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss, Dropout,
                    Embedding, Flatten, HingeEmbeddingLoss, HSigmoidLoss,
                    HuberLoss, KLDivLoss, L1Loss, LayerNorm, Linear,
                    MarginRankingLoss, MaxPool1D, MaxPool2D, MaxPool3D,
                    MSELoss, MultiHeadAttention, NLLLoss, ReLU, RMSNorm,
                    Sequential, SmoothL1Loss, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer,
                    TripletMarginLoss, load_numpy_state_dict)
from .layer.rnn import (GRU, LSTM, RNN, BiRNN,  # noqa: F401
                        BeamSearchDecoder, GRUCell, LayerList, LSTMCell,
                        RNNCellBase, SimpleRNN, SimpleRNNCell,
                        dynamic_decode)


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / the global norm of all
    of them) (``paddle_tpu/nn/__init__.py:54``); read by the optimizers'
    ``_apply_grad_clip``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class ClipGradByNorm:
    """Scale each gradient by min(1, clip_norm / its own norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class ClipGradByValue:
    """Clamp each gradient to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max
