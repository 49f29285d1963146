"""Layers of the PyTorch port (counterpart of ``paddle_tpu/nn/layer``),
each a ``Layer`` (a ``torch.nn.Module`` with Paddle's names) made on the
default device or the one its ``device`` names."""
from .activation import (CELU, ELU, GELU, GLU, Hardshrink,  # noqa: F401
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
                         ReLU6, SELU, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, ChannelShuffle,  # noqa: F401
                     CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                     Embedding, Flatten, Fold, Identity, Linear, Pad1D,
                     Pad2D, Pad3D, PairwiseDistance, PixelShuffle,
                     PixelUnshuffle, Softmax2D, Unfold, Upsample,
                     UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layers import (HookRemoveHelper, Layer, LayerDict,  # noqa: F401
                     LayerList, ParameterList, Sequential, create_parameter,
                     load_numpy_state_dict)
from .loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                   CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss,
                   HingeEmbeddingLoss, HSigmoidLoss, HuberLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
                   SmoothL1Loss, TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, GroupNorm, InstanceNorm1D, InstanceNorm2D,
                   InstanceNorm3D, LayerNorm, LocalResponseNorm, RMSNorm,
                   SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                      MaxUnPool1D, MaxUnPool2D, MaxUnPool3D)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .rnn import (GRU, LSTM, RNN, BiRNN, BeamSearchDecoder,  # noqa: F401
                  GRUCell, LSTMCell, RNNCellBase, SimpleRNN, SimpleRNNCell,
                  dynamic_decode)
