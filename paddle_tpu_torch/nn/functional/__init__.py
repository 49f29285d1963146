"""nn.functional of the PyTorch port (counterpart of
``paddle_tpu/nn/functional``): the pieces the fused transformer layers
and BERT use."""
from .activation import gelu, relu, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
