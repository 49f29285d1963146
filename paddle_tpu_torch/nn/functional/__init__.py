"""nn.functional of the PyTorch port (counterpart of
``paddle_tpu/nn/functional``): the pieces the fused transformer layers,
BERT, the vision models and the eager training loop use."""
from .activation import gelu, relu, tanh  # noqa: F401
from .attention import (block_sparse_attention,  # noqa: F401
                        scaled_dot_product_attention, sparse_attention)
from .common import dropout, embedding, gather_tree, linear  # noqa: F401
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, dice_loss, hinge_embedding_loss,
                   hsigmoid_loss, huber_loss, kl_div, l1_loss, log_loss,
                   margin_cross_entropy, margin_ranking_loss, mse_loss,
                   nll_loss, npair_loss, sigmoid_focal_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .norm import batch_norm, layer_norm  # noqa: F401
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, avg_pool1d, avg_pool2d,
                      avg_pool3d, max_pool1d, max_pool2d, max_pool3d)
