"""nn.functional of the PyTorch port (counterpart of
``paddle_tpu/nn/functional``): every public name of the reference's but
the transposed convolutions (ROADMAP item 16)."""
from . import vision  # noqa: F401
from .activation import (celu, elu, elu_, gelu, glu,  # noqa: F401
                         gumbel_softmax, hardshrink, hardsigmoid, hardswish,
                         hardtanh, leaky_relu, log_sigmoid, log_softmax,
                         maxout, mish, prelu, relu, relu6, relu_, selu,
                         sigmoid, silu, softmax, softmax_, softplus,
                         softshrink, softsign, swish, tanh, tanh_,
                         tanhshrink, thresholded_relu)
from .attention import (block_sparse_attention,  # noqa: F401
                        scaled_dot_product_attention, sparse_attention)
from .common import (alpha_dropout, bilinear, channel_shuffle,  # noqa: F401
                     class_center_sample, cosine_similarity, diag_embed,
                     dropout, dropout2d, dropout3d, embedding, fold,
                     gather_tree, interpolate, label_smooth, linear,
                     one_hot, pad, pixel_shuffle, pixel_unshuffle,
                     sequence_mask, unfold, upsample, zeropad2d)
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, dice_loss, hinge_embedding_loss,
                   hsigmoid_loss, huber_loss, kl_div, l1_loss, log_loss,
                   margin_cross_entropy, margin_ranking_loss, mse_loss,
                   nll_loss, npair_loss, sigmoid_focal_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, normalize)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d, max_unpool1d, max_unpool2d, max_unpool3d)
from .vision import affine_grid, grid_sample, temporal_shift  # noqa: F401
