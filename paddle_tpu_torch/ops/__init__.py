from .dropout_ln import fused_dropout_add_layer_norm  # noqa: F401
from .flash_attention import flash_eligible  # noqa: F401
from .flash_attention_gqa import grouped_flash_attention  # noqa: F401
from .fused_ce import causal_lm_loss, softmax_cross_entropy  # noqa: F401
from .layer_norm import fused_layer_norm, fused_rms_norm  # noqa: F401
from .manipulation import flatten  # noqa: F401
from .paged_attention import (PagedKVCache, paged_attention,  # noqa: F401
                              paged_attention_reference,
                              paged_prefill_attention)
