from .paged_attention import (PagedKVCache, paged_attention,  # noqa: F401
                              paged_attention_reference,
                              paged_prefill_attention)
