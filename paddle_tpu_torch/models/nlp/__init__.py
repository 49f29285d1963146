from .llama import (LlamaConfig, LlamaForCausalLM, apply_rotary,  # noqa: F401
                    load_numpy_state_dict)
from .llama_decode import llama_paged_decode_factory  # noqa: F401
from .llama_functional import (LAYER_KEYS, split_params,  # noqa: F401
                               stack_layers)
