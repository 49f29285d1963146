from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel,
                   bert_pretrain_step_factory)
from .llama import (LlamaConfig, LlamaForCausalLM, apply_rotary,  # noqa: F401
                    llama_train_step_factory, load_numpy_state_dict)
from .llama_decode import llama_paged_decode_factory  # noqa: F401
from .llama_functional import (LAYER_KEYS, param_views,  # noqa: F401
                               split_params, stack_layers)
from .train_utils import adamw_update, make_adamw_state  # noqa: F401
