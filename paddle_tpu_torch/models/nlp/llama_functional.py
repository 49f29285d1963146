"""Functional Llama helpers for the PyTorch port: the stacked-layer
convention and RMSNorm. Counterpart of
``paddle_tpu/models/nlp/llama_functional.py:28-72``."""
from __future__ import annotations

from typing import Dict

import torch

from .llama import LlamaForCausalLM

LAYER_KEYS = [
    "input_layernorm.weight",
    "self_attn.q_proj.weight", "self_attn.k_proj.weight",
    "self_attn.v_proj.weight", "self_attn.o_proj.weight",
    "post_attention_layernorm.weight",
    "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight",
]


def stack_layers(per_layer: list) -> Dict[str, torch.Tensor]:
    """List of L per-layer param dicts -> one dict of (L, ...) leaves."""
    keys = per_layer[0].keys()
    return {k: torch.stack([p[k] for p in per_layer]) for k in keys}


def split_params(model: LlamaForCausalLM):
    """model state_dict -> (outer_params, stacked_layer_params). The
    stacked leaves are new tensors: the model's own copies can be dropped
    afterwards to halve the weights' memory."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    L = model.config.num_hidden_layers
    per_layer = [{key: sd.pop(f"model.layers.{i}.{key}")
                  for key in LAYER_KEYS} for i in range(L)]
    return sd, stack_layers(per_layer)


def _rms(x, w, eps):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    # back to the input dtype BEFORE the weight multiply, as the
    # reference does
    return y.to(x.dtype) * w
