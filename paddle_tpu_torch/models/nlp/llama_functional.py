"""Functional Llama for the PyTorch port: the stacked-layer convention,
RMSNorm, and the training forward and loss over parameter dicts.

Counterpart of ``paddle_tpu/models/nlp/llama_functional.py:28-158``. The
reference scans one compiled layer body over stacked layer parameters;
PyTorch runs eagerly, so ``forward`` is a Python loop over a list of
per-layer dicts (views of a model's own parameters: ``param_views``).

Attention follows the branches of the reference's
``LlamaAttention.forward`` (``llama.py:239-305``, ``:359-376``), without
its mesh branches (sequence, tensor and ring parallelism are not ported):

* ``sliding_window`` shorter than the sequence, at a flash-eligible
  shape: ``splash_attention`` over the banded block mask, with K/V at the
  true kv head count (grouped splash) for GQA and G = 1 for multi-head;
* the same window at an ineligible shape: the dense path with the band;
* no window (or one that covers the sequence), at an eligible shape:
  ``grouped_flash_attention`` for GQA, ``flash_attention`` for
  multi-head; at an ineligible shape the dense causal path.

Every kernel path runs its plain version on the CPU. The loss is
``causal_lm_loss``, the fused CE kernels (their plain version on the CPU).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.flash_attention import flash_attention, flash_eligible
from ...ops.flash_attention_gqa import grouped_flash_attention
from ...ops.fused_ce import causal_lm_loss
from ...ops.splash_attention import banded_block_mask, splash_attention
from .llama import LlamaForCausalLM, apply_rotary

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


def param_views(params: Dict[str, torch.Tensor], n_layers: int):
    """A flat {state-dict key: tensor} dict -> (outer, [per-layer dicts]),
    holding the same tensors: no copy, so gradients reach ``params``."""
    outer = {k: v for k, v in params.items()
             if not k.startswith("model.layers.")}
    layers = [{key: params[f"model.layers.{i}.{key}"] for key in LAYER_KEYS}
              for i in range(n_layers)]
    return outer, layers


def _rms(x, w, eps):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    # back to the input dtype BEFORE the weight multiply, as the
    # reference does
    return y.to(x.dtype) * w


# block size of the banded mask given to the splash kernels: the mask is
# read per element inside the kernels' tiles, so it sets no work, and 128
# divides every flash-eligible length
WINDOW_MASK_BLOCK = 128


def _dense_attention(qt, kt, vt, window=None):
    """The dense causal path (``llama_functional.py:113-120``; with a
    window, ``llama.py:141-153``): K/V repeated to the query heads, the
    causal mask (and the band q_pos - k_pos < window), f32 softmax cast
    back to q's dtype."""
    nh, nkv, S, hd = qt.shape[1], kt.shape[1], qt.shape[2], qt.shape[3]
    if nh != nkv:
        kt = kt.repeat_interleave(nh // nkv, dim=1)
        vt = vt.repeat_interleave(nh // nkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) / math.sqrt(hd)
    i = torch.arange(S, device=qt.device)[:, None]
    j = torch.arange(S, device=qt.device)[None, :]
    live = i >= j
    if window is not None:
        live &= i - j < window
    s = torch.where(live, s, torch.finfo(s.dtype).min)
    probs = torch.softmax(s.to(torch.float32), -1).to(qt.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vt)


def _attention(cfg, qt, kt, vt):
    """Causal attention of q (B, nh, S, hd) over k/v (B, nkv, S, hd), by
    the branches of the module docstring."""
    S, hd = qt.shape[2], qt.shape[3]
    window = cfg.sliding_window
    flash = flash_eligible(S, hd, qt.dtype)
    if window is not None and window < S:
        if not flash:
            return _dense_attention(qt, kt, vt, window)
        b = WINDOW_MASK_BLOCK
        return splash_attention(qt, kt, vt, banded_block_mask(S, S, b, b,
                                                              window),
                                True, None, b, b, window)
    if not flash:
        return _dense_attention(qt, kt, vt)
    if qt.shape[1] != kt.shape[1]:
        # K/V stay at the kv head count: no repeat through device memory
        return grouped_flash_attention(qt, kt, vt, True)
    return flash_attention(qt, kt, vt, True)


def layer_forward(cfg, p: Dict[str, torch.Tensor], x):
    """One decoder layer over its param dict."""
    B, S, H = x.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh
    h = _rms(x, p["input_layernorm.weight"], cfg.rms_norm_eps)
    q = (h @ p["self_attn.q_proj.weight"]).reshape(B, S, nh, hd)
    k = (h @ p["self_attn.k_proj.weight"]).reshape(B, S, nkv, hd)
    v = (h @ p["self_attn.v_proj.weight"]).reshape(B, S, nkv, hd)
    pos = torch.arange(S, device=x.device)
    q = apply_rotary(q, pos, cfg.rope_theta)
    k = apply_rotary(k, pos, cfg.rope_theta)
    ctx = _attention(cfg, q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2))
    attn = ctx.transpose(1, 2).reshape(B, S, H) \
        @ p["self_attn.o_proj.weight"]
    x = x + attn
    h2 = _rms(x, p["post_attention_layernorm.weight"], cfg.rms_norm_eps)
    mlp = (F.silu(h2 @ p["mlp.gate_proj.weight"])
           * (h2 @ p["mlp.up_proj.weight"])) @ p["mlp.down_proj.weight"]
    return x + mlp


def forward(cfg, outer, layers, tokens, remat=True):
    """Causal-LM logits (B, S, V) for tokens (B, S); ``layers`` is a list
    of per-layer param dicts. ``remat``
    checkpoints each decoder layer (its activations are recomputed in the
    backward), as the reference's ``jax.checkpoint`` over the scan body."""
    x = F.embedding(tokens, outer["model.embed_tokens.weight"])
    for lp in layers:
        if remat:
            x = checkpoint(layer_forward, cfg, lp, x, use_reentrant=False)
        else:
            x = layer_forward(cfg, lp, x)
    x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
    head = outer.get("lm_head.weight")
    if head is None:
        return x @ outer["model.embed_tokens.weight"].T
    return x @ head


def loss_fn(cfg, outer, layers, tokens, labels, remat=True):
    """Mean causal-LM CE through the fused CE kernels (their plain version
    for CPU tensors); no (N, V) softmax is written."""
    return causal_lm_loss(forward(cfg, outer, layers, tokens, remat), labels)
