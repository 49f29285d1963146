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

Fused projection weights (``fuse_attention_qkv``: one (H, H + 2·kv·hd)
``qkv_proj``; ``fuse_ffn_gate_up``: one (H, 2F) ``gate_up_proj``) are
sliced q, k, v and gate, up, as the reference's layers do
(``llama.py:210-226``, ``:401-407``). Explicit ``positions`` move the
rotary only, as in the reference (``llama.py:233-236``): the causal
mask, the window and the flash gate stay those of 0..S-1.

Every kernel path runs its plain version on the CPU. The loss is
``causal_lm_loss``, the fused CE kernels (their plain version on the
CPU), or with ``chunked_vocab_ce`` the chunked head-and-CE of
``ops/chunked_ce.py``, which never builds the (B·S, V) logits.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ...ops.chunked_ce import chunked_causal_lm_loss
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


def layer_keys(cfg):
    """The per-layer keys of a model built from ``cfg``, in its own order:
    ``LAYER_KEYS``, with ``self_attn.qkv_proj.weight`` for q/k/v under
    ``fuse_attention_qkv`` and ``mlp.gate_up_proj.weight`` for gate/up
    under ``fuse_ffn_gate_up``."""
    keys = list(LAYER_KEYS)
    if cfg.fuse_attention_qkv:
        keys[1:4] = ["self_attn.qkv_proj.weight"]
    if cfg.fuse_ffn_gate_up:
        i = keys.index("mlp.gate_proj.weight")
        keys[i:i + 2] = ["mlp.gate_up_proj.weight"]
    return keys


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
                  for key in layer_keys(model.config)} for i in range(L)]
    return sd, stack_layers(per_layer)


def param_views(params: Dict[str, torch.Tensor], n_layers: int):
    """A flat {state-dict key: tensor} dict -> (outer, [per-layer dicts]),
    holding the same tensors: no copy, so gradients reach ``params``. A
    layer's dict holds every key under its prefix (fused or not)."""
    outer = {k: v for k, v in params.items()
             if not k.startswith("model.layers.")}
    layers = [{} for _ in range(n_layers)]
    for k, v in params.items():
        if k.startswith("model.layers."):
            i, key = k[len("model.layers."):].split(".", 1)
            layers[int(i)][key] = v
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


def _qkv(cfg, p, h):
    """q, k, v projections of h: one fused product sliced q, k, v, or
    three."""
    if cfg.fuse_attention_qkv:
        H = h.shape[-1]
        kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
        qkv = h @ p["self_attn.qkv_proj.weight"]
        return qkv[..., :H], qkv[..., H:H + kv], qkv[..., H + kv:]
    return (h @ p["self_attn.q_proj.weight"], h @ p["self_attn.k_proj.weight"],
            h @ p["self_attn.v_proj.weight"])


def _gate_up(cfg, p, h, prefix="mlp."):
    """gate and up projections of h: one fused product sliced gate, up, or
    two."""
    if cfg.fuse_ffn_gate_up:
        gu = h @ p[prefix + "gate_up_proj.weight"]
        return gu[..., :cfg.intermediate_size], gu[..., cfg.intermediate_size:]
    return h @ p[prefix + "gate_proj.weight"], h @ p[prefix + "up_proj.weight"]


def swiglu(cfg, p, h, prefix="mlp."):
    """The SwiGLU MLP of h over the weights under ``prefix``:
    ``(silu(h @ gate) * (h @ up)) @ down``."""
    gate, up = _gate_up(cfg, p, h, prefix)
    return (F.silu(gate) * up) @ p[prefix + "down_proj.weight"]


def attention_residual(cfg, p: Dict[str, torch.Tensor], x, positions=None):
    """The first half of a decoder layer: x + attention(RMSNorm(x)), with
    the rotary at ``positions`` ((S,) or (B, S); 0..S-1 by default)."""
    B, S, H = x.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh
    h = _rms(x, p["input_layernorm.weight"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q, k, v = (q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd),
               v.reshape(B, S, nkv, hd))
    pos = torch.arange(S, device=x.device) if positions is None \
        else positions
    q = apply_rotary(q, pos, cfg.rope_theta)
    k = apply_rotary(k, pos, cfg.rope_theta)
    ctx = _attention(cfg, q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2))
    attn = ctx.transpose(1, 2).reshape(B, S, H) \
        @ p["self_attn.o_proj.weight"]
    return x + attn


def layer_forward(cfg, p: Dict[str, torch.Tensor], x, positions=None):
    """One decoder layer over its param dict; ``positions`` ((S,) or (B,
    S)) feed the rotary, 0..S-1 by default."""
    x = attention_residual(cfg, p, x, positions)
    h2 = _rms(x, p["post_attention_layernorm.weight"], cfg.rms_norm_eps)
    return x + swiglu(cfg, p, h2)


# remat="dots": the reference's dots_with_no_batch_dims_saveable. The
# projections (3-D x 2-D products) lower to aten.mm; their outputs are
# saved, and everything else is recomputed in the backward: batched
# products (bmm), norms, rotary, SwiGLU and the attention kernels' forward
# (a Pallas call is not a dot in the reference either).
SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_save_dots = functools.partial(create_selective_checkpoint_contexts,
                               list(SAVED_BY_DOTS))


def _check_remat(remat):
    if remat not in (True, False, "dots"):
        raise ValueError(f"remat must be True, False or 'dots'; got "
                         f"{remat!r}")


def _positions(positions, tokens):
    """Explicit positions as a long tensor on the tokens' device, checked
    against the reference's domain: (S,) or (B, S)."""
    if positions is None:
        return None
    pos = torch.as_tensor(positions, device=tokens.device).long()
    if pos.dim() not in (1, 2) or pos.shape[-1] != tokens.shape[1] \
            or (pos.dim() == 2 and pos.shape[0] not in (1,
                                                         tokens.shape[0])):
        raise ValueError(f"positions {tuple(pos.shape)} must be (S,) or "
                         f"(B, S) for tokens {tuple(tokens.shape)}")
    return pos


def hidden_states(cfg, outer, layers, tokens, remat=True, positions=None):
    """The final normed hidden states (B, S, H) for tokens (B, S).

    ``remat``: False keeps every activation; True checkpoints each decoder
    layer (``torch.utils.checkpoint``; the reference's ``jax.checkpoint``),
    recomputing its whole forward in the backward; ``"dots"`` checkpoints
    each layer under the selective policy ``SAVED_BY_DOTS`` (the
    reference's ``dots_with_no_batch_dims_saveable``): the projections'
    outputs are kept, the rest is recomputed, layer by layer. The numbers
    are the same in all three. Attention forward launches a step: L
    without remat, 2L with True or ``"dots"`` (each layer's forward runs
    again in the backward); dq and dk/dv launch L times each in all."""
    _check_remat(remat)
    positions = _positions(positions, tokens)
    x = F.embedding(tokens, outer["model.embed_tokens.weight"])
    for lp in layers:
        if remat == "dots":
            x = checkpoint(layer_forward, cfg, lp, x, positions,
                           use_reentrant=False, context_fn=_save_dots)
        elif remat:
            x = checkpoint(layer_forward, cfg, lp, x, positions,
                           use_reentrant=False)
        else:
            x = layer_forward(cfg, lp, x, positions)
    return _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)


def forward(cfg, outer, layers, tokens, remat=True, positions=None):
    """Causal-LM logits (B, S, V) for tokens (B, S); ``layers`` is a list
    of per-layer param dicts; ``remat`` and ``positions`` as in
    ``hidden_states``."""
    x = hidden_states(cfg, outer, layers, tokens, remat, positions)
    head = outer.get("lm_head.weight")
    if head is None:
        return x @ outer["model.embed_tokens.weight"].T
    return x @ head


CHUNKED_NEEDS_TIED = ("chunked_vocab_ce requires tied word embeddings (the "
                      "(V, H) embedding doubles as the head)")


def loss_fn(cfg, outer, layers, tokens, labels, remat=True,
            chunked_vocab_ce=None):
    """Mean causal-LM CE. By default through the fused CE kernels (their
    plain version for CPU tensors): no (N, V) softmax is written. With
    ``chunked_vocab_ce`` (a chunk size), the tied embedding's head and the
    CE run chunk by chunk (``chunked_causal_lm_loss``): no (N, V) logits
    either; an untied ``lm_head`` is refused, as in the reference."""
    if chunked_vocab_ce:
        if "lm_head.weight" in outer:
            raise ValueError(CHUNKED_NEEDS_TIED)
        x = hidden_states(cfg, outer, layers, tokens, remat)
        return chunked_causal_lm_loss(x, outer["model.embed_tokens.weight"],
                                      labels, int(chunked_vocab_ce))
    return causal_lm_loss(forward(cfg, outer, layers, tokens, remat),
                          labels)

