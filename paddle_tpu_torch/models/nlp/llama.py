"""Llama for the PyTorch port: config, rotary embedding, the model and
its training step.

Counterpart of ``paddle_tpu/models/nlp/llama.py`` (``LlamaConfig``,
``_rope_freqs``, ``apply_rotary``, ``LlamaForCausalLM`` and
``llama_train_step_factory``, ``llama.py:500-738``). Layouts are the
reference's: every projection weight is ``(in, out)`` and is applied as
``x @ w``, and ``state_dict()`` keys equal the reference's, fused
projections included (``qkv_proj``, ``gate_up_proj``), so a reference
state dict loads with ``load_numpy_state_dict`` unchanged.

``LlamaForCausalLM.forward`` and the train step share one implementation
of the layer math, ``llama_functional.forward``: on the card, the flash
attention kernels (grouped or multi-head), the splash kernels for a
``sliding_window`` shorter than the sequence, and the fused CE kernels.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from ...core.place import resolve_device
from ...nn.layer.layers import load_numpy_state_dict  # noqa: F401


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16
    fuse_attention_qkv: bool = False
    fuse_ffn_gate_up: bool = False
    sliding_window: int | None = None

    @staticmethod
    def llama3_8b():
        return LlamaConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_hidden_layers=32,
                           num_attention_heads=32, num_key_value_heads=8,
                           rope_theta=500000.0)

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=hidden * 2,
                           num_hidden_layers=layers,
                           num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           max_position_embeddings=512, dtype=torch.float32)


def _rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim, theta, device):
    """The f32 frequencies on ``device``, copied there once, not once per
    layer and step."""
    return torch.as_tensor(_rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rotary(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions broadcast against the
    seq axis. Computed in f32 and cast back to x's dtype, as the
    reference does."""
    head_dim = x.shape[-1]
    freqs = _rope_freqs_on(head_dim, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _Weight(nn.Module):
    """One named ``weight`` parameter, so module paths spell the
    reference's state-dict keys (``...q_proj.weight``)."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype,
                                               device=device),
                                   requires_grad=False)


class _Attention(nn.Module):
    def __init__(self, c: LlamaConfig, dtype, device):
        super().__init__()
        H = c.hidden_size
        kv_out = c.num_key_value_heads * (H // c.num_attention_heads)
        if c.fuse_attention_qkv:
            # one (H, H + 2*kv) product, sliced q, k, v (llama.py:195-199)
            self.qkv_proj = _Weight((H, H + 2 * kv_out), dtype, device)
        else:
            self.q_proj = _Weight((H, H), dtype, device)
            self.k_proj = _Weight((H, kv_out), dtype, device)
            self.v_proj = _Weight((H, kv_out), dtype, device)
        self.o_proj = _Weight((H, H), dtype, device)


class _MLP(nn.Module):
    def __init__(self, c: LlamaConfig, dtype, device):
        super().__init__()
        H, F = c.hidden_size, c.intermediate_size
        if c.fuse_ffn_gate_up:
            # one (H, 2F) product, sliced gate, up (llama.py:388-390)
            self.gate_up_proj = _Weight((H, 2 * F), dtype, device)
        else:
            self.gate_proj = _Weight((H, F), dtype, device)
            self.up_proj = _Weight((H, F), dtype, device)
        self.down_proj = _Weight((F, H), dtype, device)


class _DecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, dtype, device):
        super().__init__()
        self.input_layernorm = _Weight((c.hidden_size,), dtype, device)
        self.self_attn = _Attention(c, dtype, device)
        self.post_attention_layernorm = _Weight((c.hidden_size,), dtype,
                                                device)
        self.mlp = _MLP(c, dtype, device)


class _LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, dtype, device):
        super().__init__()
        self.embed_tokens = _Weight((c.vocab_size, c.hidden_size), dtype,
                                    device)
        self.layers = nn.ModuleList(
            [_DecoderLayer(c, dtype, device)
             for _ in range(c.num_hidden_layers)])
        self.norm = _Weight((c.hidden_size,), dtype, device)


class LlamaForCausalLM(nn.Module):
    """Parameter holder with the reference's state-dict keys:
    ``model.embed_tokens.weight`` (V, H), ``model.layers.{i}.<key>`` for
    each key of ``llama_functional.layer_keys(config)`` (projections (in,
    out); ``self_attn.qkv_proj.weight`` (H, H + 2·kv·hd) under
    ``fuse_attention_qkv``, ``mlp.gate_up_proj.weight`` (H, 2F) under
    ``fuse_ffn_gate_up``), ``model.norm.weight``, ``lm_head.weight`` (H,
    V; absent when ``tie_word_embeddings``).

    Parameters are made on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for) and filled from a ``torch.Generator`` seeded with ``seed``:
    norms are ones, every other weight is N(0, 0.02). Load real or
    reference weights with ``load_numpy_state_dict``."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        if config.sliding_window is not None and config.sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1 (got "
                             f"{config.sliding_window}); use None to "
                             f"disable")
        dev = resolve_device(device)
        self.config = config
        self.model = _LlamaModel(config, config.dtype, dev)
        self.lm_head = None if config.tie_word_embeddings else _Weight(
            (config.hidden_size, config.vocab_size), config.dtype, dev)
        self.init_weights(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def forward(self, input_ids, positions=None):
        """Logits (B, S, V) for input_ids (B, S): the functional forward
        (``llama_functional.forward``) over this model's own parameters,
        differentiable in those that require grad. ``positions`` ((S,) or
        (B, S)) feed the rotary in place of 0..S-1, as in the reference;
        the causal mask stays that of the sequence order."""
        from .llama_functional import forward, param_views

        outer, layers = param_views(dict(self.named_parameters()),
                                    self.config.num_hidden_layers)
        return forward(self.config, outer, layers,
                       torch.as_tensor(input_ids, device=self.device).long(),
                       remat=False, positions=positions)


def llama_train_step_factory(model: LlamaForCausalLM, learning_rate=1e-4,
                             weight_decay=0.01, beta1=0.9, beta2=0.95,
                             eps=1e-8, accum_dtype=torch.float32,
                             remat: bool | str = True, device=None,
                             mesh=None, offload_moments: bool = False,
                             chunked_vocab_ce: int | None = None):
    """Returns (params, opt_state, train_step) for one device.

    ``params`` are the model's own parameters ({state-dict key: tensor},
    made trainable; no copy is held), ``opt_state`` is
    ``make_adamw_state(params, accum_dtype, offload_moments)``, and
    ``train_step(params, opt_state, tokens, labels) -> (params, opt_state,
    loss)`` runs the forward (the attention kernels of
    ``llama_functional``), the loss, the backward and AdamW. The update
    is IN PLACE: the counterpart of the reference's ``donate_argnums``,
    and the model holds the trained weights.

    remat: False keeps every activation; True checkpoints each decoder
    layer and recomputes its forward in the backward; ``"dots"`` keeps
    the projections' outputs and recomputes the rest (the reference's
    ``dots_with_no_batch_dims_saveable``). The numbers are the same; the
    attention forward launches double under True and ``"dots"``
    (``llama_functional.hidden_states``).

    offload_moments: AdamW's f32 moments live in pinned host memory and
    stream through the card in chunks of 4 tensors around the update
    (``train_utils.apply_adamw``): what a 7-8 B model needs to train on
    one 80 GB card. The result equals device-resident moments bit for
    bit.

    chunked_vocab_ce: a chunk size; the tied embedding's head and the CE
    run chunk by chunk (``ops/chunked_ce.py``), so the (B·S, V) logits are
    never built. Requires tied word embeddings (ValueError otherwise, as
    in the reference).

    Not ported yet, and refused: ``mesh`` axes (data/sep/model/sharding:
    ROADMAP Queue 1, distributed and parallel)."""
    from .llama_functional import (CHUNKED_NEEDS_TIED, _check_remat,
                                   loss_fn, param_views)
    from .train_utils import apply_adamw, make_adamw_state

    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "mesh axes (data/sep/model/sharding) are not ported yet: ROADMAP "
            "Queue 1, distributed / parallel")
    _check_remat(remat)
    if chunked_vocab_ce and model.lm_head is not None:
        raise ValueError(CHUNKED_NEEDS_TIED)
    cfg = model.config
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}; build it with "
                         f"device={dev}")
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt_state = make_adamw_state(params, accum_dtype, offload=offload_moments)
    n_layers = cfg.num_hidden_layers

    def train_step(params, opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        keys = list(params)
        outer, layers = param_views(params, n_layers)
        loss = loss_fn(cfg, outer, layers, tokens, labels, remat,
                       chunked_vocab_ce)
        grads = list(torch.autograd.grad(loss, [params[k] for k in keys]))
        apply_adamw(params, grads, opt_state, learning_rate, beta1, beta2,
                    eps, weight_decay, accum_dtype, offload=offload_moments)
        return params, opt_state, loss.detach()

    return params, opt_state, train_step
