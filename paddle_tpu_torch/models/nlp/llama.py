"""Llama for the PyTorch port: config, rotary embedding and the parameter
holder the paged decode factory reads.

Counterpart of ``paddle_tpu/models/nlp/llama.py`` (``LlamaConfig``,
``_rope_freqs``, ``apply_rotary``, ``LlamaForCausalLM``). Layouts are the
reference's: every projection weight is ``(in, out)`` and is applied as
``x @ w``, and ``state_dict()`` keys equal the reference's, so a
reference state dict loads with ``load_numpy_state_dict`` unchanged.

The training forward (flash / GQA attention kernels, fused CE) is not
ported yet; ``LlamaForCausalLM.forward`` raises and names the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from ...core.dtype import numpy_to_torch
from ...core.place import resolve_device


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
        self.q_proj = _Weight((H, H), dtype, device)
        self.k_proj = _Weight((H, kv_out), dtype, device)
        self.v_proj = _Weight((H, kv_out), dtype, device)
        self.o_proj = _Weight((H, H), dtype, device)


class _MLP(nn.Module):
    def __init__(self, c: LlamaConfig, dtype, device):
        super().__init__()
        H, F = c.hidden_size, c.intermediate_size
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
    ``model.embed_tokens.weight`` (V, H), ``model.layers.{i}.<LAYER_KEYS>``
    (projections (in, out)), ``model.norm.weight``, ``lm_head.weight``
    (H, V; absent when ``tie_word_embeddings``).

    Parameters are made on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for) and filled from a ``torch.Generator`` seeded with ``seed``:
    norms are ones, every other weight is N(0, 0.02). Load real or
    reference weights with ``load_numpy_state_dict``."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        if config.fuse_attention_qkv or config.fuse_ffn_gate_up:
            raise NotImplementedError(
                "fused qkv / gate_up weights are not ported yet "
                "(ROADMAP Queue 1: the training step)")
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
        raise NotImplementedError(
            "the training forward (flash / GQA attention kernels) is not "
            "ported yet: ROADMAP Queue 1, the training step. Use "
            "llama_paged_decode_factory for inference.")


def load_numpy_state_dict(model: LlamaForCausalLM, state: dict):
    """Copy a reference state dict ``{name: np.ndarray}`` into ``model``,
    in place, key for key and without transposing anything (both
    packages keep projections as (in, out)). bfloat16 arrays are taken
    bit-exactly. Raises KeyError on a missing or unexpected key and
    ValueError on a shape mismatch."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    with torch.no_grad():
        for name, p in params.items():
            t = numpy_to_torch(state[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model
