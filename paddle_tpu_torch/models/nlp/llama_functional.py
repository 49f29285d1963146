"""Functional Llama for the PyTorch port: the stacked-layer convention,
RMSNorm, and the training forward and loss over parameter dicts.

Counterpart of ``paddle_tpu/models/nlp/llama_functional.py:28-158``. The
reference scans one compiled layer body over stacked layer parameters;
PyTorch runs eagerly, so ``forward`` is a Python loop over a list of
per-layer dicts (views of a model's own parameters: ``param_views``).

Attention follows the branches of the reference's
``LlamaAttention.forward`` (``llama.py:239-376``), its mesh branches
included (the model axis, tensor parallelism, and the sequence axis,
context parallelism: below). On one rank:

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

Under a model axis of several ranks (``llama.set_tensor_parallel_mesh``,
set by the train-step factory on a mesh), the weights are this rank's
shards (``llama.param_shardings``; fused projections cut by component)
and the layer math is Megatron's, as the reference's GSPMD partition
computes it: the embedding's vocabulary rows looked up and all-reduced;
each projection's input through ``c_identity`` (its gradient
all-reduced); the attention on the rank's heads
(``parallel.pallas_sharding``); the output and down projections
all-reduced (``mp_allreduce``); the head's vocabulary columns into the
vocabulary-parallel f32 CE (``parallel_cross_entropy``), the reference's
dense branch for a model axis.

Under a "sep" axis of several ranks (``llama.set_context_parallel_mesh``,
set by the train-step factory on a mesh with one; or a global mesh with
one, as in the reference), each rank holds its chunk of S/n positions and
``_attention`` routes as the reference's ``attn`` does under a
context-parallel mesh (``llama.py:239-262``, ``:316-357``):

* a ``sliding_window`` shorter than the whole sequence:
  ``ring_window_attention`` (the splash kernels per chunk pair);
* otherwise, by the flag ``context_parallel_backend``: ``"ulysses"``
  where the rank's query heads divide the axis (K/V repeated to the query
  heads; the multi-head flash kernels over the whole sequence), else
  ``ring_attention`` with K/V at the rank's kv head count (the grouped
  flash kernels per chunk; the reference repeats K/V where the kv heads
  do not divide a model axis, where the port's ranks hold the kv heads
  their query heads read: the same function).

The rotary takes the chunk's global positions, c·S/n + 0..S/n-1 for the
rank at coordinate c (explicit ``positions`` are the rank's own). With a
model axis too, the attention runs on the rank's heads and its chunk.

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

from ...distributed.collective import c_concat, c_identity, mp_allreduce
from ...distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    parallel_cross_entropy, vocab_parallel_embedding)
from ...ops.chunked_ce import chunked_causal_lm_loss
from ...ops.flash_attention import flash_attention, flash_eligible
from ...ops.flash_attention_gqa import grouped_flash_attention
from ...ops.fused_ce import causal_lm_loss
from ...ops.splash_attention import banded_block_mask, splash_attention
from ...parallel.pallas_sharding import local_heads, shard_map_attention
from ...parallel.ring_attention import WINDOW_MASK_BLOCK
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


def _context_parallel_attention(cfg, qt, kt, vt, mesh, axis):
    """The rank's chunk of causal attention over the sequence whose chunks
    lie on ``mesh``'s ``axis``, by the routing of the module docstring."""
    from ...core.flags import get_flag
    from ...parallel.ring_attention import (ring_attention,
                                            ring_window_attention)
    from ...parallel.ulysses import ulysses_attention
    n = mesh.shape[axis]
    window = cfg.sliding_window
    if window is not None and window < qt.shape[2] * n:
        return ring_window_attention(qt, kt, vt, mesh, window, axis=axis)
    if get_flag("context_parallel_backend") == "ulysses" \
            and qt.shape[1] % n == 0:
        G = qt.shape[1] // kt.shape[1]
        if G > 1:
            # Ulysses splits the heads: K/V at the query heads' count
            kt = kt.repeat_interleave(G, dim=1)
            vt = vt.repeat_interleave(G, dim=1)
        return ulysses_attention(qt, kt, vt, mesh, axis=axis, causal=True)
    return ring_attention(qt, kt, vt, mesh, axis=axis, causal=True)


def _attention(cfg, qt, kt, vt):
    """Causal attention of q (B, nh, S, hd) over k/v (B, nkv, S, hd), by
    the branches of the module docstring."""
    from .llama import _context_parallel_mesh
    cp_mesh, cp_axis = _context_parallel_mesh()
    if cp_mesh is not None:
        return _context_parallel_attention(cfg, qt, kt, vt, cp_mesh, cp_axis)
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


def _qkv(cfg, p, h, prefix="self_attn.", n=1):
    """q, k, v projections of h over the weights under ``prefix``: one
    fused product sliced q, k, v, or three. ``n``: the model axis, whose
    fused shard holds this rank's q, k and v columns, 1/n of each."""
    if cfg.fuse_attention_qkv:
        H = h.shape[-1]
        kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
        q_n, kv_n = H // n, kv // n
        qkv = h @ p[prefix + "qkv_proj.weight"]
        return (qkv[..., :q_n], qkv[..., q_n:q_n + kv_n],
                qkv[..., q_n + kv_n:])
    return (h @ p[prefix + "q_proj.weight"], h @ p[prefix + "k_proj.weight"],
            h @ p[prefix + "v_proj.weight"])


def _gate_up(cfg, p, h, prefix="mlp."):
    """gate and up projections of h: one fused product sliced gate, up (the
    halves of its columns), or two."""
    if cfg.fuse_ffn_gate_up:
        gu = h @ p[prefix + "gate_up_proj.weight"]
        half = gu.shape[-1] // 2
        return gu[..., :half], gu[..., half:]
    return h @ p[prefix + "gate_proj.weight"], h @ p[prefix + "up_proj.weight"]


def _model_group():
    """The model-parallel group when a mesh with a model axis of several
    ranks is set (``llama.set_tensor_parallel_mesh``), else None."""
    from .llama import _tensor_parallel_mesh
    mesh, axis = _tensor_parallel_mesh()
    return None if mesh is None else mesh.group(axis)


def swiglu(cfg, p, h, prefix="mlp."):
    """The SwiGLU MLP of h over the weights under ``prefix``:
    ``(silu(h @ gate) * (h @ up)) @ down`` (summed over the model group
    under one)."""
    group = _model_group()
    if group is not None:
        h = c_identity(h, group)
    gate, up = _gate_up(cfg, p, h, prefix)
    out = (F.silu(gate) * up) @ p[prefix + "down_proj.weight"]
    return out if group is None else mp_allreduce(out, group)


def _local_qkv(cfg, p, h, prefix, group):
    """This rank's q (B, S, its query heads, hd), k and v (B, S, the kv
    heads they read, hd) under the model group."""
    B, S, H = h.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh
    n = group.nranks
    plan = local_heads(nh, nkv, n, group.rank)
    h = c_identity(h, group)
    q, k, v = _qkv(cfg, p, h, prefix, n)
    if q.shape[-1] != plan.q_count * hd:
        raise ValueError(f"{prefix}: the query projection gives "
                         f"{q.shape[-1]} columns; a model axis of {n} gives "
                         f"each rank {plan.q_count * hd} (load this rank's "
                         f"shards: llama.param_shardings)")
    if plan.kv_index is None:
        k = k.reshape(B, S, plan.kv_count, hd)
        v = v.reshape(B, S, plan.kv_count, hd)
    else:
        # the kv heads do not divide the axis: gather the projections
        # (each rank's gradient of them is its part) and read the heads
        # this rank's query heads use
        idx = torch.as_tensor(plan.kv_index, device=h.device)
        k = c_concat(k, group, True).reshape(B, S, nkv, hd)[:, :, idx]
        v = c_concat(v, group, True).reshape(B, S, nkv, hd)[:, :, idx]
    return q.reshape(B, S, plan.q_count, hd), k, v


def _rotary_positions(S, device, positions):
    """``positions``, or by default 0..S-1 shifted to the chunk's global
    positions under a context-parallel mesh."""
    if positions is not None:
        return positions
    from .llama import _context_parallel_mesh
    pos = torch.arange(S, device=device)
    mesh, axis = _context_parallel_mesh()
    return pos if mesh is None else pos + mesh.coordinate(axis) * S


def attention(cfg, p: Dict[str, torch.Tensor], h, positions=None,
              prefix="self_attn."):
    """The attention of the normed input h (B, S, H) over the weights under
    ``prefix``: projections, the rotary at ``positions`` ((S,) or (B, S);
    0..S-1 by default, the chunk's global positions under a
    context-parallel mesh), causal attention (``_attention``), the output
    projection. Under a model group: the rank's heads, the output summed
    over the group."""
    group = _model_group()
    if group is not None:
        return _attention_tp(cfg, p, h, positions, prefix, group)
    B, S, H = h.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh
    q, k, v = _qkv(cfg, p, h, prefix)
    q, k, v = (q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd),
               v.reshape(B, S, nkv, hd))
    pos = _rotary_positions(S, h.device, positions)
    q = apply_rotary(q, pos, cfg.rope_theta)
    k = apply_rotary(k, pos, cfg.rope_theta)
    ctx = _attention(cfg, q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2))
    return ctx.transpose(1, 2).reshape(B, S, H) \
        @ p[prefix + "o_proj.weight"]


def _attention_tp(cfg, p, h, positions, prefix, group):
    from .llama import _tensor_parallel_mesh
    B, S, H = h.shape
    q, k, v = _local_qkv(cfg, p, h, prefix, group)
    pos = _rotary_positions(S, h.device, positions)
    q = apply_rotary(q, pos, cfg.rope_theta)
    k = apply_rotary(k, pos, cfg.rope_theta)
    mesh, axis = _tensor_parallel_mesh()
    ctx = shard_map_attention(
        lambda qt, kt, vt: _attention(cfg, qt, kt, vt), q.transpose(1, 2),
        k.transpose(1, 2), v.transpose(1, 2), mesh, axis,
        num_heads=cfg.num_attention_heads)
    out = ctx.transpose(1, 2).reshape(B, S, -1) \
        @ p[prefix + "o_proj.weight"]
    return mp_allreduce(out, group)


def attention_residual(cfg, p: Dict[str, torch.Tensor], x, positions=None):
    """The first half of a decoder layer: x + attention(RMSNorm(x))."""
    h = _rms(x, p["input_layernorm.weight"], cfg.rms_norm_eps)
    return x + attention(cfg, p, h, positions)


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
    x = _embed(tokens, outer["model.embed_tokens.weight"])
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


def _embed(tokens, table):
    """The embedding's rows; under a model group the table holds this
    rank's block of the vocabulary: looked up and summed over the
    group."""
    group = _model_group()
    if group is None:
        return F.embedding(tokens, table)
    return vocab_parallel_embedding(tokens, table,
                                    group.rank * table.shape[0], group)


def forward(cfg, outer, layers, tokens, remat=True, positions=None):
    """Causal-LM logits (B, S, V) for tokens (B, S); ``layers`` is a list
    of per-layer param dicts; ``remat`` and ``positions`` as in
    ``hidden_states``. Under a model group: this rank's vocabulary columns
    (B, S, V / n)."""
    x = hidden_states(cfg, outer, layers, tokens, remat, positions)
    group = _model_group()
    if group is not None:
        x = c_identity(x, group)
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
    logits = forward(cfg, outer, layers, tokens, remat)
    group = _model_group()
    if group is not None:
        # the vocabulary-split f32 CE: the reference's dense branch for a
        # model axis (llama.py:623-626)
        start = group.rank * logits.shape[-1]
        return torch.mean(parallel_cross_entropy(logits, labels, group,
                                                 start))
    return causal_lm_loss(logits, labels)

