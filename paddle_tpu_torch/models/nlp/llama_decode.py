"""Llama decode for the PyTorch port: the paged KV-cache factory (the
continuous-batching serving path), the dense KV-cache factory, the
router between them and the serving factory that holds both.

Counterpart of ``paddle_tpu/models/nlp/llama_decode.py`` (the helpers
``_mm``, ``_proj_qkv``, ``_q8``, ``_cache_write``, ``_cache_read``,
``_attend``, ``_layer_math``, ``_logits``; ``llama_paged_decode_factory``,
``llama_decode_factory``, ``route_decode``, ``PagedOnlyDense``,
``llama_serving_decode_factory`` and the host configs ``TPConfig``,
``LoRAConfig``, ``SpecConfig``, ``GrammarConfig``). The reference jits
each program and scans over the stacked layers; PyTorch runs eagerly, so
each program here is a Python loop over the layers. The attention over a
paged pool is the paged-attention CUDA kernel (``ops/paged_attention.py``)
on the card, or its plain version on the CPU; the dense cache attends in
plain PyTorch, as the reference's does.

Pools and dense caches are updated IN PLACE (the reference donates them
to its jitted programs); every function returns the same tensors it was
given.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core.place import resolve_device
from ...ops.paged_attention import paged_attention, paged_prefill_attention
from .llama import LlamaForCausalLM, apply_rotary
from .llama_functional import _rms, split_params


def _mm(x, w):
    """x @ w for a plain (in, out) weight. The reference's int8 weight
    tuples (``weight_dtype="int8"``) are not ported yet (ROADMAP item
    10)."""
    return x @ w


def _proj_qkv(cfg, p, h, pos):
    """h: (B, T, H); pos: absolute positions broadcastable to (B, T).
    Returns q, k, v with rotary applied — q (B, nh, T, hd), k/v
    (B, nkv, T, hd)."""
    B, T, H = h.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh
    q = _mm(h, p["self_attn.q_proj.weight"]).reshape(B, T, nh, hd)
    k = _mm(h, p["self_attn.k_proj.weight"]).reshape(B, T, nkv, hd)
    v = _mm(h, p["self_attn.v_proj.weight"]).reshape(B, T, nkv, hd)
    q = apply_rotary(q, pos, cfg.rope_theta)
    k = apply_rotary(k, pos, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _q8(x):
    """Per-(batch, head, slot) absmax int8 quantization over head_dim —
    the KV-cache codec. Returns (int8 data, f32 scales)."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _attend(cfg, q, k_all, v_all, key_mask):
    """q: (B, nh, T, hd); k/v_all: (B, nkv, S, hd); key_mask bool,
    broadcastable to (B, nh, T, S)."""
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if nh != nkv:
        k_all = k_all.repeat_interleave(nh // nkv, dim=1)
        v_all = v_all.repeat_interleave(nh // nkv, dim=1)
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_all) / math.sqrt(hd)
    s = torch.where(key_mask, s, torch.finfo(s.dtype).min)
    probs = torch.softmax(s.to(torch.float32), -1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v_all)


def _layer_math(cfg, lp, x, pos_vec, attend):
    """The shared decoder-layer body (rms -> qkv+rope -> attend -> o_proj
    residual -> mlp residual); ``attend(q, k, v) -> ctx`` owns the cache
    strategy."""
    B, T, H = x.shape
    h = _rms(x, lp["input_layernorm.weight"], cfg.rms_norm_eps)
    q, k, v = _proj_qkv(cfg, lp, h, pos_vec)
    ctx = attend(q, k, v)
    x = x + _mm(ctx.transpose(1, 2).reshape(B, T, H),
                lp["self_attn.o_proj.weight"])
    h2 = _rms(x, lp["post_attention_layernorm.weight"], cfg.rms_norm_eps)
    mlp = _mm(F.silu(_mm(h2, lp["mlp.gate_proj.weight"]))
              * _mm(h2, lp["mlp.up_proj.weight"]),
              lp["mlp.down_proj.weight"])
    return x + mlp


def _logits(cfg, outer, x_last):
    head = outer.get("lm_head.weight")
    if head is None:
        return x_last @ outer["model.embed_tokens.weight"].T
    return _mm(x_last, head)


def _cache_write(cache, kv, write_at: int):
    """Write a (B, nkv, T, hd) block at slot ``write_at`` of a dense
    cache (B, nkv, C, hd), in place; quantized caches are (int8 data,
    f32 scales) tuples."""
    T = kv.shape[2]
    if isinstance(cache, tuple):
        data, sc = cache
        qv, s = _q8(kv)
        data[:, :, write_at:write_at + T] = qv
        sc[:, :, write_at:write_at + T] = s
        return cache
    cache[:, :, write_at:write_at + T] = kv.to(cache.dtype)
    return cache


def _cache_read(cache, dtype, n: int):
    """The first ``n`` slots of a dense cache in ``dtype``. Dequantized
    in f32: casting the scales to bf16 first would stack a second
    quantization on top of the int8 rounding."""
    if isinstance(cache, tuple):
        data, sc = cache
        return (data[:, :, :n].to(torch.float32)
                * sc[:, :, :n, None]).to(dtype)
    return cache[:, :, :n]


def _layer_step(cfg, lp, x, k_cache, v_cache, pos_vec, key_mask,
                write_at: int):
    """One decoder layer over T positions with a dense cache read and
    write. x (B, T, H); caches (B, nkv, C, hd) for this layer; the block
    lands at slot ``write_at`` and attends to slots < write_at + T under
    ``key_mask`` (T, write_at + T). The reference attends all C slots
    with the slots beyond masked, whose probabilities are exactly 0; the
    slice does the same work without them."""
    def attend(q, k, v):
        T = k.shape[2]
        n = write_at + T
        kc = _cache_write(k_cache, k, write_at)
        vc = _cache_write(v_cache, v, write_at)
        k_all = _cache_read(kc, q.dtype, n)
        v_all = _cache_read(vc, q.dtype, n)
        if isinstance(kc, tuple):
            # the EXACT current block over the dequantized cache: this
            # step's own keys are not round-tripped (quantization error
            # applies only to the stored past)
            k_all[:, :, write_at:n] = k.to(k_all.dtype)
            v_all[:, :, write_at:n] = v.to(v_all.dtype)
        return _attend(cfg, q, k_all, v_all, key_mask)

    return _layer_math(cfg, lp, x, pos_vec, attend)


def llama_paged_decode_factory(model: LlamaForCausalLM,
                               page_size: int = 64,
                               n_pool_pages: int = 256,
                               chunked_prefill: int | None = None,
                               kv_cache_dtype: str | None = None,
                               emit: str = "token",
                               prefill_attention: str = "gather",
                               kv_quant: str | None = None,
                               device=None):
    """Decode over a PAGED KV pool — the continuous-batching serving path.

    Per layer the pool is (Hkv, P, page_size, hd); sequences hold page
    tables (B, W) and real lengths (B,). Ragged batches are first-class:
    rotary positions, cache writes and attention masks are per sequence.
    ``device`` (``cuda`` unless ``"cpu"`` is asked for) holds the weights
    and pools; inputs may be tensors or arrays anywhere.

    Returns (outer, layers, pools, prefill, decode_step, decode_n):
      pools: (k_pools, v_pools) each (L, Hkv, P, page_size, hd); int8
          pools are ((k_data, k_scales), (v_data, v_scales)) with scales
          (L, Hkv, P, page_size) f32
      prefill(outer, layers, tokens (B,T), page_tables, lengths, pools)
          -> (next_token (B,), pools)   [prompt K/V written to pages]
      decode_step(outer, layers, tok (B,), page_tables, lengths, pools)
          -> (next_token (B,), pools)   [lengths + 1 is the caller's
                                         bookkeeping]
      decode_n(outer, layers, tok, page_tables, lengths, pools, n)
          -> (emits (n, B, ...), next_tok (B,), pools)
    Pools are updated in place and returned.

    ``chunked_prefill=C`` (a page multiple): prefill walks the prompt in
    C-token chunks, each attending causally to the pool pages written so
    far; it takes ``resume_from`` (a chunk multiple) to skip chunks whose
    pages already hold K/V. ``prefill_attention="kernel"`` attends each
    chunk through ``paged_prefill_attention`` (the paged kernel) instead
    of gathering the pages densely.

    ``kv_cache_dtype="int8"`` or ``kv_quant="int8"``: pages store the
    per-slot absmax int8 codec; the kernel dequantizes them.
    ``emit="logits"``: return last-position logits (B, V) f32 instead of
    greedy tokens.

    Not ported yet (ROADMAP item 11): ``tp``, ``lora``, ``grammar``,
    ``kv_quant="pressure"``, ``prefill_ragged``; ``scan_layers`` has no
    meaning here (the layers are a Python loop). A model with fused
    projection weights is refused: the decode programs read the unfused
    keys, as the reference's do.
    """
    dev = resolve_device(device)
    outer, layers = _split_for(model, dev, "llama_paged_decode_factory")
    return _paged_from(model.config, outer, layers, dev, page_size,
                       n_pool_pages, chunked_prefill, kv_cache_dtype, emit,
                       prefill_attention, kv_quant)


def _split_for(model, dev, who: str):
    """(outer, stacked layers) of ``model`` on ``dev``: the stacked
    layers are new tensors, so a caller that holds no other reference
    to the model may drop it to halve the weights' memory."""
    for option in ("fuse_attention_qkv", "fuse_ffn_gate_up"):
        if getattr(model.config, option):
            raise ValueError(
                f"{who} reads the unfused projection "
                f"weights (q/k/v_proj, gate/up_proj), as the reference's "
                f"decode factories do; this model has {option}=True: load "
                f"its weights into a model built without it")
    outer, layers = split_params(model)
    return ({k: v.to(dev) for k, v in outer.items()},
            {k: v.to(dev) for k, v in layers.items()})


def _paged_from(cfg, outer, layers, dev, page_size, n_pool_pages,
                chunked_prefill, kv_cache_dtype, emit, prefill_attention,
                kv_quant):
    """The paged factory's programs over split parameters already on
    ``dev`` (the serving factory shares one copy with the dense
    backend)."""
    L = cfg.num_hidden_layers
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = cfg.hidden_size // nh
    dtype = layers["self_attn.q_proj.weight"].dtype

    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: use None "
                         "(model dtype) or 'int8'")
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant {kv_quant!r}: use None or 'int8' "
                         "('pressure' is not ported yet, ROADMAP item 11)")
    quantized = kv_cache_dtype == "int8" or kv_quant == "int8"
    if emit not in ("token", "logits"):
        raise ValueError(f"emit {emit!r}: use 'token' or 'logits'")
    if prefill_attention not in ("gather", "kernel"):
        raise ValueError(f"prefill_attention {prefill_attention!r}: "
                         "use 'gather' or 'kernel'")
    if chunked_prefill is not None and chunked_prefill % page_size:
        raise ValueError("chunked_prefill must be a multiple of "
                         f"page_size ({page_size})")

    def _idx(x):
        return torch.as_tensor(x, device=dev).long()

    def _emit(logits):
        if emit == "token":
            return torch.argmax(logits, -1).to(torch.int32)
        return logits.to(torch.float32)

    def init_pools():
        shape = (L, nkv, n_pool_pages, page_size, hd)
        if quantized:
            def one():
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.ones(shape[:-1], dtype=torch.float32,
                                   device=dev))
            return one(), one()
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def _layer_pools(pools, l):
        """Layer l's views of the pools: writes land in the pools."""
        k_pools, v_pools = pools
        if quantized:
            return ((k_pools[0][l], k_pools[1][l]),
                    (v_pools[0][l], v_pools[1][l]))
        return k_pools[l], v_pools[l]

    def _write_chunk(pool_l, kv, page_tables, start, C):
        """kv (B, nkv, C, hd) written at absolute positions start.. —
        start and C are page multiples, so whole pages scatter."""
        B = kv.shape[0]
        npg = C // page_size
        first = start // page_size
        ids = page_tables[:, first:first + npg].reshape(-1)

        def pageify(a, *trail):
            a = a.reshape((B, nkv, npg, page_size) + tuple(trail))
            order = (1, 0, 2, 3) + tuple(range(4, a.dim()))
            return a.permute(order).reshape(
                (nkv, B * npg, page_size) + tuple(trail))

        if isinstance(pool_l, tuple):
            data, sc = pool_l
            qd, s = _q8(kv)
            data[:, ids] = pageify(qd, hd)
            sc[:, ids] = pageify(s)
        else:
            pool_l[:, ids] = pageify(kv, hd).to(pool_l.dtype)

    def _write_token(pool_l, kv, page_tables, lengths):
        """kv (B, nkv, 1, hd) written at each sequence's current end."""
        pages = page_tables.gather(1, (lengths // page_size)[:, None])[:, 0]
        offs = lengths % page_size
        if isinstance(pool_l, tuple):
            data, sc = pool_l
            qd, s = _q8(kv)
            data[:, pages, offs] = qd[:, :, 0].transpose(0, 1)
            sc[:, pages, offs] = s[:, :, 0].T
        else:
            pool_l[:, pages, offs] = \
                kv[:, :, 0].transpose(0, 1).to(pool_l.dtype)

    def _kernel_operands(kp, vp):
        if isinstance(kp, tuple):
            return kp[0], vp[0], {"k_scales": kp[1], "v_scales": vp[1]}
        return kp, vp, {}

    @torch.no_grad()
    def prefill(outer, layers_, tokens, page_tables, lengths, pools):
        """Prompts padded to a page multiple; ``lengths`` are the REAL
        prompt lengths (padding K/V lands in allocated pages but is
        masked by lengths everywhere downstream)."""
        tokens, pt, lengths = _idx(tokens), _idx(page_tables), _idx(lengths)
        B, T = tokens.shape
        if T % page_size:
            raise ValueError(f"prefill length {T} must be a multiple of "
                             f"page_size {page_size} (pad the prompt)")
        x = outer["model.embed_tokens.weight"][tokens]
        pos_vec = torch.arange(T, device=dev)
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=dev))
        key_ok = pos_vec[None, :] < lengths[:, None]
        mask = causal[None, None] & key_ok[:, None, None, :]
        for l in range(L):
            kp_l, vp_l = _layer_pools(pools, l)

            def attend(q, k, v):
                _write_chunk(kp_l, k, pt, 0, T)
                _write_chunk(vp_l, v, pt, 0, T)
                return _attend(cfg, q, k, v, mask)

            x = _layer_math(cfg, {k: v[l] for k, v in layers_.items()}, x,
                            pos_vec, attend)
        x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
        x_last = x[torch.arange(B, device=dev), lengths - 1]
        return _emit(_logits(cfg, outer, x_last)), pools

    @torch.no_grad()
    def decode_step(outer, layers_, tok, page_tables, lengths, pools):
        tok, pt, lengths = _idx(tok), _idx(page_tables), _idx(lengths)
        x = outer["model.embed_tokens.weight"][tok][:, None]   # (B, 1, H)
        pos = lengths[:, None]                                 # per sequence
        # converted once per step, not once per layer
        pt32 = pt.to(torch.int32)
        seen = (lengths + 1).to(torch.int32)
        for l in range(L):
            kp_l, vp_l = _layer_pools(pools, l)

            def attend(q, k, v):
                _write_token(kp_l, k, pt, lengths)
                _write_token(vp_l, v, pt, lengths)
                kd, vd, scales = _kernel_operands(kp_l, vp_l)
                ctx = paged_attention(q[:, :, 0], kd, vd, pt32, seen,
                                          **scales)
                return ctx.to(q.dtype)[:, :, None]

            x = _layer_math(cfg, {k: v[l] for k, v in layers_.items()}, x,
                            pos, attend)
        x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
        return _emit(_logits(cfg, outer, x[:, 0])), pools

    def _prefill_chunk(outer, layers_, chunk, start, pt, lengths, pools,
                       x_last):
        """One C-token chunk at absolute positions start..start+C-1:
        writes its pages, attends to every pool position < start+C, and
        harvests the hidden state of each sequence's (length-1) row when
        it falls inside this chunk."""
        B, C = chunk.shape
        S = pt.shape[1] * page_size
        x = outer["model.embed_tokens.weight"][chunk]
        pos_vec = start + torch.arange(C, device=dev)
        if prefill_attention == "kernel":
            pt32, len32 = pt.to(torch.int32), lengths.to(torch.int32)
        else:
            # causal over ABSOLUTE key positions, bounded by real length
            kpos = torch.arange(S, device=dev)
            mask = ((kpos[None, None, :] <= pos_vec[None, :, None])
                    & (kpos[None, None, :] < lengths[:, None, None]))
            mask = mask[:, None]                             # (B, 1, C, S)
        for l in range(L):
            kp_l, vp_l = _layer_pools(pools, l)

            def attend(q, k, v):
                _write_chunk(kp_l, k, pt, start, C)
                _write_chunk(vp_l, v, pt, start, C)
                if prefill_attention == "kernel":
                    kd, vd, scales = _kernel_operands(kp_l, vp_l)
                    ctx = paged_prefill_attention(q, kd, vd, pt32, len32,
                                                      start, **scales)
                    return ctx.to(q.dtype)

                def gather(pool):
                    """(B, nkv, S, hd): gather the batch's pages first,
                    dequantize only that slice."""
                    if isinstance(pool, tuple):
                        data, sc = pool
                        g = (data[:, pt].to(torch.float32)
                             * sc[:, pt][..., None])
                    else:
                        g = pool[:, pt]
                    return g.transpose(0, 1).reshape(B, nkv, S, hd)

                return _attend(cfg, q, gather(kp_l).to(q.dtype),
                               gather(vp_l).to(q.dtype), mask)

            x = _layer_math(cfg, {k: v[l] for k, v in layers_.items()}, x,
                            pos_vec, attend)
        idx = torch.clamp(lengths - 1 - start, 0, C - 1)
        row = x[torch.arange(B, device=dev), idx]
        hit = ((lengths - 1 >= start) & (lengths - 1 < start + C))[:, None]
        return torch.where(hit, row, x_last)

    def _finish_prefill(outer, x_last):
        x = _rms(x_last, outer["model.norm.weight"], cfg.rms_norm_eps)
        return _emit(_logits(cfg, outer, x))

    @torch.no_grad()
    def prefill_chunked(outer, layers_, tokens, page_tables, lengths, pools,
                        resume_from: int = 0):
        """``resume_from`` (a chunk multiple): skip chunks whose pages
        already hold real K/V (the prefix-cache path; pass the MINIMUM
        cached count across the batch, rounded down to a chunk multiple).
        The final chunk always runs so the last-position logits exist."""
        C = chunked_prefill
        tokens, pt, lengths = _idx(tokens), _idx(page_tables), _idx(lengths)
        B, T = tokens.shape
        if T % C:
            raise ValueError(
                f"chunked prefill: padded prompt length {T} must be a "
                f"multiple of the chunk size {C}")
        if resume_from % C:
            raise ValueError(f"resume_from {resume_from} must be a "
                             f"chunk multiple ({C})")
        resume = min(resume_from, T - C)
        x_last = torch.zeros((B, cfg.hidden_size), dtype=dtype, device=dev)
        for s in range(resume, T, C):
            x_last = _prefill_chunk(outer, layers_, tokens[:, s:s + C], s,
                                    pt, lengths, pools, x_last)
        return _finish_prefill(outer, x_last), pools

    if chunked_prefill is not None:
        prefill = prefill_chunked  # noqa: F811

    @torch.no_grad()
    def decode_n(outer, layers_, tok, page_tables, lengths, pools, n):
        """n decode steps as a Python loop over decode_step. Returns
        (emits (n, B, ...), next_tok (B,), pools); the caller's length
        bookkeeping is lengths + n. With emit="logits" the fed-back token
        is the greedy argmax."""
        tok = _idx(tok).to(torch.int32)
        lens = _idx(lengths)
        emits = []
        for _ in range(n):
            nxt, pools = decode_step(outer, layers_, tok, page_tables, lens,
                                     pools)
            tok = nxt if nxt.dim() == 1 else \
                torch.argmax(nxt, -1).to(torch.int32)
            emits.append(nxt)
            lens = lens + 1
        return torch.stack(emits), tok, pools

    return outer, layers, init_pools(), prefill, decode_step, decode_n


def llama_decode_factory(model: LlamaForCausalLM, max_len: int = 256,
                         kv_cache_dtype: str | None = None,
                         weight_dtype: str | None = None, device=None):
    """Returns ``generate(tokens, max_new_tokens, generator=None,
    temperature=0.0, top_k=0, top_p=1.0, eos_token_id=None,
    pad_token_id=0) -> (B, S0 + max_new) token tensor``: a prefill and
    per-token decode steps over DENSE KV caches (L, B, nkv, max_len, hd),
    updated in place. ``device`` (``cuda`` unless ``"cpu"`` is asked
    for) holds the weights and caches.

    ``kv_cache_dtype="int8"`` stores the cache quantized (per-slot absmax
    over head_dim, ``_q8``); each step's own keys attend exactly, the
    stored past dequantized.

    ``generate.compiled(tokens, max_new_tokens)`` is the reference's
    one-program greedy variant; eagerly it is the same loop at
    temperature 0, returned as a numpy array as the reference returns
    it. ``sample`` draws from an explicit ``torch.Generator``, so sampled
    tokens cannot match the reference's JAX keys; greedy tokens do.
    ``generate._parts`` holds what the serving engine reads: ``outer``,
    ``layers``, ``prefill``, ``decode_step``, ``init_caches``,
    ``compiled_greedy``, ``rolling``.

    Not ported yet (ROADMAP item 10): ``weight_dtype="int8"`` and the
    rolling cache of a ``sliding_window`` shorter than ``max_len``.
    ``scan_layers`` has no meaning here (the layers are a Python loop).
    """
    dev = resolve_device(device)
    cfg = model.config
    _check_dense(cfg, max_len, kv_cache_dtype, weight_dtype)
    outer, layers = _split_for(model, dev, "llama_decode_factory")
    return _dense_from(cfg, outer, layers, dev, max_len, kv_cache_dtype)


def _check_dense(cfg, max_len, kv_cache_dtype, weight_dtype):
    if weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype {weight_dtype!r}: use None or "
                         "'int8'")
    if weight_dtype == "int8":
        raise NotImplementedError(
            "weight_dtype='int8' (the int8 weight tuples through _mm) is "
            "not ported yet (ROADMAP item 10)")
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: use None "
                         "(model dtype) or 'int8'")
    window = getattr(cfg, "sliding_window", None)
    if window is not None and window < max_len:
        raise NotImplementedError(
            f"sliding_window {window} < max_len {max_len}: the rolling "
            "dense cache (_layer_step_rolling_prefill) is not ported yet "
            "(ROADMAP item 10)")


def _dense_from(cfg, outer, layers, dev, max_len, kv_cache_dtype):
    """The dense factory's programs over split parameters already on
    ``dev`` (the serving factory shares one copy with the paged
    backend)."""
    L = cfg.num_hidden_layers
    nkv = cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    quantized = kv_cache_dtype == "int8"
    embed = outer["model.embed_tokens.weight"]

    def init_caches(B, dtype):
        shape = (L, B, nkv, max_len, hd)
        if quantized:
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.ones(shape[:-1], dtype=torch.float32,
                               device=dev))
        return torch.zeros(shape, dtype=dtype, device=dev)

    def _layer_cache(caches, l):
        if isinstance(caches, tuple):
            return caches[0][l], caches[1][l]
        return caches[l]

    def _run(outer, layers_, x, pos_vec, key_mask, write_at, kc, vc):
        for l in range(L):
            x = _layer_step(cfg, {k: v[l] for k, v in layers_.items()}, x,
                            _layer_cache(kc, l), _layer_cache(vc, l),
                            pos_vec, key_mask, write_at)
        return _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)

    @torch.no_grad()
    def prefill(outer, layers_, tokens, k_caches, v_caches):
        """tokens (B, S0) -> (last-position logits (B, V), caches)."""
        tokens = torch.as_tensor(tokens, device=dev).long()
        S0 = tokens.shape[1]
        causal = torch.tril(torch.ones((S0, S0), dtype=torch.bool,
                                       device=dev))
        x = _run(outer, layers_, outer["model.embed_tokens.weight"][tokens],
                 torch.arange(S0, device=dev), causal, 0, k_caches,
                 v_caches)
        return _logits(cfg, outer, x[:, -1]), k_caches, v_caches

    @torch.no_grad()
    def decode_step(outer, layers_, token, pos, k_caches, v_caches):
        """token (B,); ``pos``: the absolute position of ``token``, a
        Python int (a slice bound on the host: no read from the
        card)."""
        pos = int(pos)
        token = torch.as_tensor(token, device=dev).long()
        x = outer["model.embed_tokens.weight"][token][:, None]
        key_mask = torch.ones((1, pos + 1), dtype=torch.bool, device=dev)
        x = _run(outer, layers_, x, torch.full((1,), pos, device=dev),
                 key_mask, pos, k_caches, v_caches)
        return _logits(cfg, outer, x[:, 0]), k_caches, v_caches

    def sample(logits, generator, temperature, top_k, top_p):
        if temperature <= 0.0:
            return torch.argmax(logits, -1)
        logits = logits / temperature
        top_k = min(top_k, logits.shape[-1])  # huge k = no truncation
        if top_k > 0:
            kth = torch.sort(logits, -1).values[:, -top_k][:, None]
            logits = torch.where(logits < kth, -math.inf, logits)
        if top_p < 1.0:
            # nucleus: the smallest prefix of the sorted distribution
            # whose mass reaches top_p; top_p <= 0 clamps to top-1
            p = max(float(top_p), 1e-9)
            srt = torch.sort(logits, -1, descending=True).values
            probs = torch.softmax(srt.to(torch.float32), -1)
            cum = torch.cumsum(probs, -1)
            keep = (cum - probs) < p  # mass BEFORE this token
            cutoff = torch.where(keep, srt, math.inf).amin(-1, keepdim=True)
            logits = torch.where(logits < cutoff, -math.inf, logits)
        probs = torch.softmax(logits.to(torch.float32), -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def _check_len(S0, max_new_tokens):
        if S0 + max_new_tokens > max_len:
            # past max_len the cache writes would corrupt generations
            raise ValueError(
                f"prompt {S0} + max_new_tokens {max_new_tokens} exceeds "
                f"the factory's max_len {max_len}")

    def generate(tokens, max_new_tokens: int, generator=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id: int | None = None,
                 pad_token_id: int = 0):
        """``eos_token_id`` enables batched early stop: rows that have
        emitted EOS produce ``pad_token_id`` from then on, and the loop
        exits once every row has finished (polled every 8 steps)."""
        tokens = torch.as_tensor(tokens, device=dev).long()
        B, S0 = tokens.shape
        _check_len(S0, max_new_tokens)
        kc = init_caches(B, embed.dtype)
        vc = init_caches(B, embed.dtype)
        logits, kc, vc = prefill(outer, layers, tokens, kc, vc)
        out = [tokens]
        pos = S0
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        for i in range(max_new_tokens):
            nxt = sample(logits, generator, temperature, top_k, top_p)
            if eos_token_id is not None:
                nxt = torch.where(finished, pad_token_id, nxt)
                finished = finished | (nxt == eos_token_id)
            out.append(nxt[:, None])
            if eos_token_id is not None \
                    and (i % 8 == 7 or i + 1 == max_new_tokens) \
                    and bool(finished.all()):
                break  # every row has emitted EOS
            if i + 1 < max_new_tokens:
                logits, kc, vc = decode_step(outer, layers, nxt, pos, kc,
                                             vc)
                pos += 1
        return torch.cat(out, 1)

    def compiled_greedy(outer_, layers_, tokens, max_new):
        """prefill + max_new greedy steps (the reference's one-program
        scan, eagerly)."""
        B, S0 = tokens.shape
        kc = init_caches(B, embed.dtype)
        vc = init_caches(B, embed.dtype)
        logits, kc, vc = prefill(outer_, layers_, tokens, kc, vc)
        gen = []
        for i in range(max_new):
            nxt = torch.argmax(logits, -1)
            gen.append(nxt[:, None])
            if i + 1 < max_new:
                logits, kc, vc = decode_step(outer_, layers_, nxt, S0 + i,
                                             kc, vc)
        return torch.cat([tokens] + gen, 1)

    def generate_compiled(tokens, max_new_tokens: int):
        """Greedy-only variant of generate() (the same output as
        temperature=0), as a numpy array."""
        tokens = torch.as_tensor(tokens, device=dev).long()
        if max_new_tokens < 1:
            return tokens.cpu().numpy()
        _check_len(tokens.shape[1], max_new_tokens)
        return compiled_greedy(outer, layers, tokens,
                               max_new_tokens).cpu().numpy()

    generate.compiled = generate_compiled
    generate._parts = {"outer": outer, "layers": layers,
                       "prefill": prefill, "decode_step": decode_step,
                       "init_caches": init_caches,
                       "compiled_greedy": compiled_greedy,
                       "rolling": False}
    return generate


# --- host configs the serving engine reads ---------------------------------

@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Multi-adapter LoRA layout for the paged serving decode path: a
    device bank of ``n_slots`` stacked low-rank delta sets over the q/v
    projections, applied per batch row by slot index. Slot 0 is the
    reserved identity. The port carries the host config; the bank is
    not ported yet (ROADMAP item 11)."""

    n_slots: int = 4
    rank: int = 4
    scale: float = 1.0

    def __post_init__(self):
        if self.n_slots < 2:
            raise ValueError("LoRAConfig needs n_slots >= 2 (slot 0 "
                             "is the reserved identity)")
        if self.rank < 1:
            raise ValueError("LoRAConfig rank must be >= 1")


def as_lora_config(lora) -> "LoRAConfig | None":
    """None stays None, ``(n_slots, rank)`` becomes a LoRAConfig, a
    LoRAConfig passes through."""
    if lora is None or isinstance(lora, LoRAConfig):
        return lora
    if isinstance(lora, tuple) and len(lora) == 2:
        return LoRAConfig(n_slots=int(lora[0]), rank=int(lora[1]))
    raise ValueError(f"lora {lora!r}: pass None, (n_slots, rank), or "
                     "a LoRAConfig")


LORA_KEYS = ("q_A", "q_B", "v_A", "v_B")


def synthesize_lora_deltas(cfg, rank: int, seed: int = 0,
                           init_scale: float = 0.02) -> dict:
    """One seeded host LoRA delta set for ``cfg``: ``q_A``/``v_A`` (L, H,
    r) and ``q_B``/``v_B`` (L, r, out) numpy float32, both factors
    nonzero. Deterministic in (cfg, rank, seed)."""
    rng = np.random.default_rng(seed)
    L = cfg.num_hidden_layers
    H = cfg.hidden_size
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh

    def draw(*shape):
        return (rng.standard_normal(shape) * init_scale).astype(
            np.float32)

    return {"q_A": draw(L, H, rank), "q_B": draw(L, rank, nh * hd),
            "v_A": draw(L, H, rank), "v_B": draw(L, rank, nkv * hd)}


@dataclasses.dataclass(frozen=True)
class GrammarConfig:
    """Constrained-decoding layout: a bank of ``n_slots * max_states``
    packed allow-bitmask rows, indexed per row by ``slot * max_states +
    state``; slot 0 is the all-allow identity. The port carries the host
    config; the mask bank is not ported yet (ROADMAP item 11)."""

    n_slots: int = 4
    max_states: int = 64

    def __post_init__(self):
        if self.n_slots < 2:
            raise ValueError("GrammarConfig needs n_slots >= 2 "
                             "(slot 0 is the reserved all-allow "
                             "identity)")
        if self.max_states < 2:
            raise ValueError("GrammarConfig max_states must be >= 2")


def as_grammar_config(grammar) -> "GrammarConfig | None":
    """None stays None, ``(n_slots, max_states)`` becomes a
    GrammarConfig, a GrammarConfig passes through."""
    if grammar is None or isinstance(grammar, GrammarConfig):
        return grammar
    if isinstance(grammar, tuple) and len(grammar) == 2:
        return GrammarConfig(n_slots=int(grammar[0]),
                             max_states=int(grammar[1]))
    raise ValueError(f"grammar {grammar!r}: pass None, (n_slots, "
                     "max_states), or a GrammarConfig")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Adaptive speculative-decode policy for the serving engine: a
    draft window of ``n_draft`` tokens verified in one target block,
    eligibility by priority and deadline, an acceptance floor on an
    EWMA, and an overload fallback. The port carries the host config;
    the draft/verify programs are not ported yet (ROADMAP item 11)."""

    n_draft: int = 4
    accept_floor: float = 0.35
    ewma_alpha: float = 0.25
    min_rounds: int = 8
    max_priority: int = 0
    loose_deadline_ms: float = 8000.0
    overload_fallback: bool = True

    def __post_init__(self):
        if self.n_draft < 1:
            raise ValueError("SpecConfig n_draft must be >= 1")
        if not 0.0 <= self.accept_floor <= 1.0:
            raise ValueError("accept_floor is an acceptance fraction "
                             "in [0, 1]")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.min_rounds < 1:
            raise ValueError("min_rounds must be >= 1")
        if self.loose_deadline_ms < 0:
            raise ValueError("loose_deadline_ms must be >= 0")


def as_spec_config(spec) -> "SpecConfig | None":
    """None/False stays off, True is the stock SpecConfig (bool checked
    first: True is an int), an int is the draft window, a SpecConfig
    passes through."""
    if isinstance(spec, bool):
        return SpecConfig() if spec else None
    if spec is None or isinstance(spec, SpecConfig):
        return spec
    if isinstance(spec, int):
        return SpecConfig(n_draft=spec)
    raise ValueError(f"spec {spec!r}: pass None, True, an int "
                     "n_draft, or a SpecConfig")


@dataclasses.dataclass(frozen=True)
class TPConfig:
    """Tensor-parallel layout for the serving decode path: a 1-D device
    mesh, heads and MLP hidden dims split over ``axis``. The port
    carries the host config only: sharded serving (and the reference's
    ``build_mesh``) is not ported yet (ROADMAP item 11)."""

    mesh_shape: tuple = (2,)
    axis: str = "tp"
    hbm_budget_bytes_per_device: int | None = None

    def __post_init__(self):
        shape = tuple(int(s) for s in self.mesh_shape)
        object.__setattr__(self, "mesh_shape", shape)
        if len(shape) != 1 or shape[0] < 1:
            raise ValueError(f"TPConfig mesh_shape {shape}: tensor "
                             "parallelism is a 1-D mesh (one named "
                             "axis)")

    @property
    def size(self) -> int:
        return self.mesh_shape[0]


def as_tp_config(tp) -> TPConfig | None:
    """None stays None, an int becomes a 1-D TPConfig of that many
    devices, a TPConfig passes through."""
    if tp is None or isinstance(tp, TPConfig):
        return tp
    if isinstance(tp, int):
        return TPConfig(mesh_shape=(tp,))
    raise ValueError(f"tp {tp!r}: pass None, an int degree, or a "
                     "TPConfig")


def _leaves(tree):
    """The tensors and arrays of a nested tuple / list / dict."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _tree_map(fn, tree):
    """``fn`` over the leaves of a nested tuple / list / dict, keeping
    its structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def repage_kv_data(data, page_size_from: int, page_size_to: int,
                   n_tokens: int):
    """Re-page an exported KV chain across page geometries: every leaf is
    ``(L, Hkv, n_pages, page_size, *tail)``, tokens packed in chain
    order; keep the ``n_tokens`` real positions, pad to the destination
    chain's slot count (data with 0, per-slot scales with 1) and refold.
    Host numpy, as the reference's."""
    n_to = -(-n_tokens // page_size_to)

    def one(a):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)
        L, H, n, ps = a.shape[:4]
        tail = a.shape[4:]
        if n * ps < n_tokens:
            raise ValueError(
                f"repage: chain carries {n}x{ps} slots but claims "
                f"{n_tokens} tokens")
        flat = a.reshape(L, H, n * ps, *tail)[:, :, :n_tokens]
        pad = n_to * page_size_to - n_tokens
        if pad:
            fill = np.ones if len(tail) == 0 else np.zeros
            flat = np.concatenate(
                [flat, fill((L, H, pad) + tail, a.dtype)], axis=2)
        return flat.reshape(L, H, n_to, page_size_to, *tail)

    return _tree_map(one, data)


def transcode_kv_data(data, quant_from, quant_to):
    """Transcode an exported full-precision chain ``(k, v)`` into the
    int8 codec with the same ``_q8`` the destination's write path uses.
    ``'pressure'`` destinations are not ported yet (ROADMAP item 11);
    quantized sources do not transcode."""
    if quant_from is not None:
        raise ValueError(
            f"transcode: source codec {quant_from!r} is not "
            "transcodable (only full-precision chains re-encode)")
    k, v = (torch.as_tensor(x) for x in data)
    if quant_to == "int8":
        return _q8(k), _q8(v)
    if quant_to == "pressure":
        raise _not_ported("transcoding to kv_quant='pressure'", 11)
    raise ValueError(f"transcode: unknown destination codec "
                     f"{quant_to!r}")


def tree_device_bytes(tree) -> int:
    """Resident bytes of ``tree``'s leaves on one device. Nothing is
    sharded in the port, so each leaf counts whole."""
    return sum(int(a.nbytes) if hasattr(a, "nbytes")
               else np.asarray(a).nbytes for a in _leaves(tree))


def kv_quant_page_bytes(cfg, page_size: int, dtype) -> tuple:
    """(full precision, int8 + scale) bytes ONE page costs across all
    layers, k + v: an int8 slot stores head_dim int8 bytes plus one f32
    scale."""
    L = cfg.num_hidden_layers
    nkv = cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    slots = L * nkv * page_size
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * slots * hd * itemsize, 2 * slots * (hd + 4)


# --- the router and the serving factory ------------------------------------

def route_decode(lengths, capacity: int, shared_prefix: bool = False,
                 expect_churn: bool = False, explain: bool = False):
    """Serving router: pick the decode backend from batch statistics.
    Returns "paged" or "dense" (``explain=True``: ``(backend, rule)``,
    the clause that fired, which the serving engine logs).

    - shared prompt prefixes -> paged (prefix pages are shared across
      sequences; the dense cache replicates them per slot)
    - admission/eviction churn -> paged (dense slots pin max_len memory
      for the whole batch lifetime)
    - ragged lengths -> paged (the dense cache walks max-length KV for
      every row; pages walk only real lengths)
    - severely under-full capacity -> paged (dense pays full-capacity
      compute for empty slots)
    - otherwise (uniform, near-full) -> dense

    The reference's clauses and their wording, as the engine's decision
    log records them. The reference derived them from TPU measurements;
    none is re-derived for the card yet.
    """
    from ...obs import metrics as _obs_metrics

    def _r(backend, rule):
        # one obs counter per (clause, backend): the label is the rule
        # text up to its parenthesized rationale
        _obs_metrics.counter(
            "route_decode_total", "routing-rule firings by clause",
            rule=rule.split(" (")[0], backend=backend).inc()
        return (backend, rule) if explain else backend

    lens = np.asarray(lengths)
    if shared_prefix:
        return _r("paged", "shared-prefix (prefix pages shared across "
                           "sequences; dense replicates per slot)")
    if expect_churn:
        return _r("paged", "churn (dense slots pin max_len memory for "
                           "the batch lifetime)")
    B = int(lens.size)
    if B == 0:
        return _r("dense", "empty wave")
    spread = float(lens.max() - lens.min()) / max(1.0, float(lens.max()))
    if spread > 0.25:
        return _r("paged", f"ragged lengths (spread {spread:.2f} > 0.25; "
                           "pages walk only real lengths)")
    if B < capacity // 2:
        return _r("paged", f"under-full (B={B} < capacity {capacity}//2; "
                           "dense pays full-capacity compute)")
    return _r("dense", "uniform near-full wave (dense compiled wins "
                       "every uniform shape measured, PERF record 37)")


class PagedOnlyDense:
    """The dense-backend stub of a paged-only serving factory
    (``serving.sim`` uses it): enough surface for
    ``ServingEngine.__init__``'s dense introspection (the ``rolling``
    check and the embed-tokens dtype read), with every dense call
    raising ``reason``."""

    def __init__(self, reason: str):
        def _raise(*a, **k):
            raise NotImplementedError(reason)
        self._raise = _raise
        self._parts = {
            "rolling": False,
            "outer": {"model.embed_tokens.weight":
                      np.zeros((1, 1), np.float32)},
            "init_caches": _raise,
            "prefill": _raise,
            "decode_step": _raise,
        }

    def __call__(self, *a, **k):
        self._raise()


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item "
                               f"{item})")


def llama_serving_decode_factory(model: LlamaForCausalLM,
                                 max_len: int = 256,
                                 page_size: int = 64,
                                 n_pool_pages: int = 256,
                                 kv_cache_dtype: str | None = None,
                                 batch_capacity: int = 8,
                                 chunked_prefill: int | None = None,
                                 tp: "TPConfig | int | None" = None,
                                 lora: "LoRAConfig | tuple | None"
                                 = None,
                                 draft: LlamaForCausalLM | None = None,
                                 kv_quant: str | None = None,
                                 grammar: "GrammarConfig | tuple | "
                                 "None" = None,
                                 device=None):
    """Both decode backends behind one object and the router: build
    once, then ``pick(lengths, ...)`` returns ("dense", gen) or
    ("paged", (outer, layers, pools, prefill, decode_step, decode_n))
    per batch. The model's parameters are split ONCE and both backends
    hold the same ``outer`` / ``layers`` tensors; a caller that holds no
    other reference to ``model`` may drop it.

    ``batch_capacity`` is the batch size the dense backend is expected
    to serve and ``pick``'s default ``capacity``. ``kv_cache_dtype``
    (or ``kv_quant="int8"``) reaches both backends. The paged backend is
    built as the reference builds it: ``chunked_prefill`` chunks
    attending through the plain page gather (only decode reaches the
    paged kernel). ``device``: ``cuda`` unless ``"cpu"`` is asked for.

    Not ported yet, each refused by name (ROADMAP item 11): ``tp``,
    ``lora``, ``draft`` (speculative serving), ``grammar`` and
    ``kv_quant="pressure"``. ``scan_layers`` has no meaning here.
    """
    tp = as_tp_config(tp)
    lora = as_lora_config(lora)
    grammar = as_grammar_config(grammar)
    if kv_quant not in (None, "int8", "pressure"):
        raise ValueError(f"kv_quant {kv_quant!r}: use None, 'int8' or "
                         "'pressure'")
    for name, value in (("tp", tp), ("lora", lora),
                        ("draft (speculative serving)", draft),
                        ("grammar", grammar)):
        if value is not None:
            raise _not_ported(f"llama_serving_decode_factory({name}=...)",
                              11)
    if kv_quant == "pressure":
        raise _not_ported("kv_quant='pressure' (the compacting page tier)",
                          11)
    if kv_quant == "int8":
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError("kv_quant='int8' IS kv_cache_dtype="
                             f"'int8' — {kv_cache_dtype!r} conflicts")
        kv_cache_dtype = "int8"
    dev = resolve_device(device)
    cfg = model.config
    _check_dense(cfg, max_len, kv_cache_dtype, None)
    outer, layers = _split_for(model, dev, "llama_serving_decode_factory")
    gen = _dense_from(cfg, outer, layers, dev, max_len, kv_cache_dtype)
    paged = _paged_from(cfg, outer, layers, dev, page_size, n_pool_pages,
                        chunked_prefill, kv_cache_dtype, "token", "gather",
                        kv_quant)

    class _Serving:
        # staticmethod: a bare function class attribute would bind as a
        # method and take the first positional argument as self
        dense = staticmethod(gen)
        paged_parts = paged
        capacity = batch_capacity
        # the build configuration ServingEngine(serving=...) reads
        max_len_ = max_len
        page_size_ = page_size
        n_pool_pages_ = n_pool_pages
        chunked_prefill_ = chunked_prefill
        tp_ = None
        lora_ = None
        grammar_ = None
        grammar_vocab_ = cfg.vocab_size
        kv_quant_ = kv_quant
        page_bytes_ = (kv_quant_page_bytes(
            cfg, page_size, layers["self_attn.q_proj.weight"].dtype)
            if kv_quant is not None else None)
        spec_parts = None

        def pick(self, lengths, capacity=None, shared_prefix=False,
                 expect_churn=False):
            # the live attribute, so a caller who adjusts capacity sees
            # routing follow
            cap = capacity if capacity is not None else self.capacity
            backend = route_decode(lengths, cap, shared_prefix,
                                   expect_churn)
            return backend, (gen if backend == "dense" else paged)

    return _Serving()
