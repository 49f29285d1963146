"""Paged KV-cache decode for Llama in the PyTorch port: the
continuous-batching serving path.

Counterpart of ``paddle_tpu/models/nlp/llama_decode.py`` (the helpers
``_mm``, ``_proj_qkv``, ``_q8``, ``_attend``, ``_layer_math``, ``_logits``
and ``llama_paged_decode_factory``). The reference jits each program and
scans over the stacked layers; PyTorch runs eagerly, so each program here
is a Python loop over the layers, and the attention over the pool is the
paged-attention CUDA kernel (``ops/paged_attention.py``) on the card, or
its plain version on the CPU.

Pools are updated IN PLACE (the reference donates them to its jitted
programs); every function returns the same pool tensors it was given.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...core.place import resolve_device
from ...ops.paged_attention import paged_attention, paged_prefill_attention
from .llama import LlamaForCausalLM, apply_rotary
from .llama_functional import _rms, split_params


def _mm(x, w):
    """x @ w for a plain (in, out) weight. The reference's int8 weight
    tuples come with the dense factory (ROADMAP Queue 1)."""
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

    Not ported yet (ROADMAP Queue 1): ``tp``, ``lora``, ``grammar``,
    ``kv_quant="pressure"``, ``prefill_ragged``; ``scan_layers`` has no
    meaning here (the layers are a Python loop). A model with fused
    projection weights is refused: the decode programs read the unfused
    keys, as the reference's do.
    """
    dev = resolve_device(device)
    cfg = model.config
    for option in ("fuse_attention_qkv", "fuse_ffn_gate_up"):
        if getattr(cfg, option):
            raise ValueError(
                f"llama_paged_decode_factory reads the unfused projection "
                f"weights (q/k/v_proj, gate/up_proj), as the reference's "
                f"decode factories do; this model has {option}=True: load "
                f"its weights into a model built without it")
    outer, layers = split_params(model)
    outer = {k: v.to(dev) for k, v in outer.items()}
    layers = {k: v.to(dev) for k, v in layers.items()}
    L = cfg.num_hidden_layers
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = cfg.hidden_size // nh
    dtype = layers["self_attn.q_proj.weight"].dtype

    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: use None "
                         "(model dtype) or 'int8'")
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant {kv_quant!r}: use None or 'int8' "
                         "('pressure' is not ported yet, ROADMAP Queue 1)")
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
