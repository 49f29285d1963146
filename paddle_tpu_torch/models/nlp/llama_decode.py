"""Llama decode for the PyTorch port: the paged KV-cache factory (the
continuous-batching serving path) with its multi-adapter LoRA bank,
grammar mask bank, ragged prefill lane, speculative round and two-tier
("pressure") pool, the dense KV-cache factory with int8 weights and the
rolling cache of a sliding window, the speculative decode factory, the
router between the backends and the serving factory that holds them.

Counterpart of ``paddle_tpu/models/nlp/llama_decode.py`` (the helpers
``_mm``, ``_quantize_weights``, ``_bgmv``, ``_proj_qkv``, ``_q8``,
``_cache_write``, ``_cache_read``, ``_attend``, ``_layer_math``,
``_logits``, ``_layer_step_rolling_prefill``, ``_write_positions``;
``compact_kv_pages``, ``export_quant_pages``, ``import_quant_pages``,
``lora_bank_hooks``, ``grammar_bank_hooks``, ``build_spec_step``,
``llama_paged_decode_factory``, ``llama_decode_factory``,
``llama_speculative_decode_factory``, ``route_decode``,
``PagedOnlyDense``, ``llama_serving_decode_factory`` and the host configs
``TPConfig``, ``LoRAConfig``, ``SpecConfig``, ``GrammarConfig``). The
reference jits each program and scans over the stacked layers; PyTorch
runs eagerly, so each program here is a Python loop over the layers (and
a draft's walk a Python loop over its steps). The attention of a paged
decode step is the paged-attention CUDA kernel (``ops/paged_attention.py``)
on the card, or its plain version on the CPU; prefill chunks (by
default), the ragged lane and the speculative blocks attend through the
plain page gather, and the dense caches in plain PyTorch, as the
reference's do.

Pools, dense caches and the adapter and grammar banks are updated IN
PLACE (the reference donates them to its jitted programs or rebinds a
functional update); every function returns the same tensors it was
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
from ...quantization.int8 import int8_matmul, quantize_stacked
from .llama import LlamaForCausalLM, apply_rotary
from .llama_functional import _rms, split_params


def _mm(x, w):
    """x @ w for a plain (in, out) weight; a tuple ``(w_q int8 (in, out),
    scale f32 (out,))`` (``weight_dtype="int8"``) goes through the int8
    product (``quantization.int8.int8_matmul``)."""
    if not isinstance(w, tuple):
        return x @ w
    return int8_matmul(x, w[0], w[1])


def _quantize_weights(tree, keys):
    """Per-output-channel int8 for the named (..., in, out) weights:
    value -> (int8 data, f32 scale over the 'in' axis). A layer-stacked
    weight is quantized one layer at a time (the same bits as the whole
    stack at once), so its f32 temporary is one layer's."""
    out = dict(tree)
    for k in keys:
        w = tree.get(k)
        if w is None:
            continue
        if w.dim() < 3:
            out[k] = quantize_stacked(w)
            continue
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                        device=w.device)
        for l in range(w.shape[0]):
            q[l], s[l] = quantize_stacked(w[l])
        out[k] = (q, s)
    return out


_PROJ_KEYS = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
              "self_attn.v_proj.weight", "self_attn.o_proj.weight",
              "mlp.gate_proj.weight", "mlp.up_proj.weight",
              "mlp.down_proj.weight")


def _at(tree, l):
    """Layer l of stacked weights (an int8 weight is a (data, scale)
    pair, both stacked)."""
    return {k: (v[0][l], v[1][l]) if isinstance(v, tuple) else v[l]
            for k, v in tree.items()}


def _bgmv(h, A, B_, ids):
    """Batched gather matvec (Punica's BGMV): each row's low-rank delta
    ``(h @ A[row]) @ B[row]``. ``h`` (B, T, H); ``A`` (n_slots, H, r);
    ``B_`` (n_slots, r, out); ``ids`` (B,) slot indices. Two batched
    products over the gathered (B, H, r) and (B, r, out) factors: no
    per-row full-rank weight is ever formed."""
    ids = ids.long()
    return torch.bmm(torch.bmm(h, A.index_select(0, ids)),
                     B_.index_select(0, ids))


def _proj_qkv(cfg, p, h, pos, lora=None):
    """h: (B, T, H); pos: absolute positions broadcastable to (B, T).
    Returns q, k, v with rotary applied — q (B, nh, T, hd), k/v
    (B, nkv, T, hd).

    ``lora`` (multi-adapter serving): ``(bank_l, ids, scale)``, this
    layer's adapter-bank views (``q_A`` / ``q_B`` / ``v_A`` / ``v_B``,
    each (n_slots, ...)) and the per-row slot indices; the ``_bgmv``
    delta lands on q and v before the head reshape and the rotary. Slot
    0 holds zeros, so identity rows add an exact 0."""
    B, T, H = h.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh
    q = _mm(h, p["self_attn.q_proj.weight"])
    k = _mm(h, p["self_attn.k_proj.weight"]).reshape(B, T, nkv, hd)
    v = _mm(h, p["self_attn.v_proj.weight"])
    if lora is not None:
        bank_l, ids, scale = lora
        q = q + _bgmv(h, bank_l["q_A"], bank_l["q_B"], ids) * scale
        v = v + _bgmv(h, bank_l["v_A"], bank_l["v_B"], ids) * scale
    q = apply_rotary(q.reshape(B, T, nh, hd), pos, cfg.rope_theta)
    k = apply_rotary(k, pos, cfg.rope_theta)
    v = v.reshape(B, T, nkv, hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


_INV127 = np.float32(1.0 / 127.0)


def _q8(x, folded: bool = False):
    """Per-(batch, head, slot) absmax int8 quantization over head_dim —
    the KV-cache codec. Returns (int8 data, f32 scales). ``folded``:
    the scale as the reference's jitted programs compute it (XLA folds
    the division by the constant 127 into a product with its f32
    reciprocal, which differs in the last bit for some values);
    otherwise as its eager code divides."""
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(-1), 1e-8)
    scale = amax * _INV127 if folded else amax / 127.0
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


def _gmask(logits, grammar):
    """Constrained decoding: mask each row's logits with its grammar
    state's packed allow-bitmask before the argmax. ``grammar`` is
    ``(mask_table, state_ids)``: a ``(rows, ceil(V/32))`` int32 bank
    holding the reference's uint32 words bit for bit, and a (B,) flat
    row id per batch row. Bit ``t % 32`` of word ``t // 32`` allows
    token ``t``; an arithmetic shift of a negative word (bit 31 set)
    still leaves that bit in place for ``& 1``. Masked logits are -inf
    in the logits' dtype. Flat id 0 is the all-allow row; ``None``
    masks nothing."""
    if grammar is None:
        return logits
    table, gids = grammar
    V = logits.shape[-1]
    rows = table.index_select(0, gids.long())            # (B, words)
    tok = torch.arange(V, device=logits.device)
    allow = (rows[:, tok // 32] >> (tok % 32).to(rows.dtype)) & 1
    return logits.masked_fill(allow == 0, -math.inf)


def _write_positions(pool_l, kv, page_tables, positions, page_size):
    """kv (B, nkv, T, hd) written in place at PER-ROW absolute
    ``positions`` (B, T) through the page tables: the speculative
    draft / verify write, each (row, t) to its own (page, offset). A
    row that is not live has an all-zero table row, so its positions
    (-1 and 0 for the draft's two-token feed) resolve into the reserved
    page 0; a negative column counts from the end, as the reference's
    ``take_along_axis`` does."""
    W = page_tables.shape[1]
    cols = torch.remainder(torch.div(positions, page_size,
                                     rounding_mode="floor"), W)
    pages = page_tables.gather(1, cols)                   # (B, T)
    offs = torch.remainder(positions, page_size)
    if isinstance(pool_l, tuple):
        data, sc = pool_l
        qd, s = _q8(kv)
        data[:, pages, offs] = qd.transpose(0, 1)
        sc[:, pages, offs] = s.transpose(0, 1)
    else:
        pool_l[:, pages, offs] = kv.transpose(0, 1).to(pool_l.dtype)


def _pool_layer(pools, l):
    """Layer l's views of ``(k_pools, v_pools)`` (int8 pools are (data,
    scales) pairs): writes through them land in the pools."""
    k_pools, v_pools = pools
    if isinstance(k_pools, tuple):
        return ((k_pools[0][l], k_pools[1][l]),
                (v_pools[0][l], v_pools[1][l]))
    return k_pools[l], v_pools[l]


def _tier_merge(fp, qd, sc, t):
    """The two-tier read: where the page's tier bit ``t`` is set, the
    int8 arena dequantized in f32 and cast to the fp arena's dtype, else
    the fp arena (the reference's ``_tier_enter`` merge, elementwise)."""
    return torch.where(t, (qd.to(torch.float32) * sc[..., None]).to(
        fp.dtype), fp)


def _tier_view(pool_l):
    """One layer's whole merged full-precision pool (nkv, P, ps, hd) of a
    pressure read view ``(fp, int8, scales, tier)``: what the paged
    kernels read."""
    fp, qd, sc, tier = pool_l
    return _tier_merge(fp, qd, sc, tier[None, :, None, None])


def _gather_pages(pool_l, page_tables):
    """(B, nkv, W * page_size, hd): one layer's pages of the batch's
    tables gathered first, only that slice dequantized (a pressure read
    view ``(fp, int8, scales, tier)`` merged by its gathered tier
    bits)."""
    if isinstance(pool_l, tuple) and len(pool_l) == 4:
        fp, qd, sc, tier = pool_l
        g = _tier_merge(fp[:, page_tables], qd[:, page_tables],
                        sc[:, page_tables],
                        tier[page_tables][None, :, :, None, None])
    elif isinstance(pool_l, tuple):
        data, sc = pool_l
        g = data[:, page_tables].to(torch.float32) \
            * sc[:, page_tables][..., None]
    else:
        g = pool_l[:, page_tables]
    nkv, B, W, ps, hd = g.shape
    return g.transpose(0, 1).reshape(B, nkv, W * ps, hd)


def _layer_math(cfg, lp, x, pos_vec, attend, lora=None):
    """The shared decoder-layer body (rms -> qkv+rope -> attend -> o_proj
    residual -> mlp residual); ``attend(q, k, v) -> ctx`` owns the cache
    strategy. ``lora``: the optional per-layer delta (``_proj_qkv``)."""
    B, T, H = x.shape
    h = _rms(x, lp["input_layernorm.weight"], cfg.rms_norm_eps)
    q, k, v = _proj_qkv(cfg, lp, h, pos_vec, lora=lora)
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
        # tied embeddings stay unquantized (the same tensor feeds the
        # token lookup, where int8 would distort every embedding)
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
                write_at: int, n: int | None = None):
    """One decoder layer over T positions with a dense cache read and
    write. x (B, T, H); caches (B, nkv, C, hd) for this layer; the block
    lands at slot ``write_at`` and attends to the first ``n`` slots
    (default write_at + T; a rolling cache passes its live slots) under
    ``key_mask`` (T, n). The reference attends all C slots with the
    slots beyond masked, whose probabilities are exactly 0; the slice
    does the same work without them."""
    def attend(q, k, v):
        T = k.shape[2]
        n_read = write_at + T if n is None else n
        kc = _cache_write(k_cache, k, write_at)
        vc = _cache_write(v_cache, v, write_at)
        k_all = _cache_read(kc, q.dtype, n_read)
        v_all = _cache_read(vc, q.dtype, n_read)
        if isinstance(kc, tuple):
            # the EXACT current block over the dequantized cache: this
            # step's own keys are not round-tripped (quantization error
            # applies only to the stored past)
            k_all[:, :, write_at:write_at + T] = k.to(k_all.dtype)
            v_all[:, :, write_at:write_at + T] = v.to(v_all.dtype)
        return _attend(cfg, q, k_all, v_all, key_mask)

    return _layer_math(cfg, lp, x, pos_vec, attend)


def _layer_step_rolling_prefill(cfg, lp, x, pos_vec, key_mask, W,
                                k_cache, v_cache):
    """Prefill layer for a ROLLING (sliding-window) cache: attention runs
    banded over this block's own K/V, then only the last W positions land
    in the cache (B, nkv, W, hd) of this layer, each at slot p % W (a
    cyclic shift of the last W positions); a prompt shorter than W fills
    slots 0.. and zeros the rest. A quantized cache stores the whole
    window through ``_q8``, zero slots included, as the reference's
    does."""
    def attend(q, k, v):
        ctx = _attend(cfg, q, k, v, key_mask)
        B, nkv, S0, hd = k.shape
        for cache, kv in ((k_cache, k), (v_cache, v)):
            if S0 >= W:
                win = torch.roll(kv[:, :, S0 - W:], S0 % W, dims=2)
            else:
                win = torch.zeros((B, nkv, W, hd), dtype=kv.dtype,
                                  device=kv.device)
                win[:, :, :S0] = kv
            _cache_write(cache, win, 0)
        return ctx

    return _layer_math(cfg, lp, x, pos_vec, attend)


def llama_paged_decode_factory(model: LlamaForCausalLM,
                               page_size: int = 64,
                               n_pool_pages: int = 256,
                               chunked_prefill: int | None = None,
                               kv_cache_dtype: str | None = None,
                               emit: str = "token",
                               prefill_attention: str = "gather",
                               kv_quant: str | None = None,
                               lora: "LoRAConfig | tuple | None" = None,
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
      prefill(outer, layers, tokens (B,T), page_tables, lengths, pools,
              lora=None, grammar=None)
          -> (next_token (B,), pools)   [prompt K/V written to pages]
      decode_step(outer, layers, tok (B,), page_tables, lengths, pools,
                  lora=None, grammar=None)
          -> (next_token (B,), pools)   [lengths + 1 is the caller's
                                         bookkeeping]
      decode_n(outer, layers, tok, page_tables, lengths, pools, n,
               lora=None, grammar=None)
          -> (emits (n, B, ...), next_tok (B,), pools)
    Pools are updated in place and returned.

    ``chunked_prefill=C`` (a page multiple): prefill walks the prompt in
    C-token chunks, each attending causally to the pool pages written so
    far; it takes ``resume_from`` (a chunk multiple) to skip chunks whose
    pages already hold K/V. ``prefill_attention="kernel"`` attends each
    chunk through ``paged_prefill_attention`` (the paged kernel) instead
    of gathering the pages densely. With the gather, the chunked prefill
    also carries ``prefill._ragged``: ``prefill_ragged(outer, layers,
    chunk (R, C), starts (R,), page_tables, lengths, pools, lora=None,
    grammar=None)``, one C-token chunk per row at per-row offsets in one
    call (the serving engine's fused lane); it is left off under kernel
    attention so that one run never mixes the two numerics.

    ``lora`` (``LoRAConfig`` / ``(n_slots, rank)``): multi-adapter
    serving. Every callable takes a trailing ``lora=(adapter_bank,
    adapter_ids)``: the bank (``lora_bank_hooks``) stacks per-slot
    low-rank q / v deltas, the ids pick each row's slot (0: the zero
    identity), applied per row by ``_bgmv`` at the config's ``scale``.
    ``lora=None`` at the call runs no LoRA operation at all.
    ``grammar=(mask_table, state_ids)`` (``grammar_bank_hooks``) masks
    the logits of each row before its argmax (``_gmask``).

    ``kv_cache_dtype="int8"`` or ``kv_quant="int8"``: pages store the
    per-slot absmax int8 codec; the kernel dequantizes them.
    ``kv_quant="pressure"``: pools are ``((k_fp, k_int8, k_scales), (v_fp,
    v_int8, v_scales), tier)``: hot pages stay full precision, and
    ``compact_kv_pages`` quantizes parked pages into the int8 arena and
    sets their bits in the (P,) bool ``tier``; every read merges the two
    arenas by the tier bits, layer by layer (``_tier_view``, or the
    gathered pages' bits), and every write lands in the fp arena after
    clearing the written pages' bits, so pages that were never compacted
    read exactly what an untiered pool holds.
    ``emit="logits"``: return last-position logits (B, V) f32 instead of
    greedy tokens.

    Not ported yet: ``tp`` (ROADMAP item 11, option 6); ``scan_layers``
    has no meaning here (the layers are a Python loop). A model with
    fused projection weights is refused: the decode programs read the
    unfused keys, as the reference's do.
    """
    dev = resolve_device(device)
    lora = as_lora_config(lora)
    outer, layers = _split_for(model, dev, "llama_paged_decode_factory")
    return _paged_from(model.config, outer, layers, dev, page_size,
                       n_pool_pages, chunked_prefill, kv_cache_dtype, emit,
                       prefill_attention, kv_quant,
                       lora.scale if lora is not None else 1.0)


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
                kv_quant, lora_scale=1.0):
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
    if kv_quant not in (None, "int8", "pressure"):
        raise ValueError(f"kv_quant {kv_quant!r}: use None, 'int8' "
                         "(every page stored int8+scale) or 'pressure' "
                         "(parked pages compacted to int8 under byte "
                         "pressure)")
    quantized = kv_cache_dtype == "int8" or kv_quant == "int8"
    pressure = kv_quant == "pressure"
    if pressure and kv_cache_dtype is not None:
        raise ValueError("kv_quant='pressure' owns the pool codec "
                         "— drop kv_cache_dtype")
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

    def _emit(logits, grammar):
        logits = _gmask(logits, _on_dev(grammar))
        if emit == "token":
            return torch.argmax(logits, -1).to(torch.int32)
        return logits.to(torch.float32)

    def _on_dev(pair):
        """A ``(bank, ids)`` call argument with its ids on ``dev``."""
        return None if pair is None else (pair[0], _idx(pair[1]))

    def _per_layer(layers_, lora, l):
        """Layer l's weights and its LoRA triple for ``_layer_math``
        (None without adapters)."""
        lp = _at(layers_, l)
        if lora is None:
            return lp, None
        bank, ids = lora
        return lp, ({k: v[l] for k, v in bank.items()}, ids, lora_scale)

    def init_pools():
        shape = (L, nkv, n_pool_pages, page_size, hd)
        if pressure:
            # two tiers: full-precision pages, an int8 + scale shadow and
            # a (P,) tier mask saying which arena each page reads from
            def one():
                return (torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.ones(shape[:-1], dtype=torch.float32,
                                   device=dev))
            return one(), one(), torch.zeros((n_pool_pages,),
                                             dtype=torch.bool, device=dev)
        if quantized:
            def one():
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.ones(shape[:-1], dtype=torch.float32,
                                   device=dev))
            return one(), one()
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def _scatter_pages(pool_l, kv, ids, R, npg):
        """kv (R, nkv, npg * page_size, hd) written as whole pages at the
        page ids ``ids`` (R * npg,), row-major."""
        def pageify(a, *trail):
            a = a.reshape((R, nkv, npg, page_size) + tuple(trail))
            order = (1, 0, 2, 3) + tuple(range(4, a.dim()))
            return a.permute(order).reshape(
                (nkv, R * npg, page_size) + tuple(trail))

        if isinstance(pool_l, tuple):
            data, sc = pool_l
            qd, s = _q8(kv)
            data[:, ids] = pageify(qd, hd)
            sc[:, ids] = pageify(s)
        else:
            pool_l[:, ids] = pageify(kv, hd).to(pool_l.dtype)

    def _write_chunk(pool_l, kv, page_tables, start, C):
        """kv (B, nkv, C, hd) written at absolute positions start.. —
        start and C are page multiples, so whole pages scatter."""
        npg = C // page_size
        first = start // page_size
        _scatter_pages(pool_l, kv,
                       page_tables[:, first:first + npg].reshape(-1),
                       kv.shape[0], npg)

    def _write_chunk_ragged(pool_l, kv, page_tables, starts, C):
        """kv (R, nkv, C, hd) written at PER-ROW absolute positions
        starts[r].. (page multiples). Rows with nothing to run point at
        the reserved page 0; duplicate ids there hold garbage, and cohort
        rows rewriting a shared cached page carry identical content."""
        npg = C // page_size
        col = (starts // page_size)[:, None] + torch.arange(
            npg, device=dev)[None, :]
        _scatter_pages(pool_l, kv, page_tables.gather(1, col).reshape(-1),
                       kv.shape[0], npg)

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
        if isinstance(kp, tuple) and len(kp) == 4:
            return _tier_view(kp), _tier_view(vp), {}
        if isinstance(kp, tuple):
            return kp[0], vp[0], {"k_scales": kp[1], "v_scales": vp[1]}
        return kp, vp, {}

    def _layer_pools(pools, l):
        """Layer l's (write views, read views) of the pools. A pressure
        pool writes into its fp arena and reads ``(fp, int8, scales,
        tier)``, merged by the tier bits where it is read (the reference
        merges whole pools on entry, writes into the merged view and
        folds it back; with the written pages' bits cleared first, both
        leave the writes in the fp arena and read the same values).
        Other pools read what they write."""
        if not pressure:
            kv = _pool_layer(pools, l)
            return kv, kv
        (kf, kq, ks), (vf, vq, vs), tier = pools
        return ((kf[l], vf[l]),
                ((kf[l], kq[l], ks[l], tier), (vf[l], vq[l], vs[l], tier)))

    def _tier_clear(pools, written):
        """PRESSURE: the pages a program is about to write get fresh
        full-precision content, so their tier bits clear first: a
        recycled page id never reads stale int8 data."""
        if pressure:
            pools[2][written.reshape(-1)] = False

    @torch.no_grad()
    def prefill(outer, layers_, tokens, page_tables, lengths, pools,
                lora=None, grammar=None):
        """Prompts padded to a page multiple; ``lengths`` are the REAL
        prompt lengths (padding K/V lands in allocated pages but is
        masked by lengths everywhere downstream). ``grammar`` masks the
        first emitted token (each row's id its automaton's start
        state)."""
        tokens, pt, lengths = _idx(tokens), _idx(page_tables), _idx(lengths)
        lora = _on_dev(lora)
        B, T = tokens.shape
        if T % page_size:
            raise ValueError(f"prefill length {T} must be a multiple of "
                             f"page_size {page_size} (pad the prompt)")
        _tier_clear(pools, pt[:, :T // page_size])
        x = outer["model.embed_tokens.weight"][tokens]
        pos_vec = torch.arange(T, device=dev)
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=dev))
        key_ok = pos_vec[None, :] < lengths[:, None]
        mask = causal[None, None] & key_ok[:, None, None, :]
        for l in range(L):
            (kp_l, vp_l), _ = _layer_pools(pools, l)

            def attend(q, k, v):
                _write_chunk(kp_l, k, pt, 0, T)
                _write_chunk(vp_l, v, pt, 0, T)
                return _attend(cfg, q, k, v, mask)

            lp, lo = _per_layer(layers_, lora, l)
            x = _layer_math(cfg, lp, x, pos_vec, attend, lora=lo)
        x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
        x_last = x[torch.arange(B, device=dev), lengths - 1]
        return _emit(_logits(cfg, outer, x_last), grammar), pools

    @torch.no_grad()
    def decode_step(outer, layers_, tok, page_tables, lengths, pools,
                    lora=None, grammar=None):
        tok, pt, lengths = _idx(tok), _idx(page_tables), _idx(lengths)
        lora = _on_dev(lora)
        _tier_clear(pools, pt.gather(1, (lengths // page_size)[:, None]))
        x = outer["model.embed_tokens.weight"][tok][:, None]   # (B, 1, H)
        pos = lengths[:, None]                                 # per sequence
        # converted once per step, not once per layer
        pt32 = pt.to(torch.int32)
        seen = (lengths + 1).to(torch.int32)
        for l in range(L):
            (kp_l, vp_l), (kr_l, vr_l) = _layer_pools(pools, l)

            def attend(q, k, v):
                _write_token(kp_l, k, pt, lengths)
                _write_token(vp_l, v, pt, lengths)
                kd, vd, scales = _kernel_operands(kr_l, vr_l)
                ctx = paged_attention(q[:, :, 0], kd, vd, pt32, seen,
                                      **scales)
                return ctx.to(q.dtype)[:, :, None]

            lp, lo = _per_layer(layers_, lora, l)
            x = _layer_math(cfg, lp, x, pos, attend, lora=lo)
        x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
        return _emit(_logits(cfg, outer, x[:, 0]), grammar), pools

    def _prefill_chunk(outer, layers_, chunk, start, pt, lengths, pools,
                       x_last, lora):
        """One C-token chunk at absolute positions start..start+C-1:
        writes its pages, attends to every pool position < start+C, and
        harvests the hidden state of each sequence's (length-1) row when
        it falls inside this chunk."""
        B, C = chunk.shape
        S = pt.shape[1] * page_size
        _tier_clear(pools, pt[:, start // page_size:
                                 (start + C) // page_size])
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
            (kp_l, vp_l), (kr_l, vr_l) = _layer_pools(pools, l)

            def attend(q, k, v):
                _write_chunk(kp_l, k, pt, start, C)
                _write_chunk(vp_l, v, pt, start, C)
                if prefill_attention == "kernel":
                    kd, vd, scales = _kernel_operands(kr_l, vr_l)
                    ctx = paged_prefill_attention(q, kd, vd, pt32, len32,
                                                  start, **scales)
                    return ctx.to(q.dtype)
                return _attend(cfg, q, _gather_pages(kr_l, pt).to(q.dtype),
                               _gather_pages(vr_l, pt).to(q.dtype), mask)

            lp, lo = _per_layer(layers_, lora, l)
            x = _layer_math(cfg, lp, x, pos_vec, attend, lora=lo)
        idx = torch.clamp(lengths - 1 - start, 0, C - 1)
        row = x[torch.arange(B, device=dev), idx]
        hit = ((lengths - 1 >= start) & (lengths - 1 < start + C))[:, None]
        return torch.where(hit, row, x_last)

    def _finish_prefill(outer, x_last, grammar):
        x = _rms(x_last, outer["model.norm.weight"], cfg.rms_norm_eps)
        return _emit(_logits(cfg, outer, x), grammar)

    @torch.no_grad()
    def prefill_chunked(outer, layers_, tokens, page_tables, lengths, pools,
                        resume_from: int = 0, lora=None, grammar=None):
        """``resume_from`` (a chunk multiple): skip chunks whose pages
        already hold real K/V (the prefix-cache path; pass the MINIMUM
        cached count across the batch, rounded down to a chunk multiple).
        The final chunk always runs so the last-position logits exist.
        ``lora`` reaches every chunk; ``grammar`` masks the logits of the
        last position."""
        C = chunked_prefill
        tokens, pt, lengths = _idx(tokens), _idx(page_tables), _idx(lengths)
        lora = _on_dev(lora)
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
                                    pt, lengths, pools, x_last, lora)
        return _finish_prefill(outer, x_last, grammar), pools

    @torch.no_grad()
    def prefill_ragged(outer, layers_, chunk, starts, page_tables, lengths,
                       pools, lora=None, grammar=None):
        """ONE call for a lane turn: row r runs the C tokens of
        ``chunk[r]`` at absolute offset ``starts[r]`` (a chunk multiple)
        against its own page table, attending causally through the page
        gather. Returns per-row greedy tokens like ``prefill``; only rows
        whose FINAL chunk this is (length-1 inside the window) carry a
        meaningful value. Rows with nothing to run point their pages at
        the reserved page 0."""
        chunk, starts = _idx(chunk), _idx(starts)
        pt, lengths = _idx(page_tables), _idx(lengths)
        lora = _on_dev(lora)
        R, C = chunk.shape
        S = pt.shape[1] * page_size
        col = (starts // page_size)[:, None] + torch.arange(
            C // page_size, device=dev)[None, :]
        _tier_clear(pools, pt.gather(1, col))
        x = outer["model.embed_tokens.weight"][chunk]
        pos = starts[:, None] + torch.arange(C, device=dev)[None, :]
        kpos = torch.arange(S, device=dev)
        mask = ((kpos[None, None, :] <= pos[:, :, None])
                & (kpos[None, None, :] < lengths[:, None, None]))[:, None]
        for l in range(L):
            (kp_l, vp_l), (kr_l, vr_l) = _layer_pools(pools, l)

            def attend(q, k, v):
                _write_chunk_ragged(kp_l, k, pt, starts, C)
                _write_chunk_ragged(vp_l, v, pt, starts, C)
                return _attend(cfg, q, _gather_pages(kr_l, pt).to(q.dtype),
                               _gather_pages(vr_l, pt).to(q.dtype), mask)

            lp, lo = _per_layer(layers_, lora, l)
            x = _layer_math(cfg, lp, x, pos, attend, lora=lo)
        idx = torch.clamp(lengths - 1 - starts, 0, C - 1)
        row = x[torch.arange(R, device=dev), idx]
        hit = ((lengths - 1 >= starts) & (lengths - 1 < starts + C))[:, None]
        x_last = torch.where(hit, row, torch.zeros_like(row))
        return _finish_prefill(outer, x_last, grammar), pools

    if chunked_prefill is not None:
        prefill = prefill_chunked  # noqa: F811
        if prefill_attention != "kernel":
            prefill_chunked._ragged = prefill_ragged

    @torch.no_grad()
    def decode_n(outer, layers_, tok, page_tables, lengths, pools, n,
                 lora=None, grammar=None):
        """n decode steps as a Python loop over decode_step. Returns
        (emits (n, B, ...), next_tok (B,), pools); the caller's length
        bookkeeping is lengths + n. With emit="logits" the fed-back token
        is the greedy argmax. ``grammar`` holds each row's dispatch-time
        state for all n steps (the engine decodes constrained rows one
        step a call)."""
        tok = _idx(tok).to(torch.int32)
        lens = _idx(lengths)
        lora, grammar = _on_dev(lora), _on_dev(grammar)
        emits = []
        for _ in range(n):
            nxt, pools = decode_step(outer, layers_, tok, page_tables, lens,
                                     pools, lora, grammar)
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
    per-token decode steps over DENSE KV caches (L, B, nkv, C, hd),
    updated in place. ``device`` (``cuda`` unless ``"cpu"`` is asked
    for) holds the weights and caches.

    With ``config.sliding_window`` < max_len the cache is a ROLLING
    buffer of C = window slots (position p writes slot p % window): the
    prefill attends banded over the prompt's own K/V and keeps its last
    window positions, memory stays O(window) and the generation length is
    not bounded by the cache. Otherwise C = max_len.

    ``kv_cache_dtype="int8"`` stores the cache quantized (per-slot absmax
    over head_dim, ``_q8``); each step's own keys attend exactly, the
    stored past dequantized.

    ``weight_dtype="int8"`` quantizes the projection weights and the
    untied lm head per output channel (``quantization.int8``): the
    matmuls quantize their activations per tensor and run int8 x int8 ->
    int32. Tied embeddings stay in the model's dtype.

    ``generate.compiled(tokens, max_new_tokens)`` is the reference's
    one-program greedy variant; eagerly it is the same loop at
    temperature 0, returned as a numpy array as the reference returns
    it. ``sample`` draws from an explicit ``torch.Generator``, so sampled
    tokens cannot match the reference's JAX keys; greedy tokens do.
    ``generate._parts`` holds what the serving engine reads: ``outer``,
    ``layers``, ``prefill``, ``decode_step``, ``init_caches``,
    ``compiled_greedy``, ``rolling`` (a rolling ``prefill`` takes no
    caches and returns new ones, as the reference's does).

    ``scan_layers`` has no meaning here (the layers are a Python loop).
    """
    dev = resolve_device(device)
    cfg = model.config
    _check_dense(kv_cache_dtype, weight_dtype)
    outer, layers = _split_for(model, dev, "llama_decode_factory")
    if weight_dtype == "int8":
        layers = _quantize_weights(layers, _PROJ_KEYS)
        outer = _quantize_weights(outer, ("lm_head.weight",))
    return _dense_from(cfg, outer, layers, dev, max_len, kv_cache_dtype)


def _check_dense(kv_cache_dtype, weight_dtype):
    if weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype {weight_dtype!r}: use None or "
                         "'int8'")
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: use None "
                         "(model dtype) or 'int8'")


def _dense_from(cfg, outer, layers, dev, max_len, kv_cache_dtype):
    """The dense factory's programs over split parameters already on
    ``dev`` (the serving factory shares one copy with the paged
    backend)."""
    L = cfg.num_hidden_layers
    nkv = cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    quantized = kv_cache_dtype == "int8"
    embed = outer["model.embed_tokens.weight"]
    window = getattr(cfg, "sliding_window", None)
    rolling = window is not None and window < max_len
    C = window if rolling else max_len          # cache slots

    def init_caches(B, dtype):
        shape = (L, B, nkv, C, hd)
        if quantized:
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.ones(shape[:-1], dtype=torch.float32,
                               device=dev))
        return torch.zeros(shape, dtype=dtype, device=dev)

    def _layer_cache(caches, l):
        if isinstance(caches, tuple):
            return caches[0][l], caches[1][l]
        return caches[l]

    def _run(outer, layers_, x, pos_vec, key_mask, write_at, kc, vc,
             n=None):
        for l in range(L):
            x = _layer_step(cfg, _at(layers_, l), x,
                            _layer_cache(kc, l), _layer_cache(vc, l),
                            pos_vec, key_mask, write_at, n)
        return _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)

    def _band(S0):
        causal = torch.tril(torch.ones((S0, S0), dtype=torch.bool,
                                       device=dev))
        if window is not None:
            i = torch.arange(S0, device=dev)
            causal &= (i[:, None] - i[None, :]) < window
        return causal

    if rolling:
        @torch.no_grad()
        def prefill(outer, layers_, tokens):
            """tokens (B, S0) -> (last-position logits (B, V), caches):
            the rolling prefill produces the caches."""
            tokens = torch.as_tensor(tokens, device=dev).long()
            B, S0 = tokens.shape
            kc = init_caches(B, embed.dtype)
            vc = init_caches(B, embed.dtype)
            x = outer["model.embed_tokens.weight"][tokens]
            pos_vec = torch.arange(S0, device=dev)
            band = _band(S0)
            for l in range(L):
                x = _layer_step_rolling_prefill(
                    cfg, _at(layers_, l), x, pos_vec, band, C,
                    _layer_cache(kc, l), _layer_cache(vc, l))
            x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
            return _logits(cfg, outer, x[:, -1]), kc, vc
    else:
        @torch.no_grad()
        def prefill(outer, layers_, tokens, k_caches, v_caches):
            """tokens (B, S0) -> (last-position logits (B, V), caches)."""
            tokens = torch.as_tensor(tokens, device=dev).long()
            S0 = tokens.shape[1]
            x = _run(outer, layers_,
                     outer["model.embed_tokens.weight"][tokens],
                     torch.arange(S0, device=dev), _band(S0), 0, k_caches,
                     v_caches)
            return _logits(cfg, outer, x[:, -1]), k_caches, v_caches

    @torch.no_grad()
    def decode_step(outer, layers_, token, pos, k_caches, v_caches):
        """token (B,); ``pos``: the absolute position of ``token``, a
        Python int (a slice bound on the host: no read from the card).
        A rolling cache writes slot pos % C and attends its live slots
        (every one once pos >= C: the buffer holds only the last C
        keys)."""
        pos = int(pos)
        token = torch.as_tensor(token, device=dev).long()
        x = outer["model.embed_tokens.weight"][token][:, None]
        n = min(pos + 1, C) if rolling else pos + 1
        key_mask = torch.ones((1, n), dtype=torch.bool, device=dev)
        x = _run(outer, layers_, x, torch.full((1,), pos, device=dev),
                 key_mask, pos % C if rolling else pos, k_caches,
                 v_caches, n)
        return _logits(cfg, outer, x[:, 0]), k_caches, v_caches

    def _start(outer_, layers_, tokens):
        """The prefill with its caches: (logits, k caches, v caches)."""
        if rolling:
            return prefill(outer_, layers_, tokens)
        B = tokens.shape[0]
        return prefill(outer_, layers_, tokens, init_caches(B, embed.dtype),
                       init_caches(B, embed.dtype))

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
        if not rolling and S0 + max_new_tokens > max_len:
            # past max_len the cache writes would corrupt generations
            # (the rolling cache wraps by design)
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
        logits, kc, vc = _start(outer, layers, tokens)
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
        S0 = tokens.shape[1]
        logits, kc, vc = _start(outer_, layers_, tokens)
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
                       "rolling": rolling}
    return generate


def llama_speculative_decode_factory(target: LlamaForCausalLM,
                                     draft: LlamaForCausalLM,
                                     max_len: int = 256, n_draft: int = 4,
                                     device=None):
    """Greedy speculative decoding over DENSE caches: the draft model
    proposes ``n_draft`` tokens (its walk a loop of one-token blocks that
    feed each argmax back on the card), the target verifies them in ONE
    (k+1)-position block; the matching prefix and the target's
    correction (or bonus) token advance the sequence, and K/V written
    for rejected proposals lies beyond the advanced position, where no
    key mask reaches, until later blocks overwrite it. On a fully
    accepted round the draft has not consumed its last proposal; the
    next round feeds it. Greedy acceptance makes the output EXACTLY the
    target's greedy generation.

    Both models must share a vocabulary; batch 1 a call; no
    ``sliding_window`` (rolling slots break the overwrite rollback).
    ``device``: ``cuda`` unless ``"cpu"`` is asked for.

    ``generate(tokens (1, S0), max_new_tokens)`` is the reference's host
    loop (``last_stats``: ``rounds``, ``tokens``, ``target_steps``);
    ``generate.compiled`` is its one-program variant (every round drafts
    ``n_draft``, the draft consuming a two-token feed), eagerly: the
    round's accepted count and candidates are read from the card once a
    round, and nothing else is (``last_stats`` adds ``accept_rate``).
    Both return a numpy array and the target's greedy tokens.
    ``scan_layers`` has no meaning here (the layers are Python loops)."""
    if target.config.vocab_size != draft.config.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    if n_draft < 1:
        raise ValueError("n_draft must be >= 1 (0 would still emit one "
                         "unverified draft per round and desync the draft "
                         "cache)")
    if getattr(target.config, "sliding_window", None) or \
            getattr(draft.config, "sliding_window", None):
        raise ValueError("speculative decoding with sliding_window is "
                         "not supported (rolling slots break the "
                         "overwrite-rollback invariant)")
    dev = resolve_device(device)

    def build(model):
        cfg = model.config
        outer, layers = _split_for(model, dev,
                                   "llama_speculative_decode_factory")
        L = cfg.num_hidden_layers
        nkv = cfg.num_key_value_heads
        hd = cfg.hidden_size // cfg.num_attention_heads
        dtype = outer["model.embed_tokens.weight"].dtype

        def init(B):
            shape = (L, B, nkv, max_len, hd)
            return (torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))

        @torch.no_grad()
        def block(tokens, caches, pos0: int):
            """tokens (B, T) at absolute positions pos0..pos0+T-1 (a
            host int): writes their K/V at the same slots, returns the
            logits of EVERY position (B, T, V)."""
            kc, vc = caches
            T = tokens.shape[1]
            x = outer["model.embed_tokens.weight"][tokens]
            pos_vec = pos0 + torch.arange(T, device=dev)
            key_mask = torch.arange(pos0 + T, device=dev)[None, :] \
                <= pos_vec[:, None]
            for l in range(L):
                x = _layer_step(cfg, _at(layers, l), x, kc[l], vc[l],
                                pos_vec, key_mask, pos0)
            x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
            return _logits(cfg, outer, x)

        return outer, layers, init, block

    outerT, layersT, initT, blockT = build(target)
    outerD, layersD, initD, blockD = build(draft)

    def _ids(rows):
        return torch.as_tensor(rows, dtype=torch.long, device=dev)

    def draft_round(feed, cachesD, k, pos0):
        """Consume ``feed`` (1, T0) at pos0.., then draft ``k`` greedy
        tokens, each fed back on the card: (1, k) drafts, not read."""
        cur = torch.argmax(blockD(feed, cachesD, pos0)[:, -1], -1)
        drafts = [cur]
        for i in range(k - 1):
            cur = torch.argmax(blockD(cur[:, None], cachesD,
                                      pos0 + feed.shape[1] + i)[:, -1], -1)
            drafts.append(cur)
        return torch.stack(drafts, 1)

    def _prompt(tokens, max_new_tokens, window):
        tokens = torch.as_tensor(tokens, device=dev).long()
        B, S0 = tokens.shape
        if B != 1:
            raise ValueError("speculative generate supports batch 1")
        if S0 + max_new_tokens + window > max_len:
            raise ValueError(
                f"prompt {S0} + max_new {max_new_tokens} + draft window "
                f"{window} exceeds max_len {max_len}")
        return tokens, S0

    def generate(tokens, max_new_tokens: int):
        tokens, S0 = _prompt(tokens, max_new_tokens, n_draft + 1)
        cT, cD = initT(1), initD(1)
        logitsT = blockT(tokens, cT, 0)
        seq = tokens[0].tolist()
        last = int(torch.argmax(logitsT[0, -1], -1))
        seq.append(last)
        produced = 1
        pos = S0          # ``last`` occupies sequence position pos
        pending = seq[S0:]  # tokens the draft has not consumed yet
        draft_round(tokens, cD, 1, 0)  # the prompt; 1 throwaway draft
        rounds = 0
        while produced < max_new_tokens:
            k = min(n_draft, max_new_tokens - produced)
            drafts = draft_round(_ids([pending]), cD, k,
                                 pos - len(pending) + 1)
            # ONE target block verifies [last, d0..d_{k-1}]
            blk = torch.cat([_ids([[last]]), drafts], 1)
            t = torch.argmax(blockT(blk, cT, pos)[0], -1)
            both = torch.cat([drafts[0], t]).tolist()
            drafts, t = both[:k], both[k:]
            n = 0
            while n < k and drafts[n] == t[n]:
                n += 1
            seq.extend(drafts[:n] + [t[n]])  # accepted + correction
            produced += n + 1
            pos += n + 1
            last = t[n]
            # the draft consumed [pending, d0..d_{k-2}]: feed it what of
            # the accepted sequence it has not seen, plus the new last
            pending = ([drafts[k - 1]] if n == k else []) + [last]
            rounds += 1
        generate.last_stats = {"rounds": rounds,
                               "tokens": min(produced, max_new_tokens),
                               "target_steps": 1 + rounds}
        return np.asarray(seq[:S0 + max_new_tokens], np.int32)[None, :]

    def generate_compiled(tokens, max_new_tokens: int):
        """The one-program variant: the same greedy-exact output."""
        k = n_draft
        tokens, S0 = _prompt(tokens, max_new_tokens, 2 * (k + 1))
        cT, cD = initT(1), initD(1)
        last = torch.argmax(blockT(tokens, cT, 0)[:, -1], -1)   # (1,)
        blockD(tokens, cD, 0)
        seq = tokens[0].tolist() + [0] * (max_len - S0)
        seq[S0] = int(last)
        produced, rounds, pos = 1, 0, S0
        idx = torch.arange(k + 1, device=dev)
        while produced < max_new_tokens:
            drafts = draft_round(_ids([seq[pos - 1:pos + 1]]), cD, k,
                                 pos - 1)[0]                   # (k,)
            blk = torch.cat([_ids([seq[pos]]), drafts])[None]
            t = torch.argmax(blockT(blk, cT, pos)[0], -1)      # (k+1,)
            n = torch.cumprod((drafts == t[:k]).long(), 0).sum()
            dpad = torch.cat([drafts, drafts.new_zeros(1)])
            cand = torch.where(idx < n, dpad, t)
            # the round's one read from the card
            got = torch.cat([n[None], cand]).tolist()
            n, cand = got[0], got[1:]
            seq[pos + 1:pos + 2 + k] = cand
            produced += n + 1
            rounds += 1
            pos += n + 1
        generate_compiled.last_stats = {
            "rounds": rounds,
            "tokens": min(produced, max_new_tokens),
            "target_steps": 1 + rounds,
            "accept_rate": round(
                (produced - 1 - rounds) / max(1, rounds * n_draft), 4)}
        return np.asarray(seq[:S0 + max_new_tokens], np.int32)[None, :]

    generate.last_stats = {}
    generate_compiled.last_stats = {}
    generate.compiled = generate_compiled
    generate._parts = {"target": (outerT, layersT),
                       "draft": (outerD, layersD)}
    return generate


# --- host configs the serving engine reads ---------------------------------

@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Multi-adapter LoRA layout for the paged serving decode path: a
    device bank of ``n_slots`` stacked low-rank delta sets over the q/v
    projections, applied per batch row by slot index. Slot 0 is the
    reserved identity (``lora_bank_hooks`` builds the bank)."""

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


def lora_bank_hooks(cfg, lora: LoRAConfig, dtype, device=None):
    """The adapter cache's device hooks: ``(init_adapter_bank,
    upload_adapter)``.

    ``init_adapter_bank()`` builds the all-zero bank on ``device``: per
    LoRA key a ``(L, n_slots, ...)`` tensor, stacked layer-first like the
    layer weights; slot 0 stays zero (the identity every
    ``adapter=None`` row decodes through).

    ``upload_adapter(bank, slot, deltas)`` writes one
    ``synthesize_lora_deltas``-shaped host delta set (``q_A`` / ``v_A``
    (L, H, r), ``q_B`` / ``v_B`` (L, r, out)) into ``slot`` IN PLACE and
    returns the same bank (the reference returns a functional update;
    the engine rebinds whatever comes back). Every key's shape is
    checked before anything is written."""
    L = cfg.num_hidden_layers
    H = cfg.hidden_size
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = H // nh
    r, ns = lora.rank, lora.n_slots
    dev = resolve_device(device)
    shapes = {"q_A": (L, ns, H, r), "q_B": (L, ns, r, nh * hd),
              "v_A": (L, ns, H, r), "v_B": (L, ns, r, nkv * hd)}

    def init_adapter_bank():
        return {k: torch.zeros(s, dtype=dtype, device=dev)
                for k, s in shapes.items()}

    def upload_adapter(bank, slot, deltas):
        for k in LORA_KEYS:
            if k not in deltas:
                raise ValueError(f"adapter delta set missing {k!r} "
                                 f"(needs {LORA_KEYS})")
            want = shapes[k][:1] + shapes[k][2:]
            got = tuple(np.asarray(deltas[k]).shape)
            if got != want:
                raise ValueError(f"adapter delta {k} has shape {got}, "
                                 f"bank slot wants {want} (rank/model "
                                 "mismatch?)")
        for k in LORA_KEYS:
            bank[k][:, slot].copy_(torch.as_tensor(
                np.asarray(deltas[k], np.float32)).to(bank[k].dtype))
        return bank

    return init_adapter_bank, upload_adapter


@dataclasses.dataclass(frozen=True)
class GrammarConfig:
    """Constrained-decoding layout: a bank of ``n_slots * max_states``
    packed allow-bitmask rows, indexed per row by ``slot * max_states +
    state``; slot 0 is the all-allow identity (``grammar_bank_hooks``
    builds the bank)."""

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


def grammar_bank_hooks(vocab_size: int, grammar: GrammarConfig,
                       device=None):
    """The grammar cache's device hooks: ``(init_grammar_bank,
    upload_grammar)``.

    ``init_grammar_bank()`` builds the ``(n_slots * max_states,
    ceil(vocab / 32))`` bank on ``device`` with slot 0's whole block all
    ones (the all-allow identity every free row indexes at flat id 0).
    The words are the reference's uint32 masks stored as int32 (the same
    bits; PyTorch has no uint32 arithmetic on every device), which
    ``_gmask`` unpacks by shift and ``& 1``.

    ``upload_grammar(bank, slot, compiled)`` writes one compiled
    automaton's packed per-state masks (``n_states``, ``masks``) into the
    slot's block IN PLACE, zeroing the block's unused tail so a recycled
    slot never leaks a larger predecessor's rows, and returns the same
    bank."""
    words = (int(vocab_size) + 31) // 32
    ms, ns = grammar.max_states, grammar.n_slots
    dev = resolve_device(device)

    def init_grammar_bank():
        bank = np.zeros((ns * ms, words), np.uint32)
        bank[:ms] = np.uint32(0xFFFFFFFF)
        return torch.from_numpy(bank.view(np.int32)).to(dev)

    def upload_grammar(bank, slot, compiled):
        n = int(compiled.n_states)
        if n > ms:
            raise ValueError(f"grammar compiles to {n} states > "
                             f"max_states {ms}")
        masks = np.asarray(compiled.masks, np.uint32)
        if masks.shape != (n, words):
            raise ValueError(f"grammar masks have shape {masks.shape},"
                             f" bank rows want (*, {words}) (vocab "
                             "mismatch?)")
        block = np.zeros((ms, words), np.uint32)
        block[:n] = masks
        bank[slot * ms:(slot + 1) * ms] = torch.from_numpy(
            block.view(np.int32)).to(bank.device)
        return bank

    return init_grammar_bank, upload_grammar


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Adaptive speculative-decode policy for the serving engine: a
    draft window of ``n_draft`` tokens verified in one target block,
    eligibility by priority and deadline, an acceptance floor on an
    EWMA, and an overload fallback. Greedy acceptance keeps every
    emitted token the target's greedy token (``build_spec_step`` is the
    round)."""

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


def build_spec_step(cfg_t, cfg_d, page_size: int):
    """ONE speculative round over the paged pools, batched across decode
    slots: the draft consumes ``[prev, tok]`` at (len-1, len) (two
    positions: re-consuming len-1 rewrites identical K/V and leaves the
    draft cache no hole after a fully accepted round), then walks
    ``k-1`` more greedy steps, one block call each; the target verifies
    ``[tok, d_0 .. d_{k-1}]`` in ONE (k+1)-position block through its
    pool. Every block writes its K/V at per-row positions
    (``_write_positions``) and attends the whole table through the page
    gather. Rows that are not live ride along with all-zero tables and
    length 0, writing into the reserved page 0.

    Acceptance is the reference's branch-free arithmetic: ``n`` is the
    length of the matching draft prefix (``cumprod`` of the matches),
    ``cand`` holds the accepted drafts, then the target's correction or
    bonus token; K/V written for rejected proposals lies beyond the
    advanced length, where no key mask reaches, and later rounds
    overwrite it.

    Returns ``spec_step(outer_t, layers_t, outer_d, layers_d, prev_tok,
    tok, page_tables, lengths, pools_t, pools_d, k) -> (accepted (B,),
    cand (B, k+1), pools_t, pools_d)``, both int32, with ``k`` a Python
    int and the pools updated in place."""

    def make_block(cfg):
        L = cfg.num_hidden_layers

        def block(outer, layers, tokens, pos, page_tables, pools):
            """tokens (B, T) at per-row absolute positions ``pos``
            (B, T): write K/V at those slots, attend causally over the
            whole table, return last-norm logits (B, T, V)."""
            S = page_tables.shape[1] * page_size
            x = outer["model.embed_tokens.weight"][tokens.long()]
            key_ok = torch.arange(S, device=pos.device)[None, None, :] \
                <= pos[:, :, None]
            mask = key_ok[:, None]
            for l in range(L):
                kp_l, vp_l = _pool_layer(pools, l)

                def attend(q, k, v):
                    _write_positions(kp_l, k, page_tables, pos, page_size)
                    _write_positions(vp_l, v, page_tables, pos, page_size)
                    return _attend(cfg, q,
                                   _gather_pages(kp_l, page_tables)
                                   .to(q.dtype),
                                   _gather_pages(vp_l, page_tables)
                                   .to(q.dtype), mask)

                x = _layer_math(cfg, _at(layers, l), x, pos, attend)
            x = _rms(x, outer["model.norm.weight"], cfg.rms_norm_eps)
            return _logits(cfg, outer, x)

        return block

    block_t = make_block(cfg_t)
    block_d = make_block(cfg_d)

    @torch.no_grad()
    def spec_step(outer_t, layers_t, outer_d, layers_d, prev_tok, tok,
                  page_tables, lengths, pools_t, pools_d, k):
        dev = outer_t["model.embed_tokens.weight"].device
        prev_tok = torch.as_tensor(prev_tok, device=dev).long()
        tok = torch.as_tensor(tok, device=dev).long()
        pt = torch.as_tensor(page_tables, device=dev).long()
        lens = torch.as_tensor(lengths, device=dev).long()
        B = tok.shape[0]
        # draft: consume [prev, tok] at (len-1, len), emit d_0, then walk
        # k-1 more steps
        feed = torch.stack([prev_tok, tok], 1)
        pos0 = lens[:, None] + torch.tensor([-1, 0], device=dev)[None, :]
        cur = torch.argmax(block_d(outer_d, layers_d, feed, pos0, pt,
                                   pools_d)[:, -1], -1)
        drafts = [cur]
        for i in range(k - 1):
            cur = torch.argmax(block_d(outer_d, layers_d, cur[:, None],
                                       lens[:, None] + 1 + i, pt,
                                       pools_d)[:, -1], -1)
            drafts.append(cur)
        drafts = torch.stack(drafts, 1)                     # (B, k)
        # target verifies [tok, d_0..d_{k-1}] in ONE (k+1)-position block
        blk = torch.cat([tok[:, None], drafts], 1)
        pos_t = lens[:, None] + torch.arange(k + 1, device=dev)[None, :]
        t = torch.argmax(block_t(outer_t, layers_t, blk, pos_t, pt,
                                 pools_t), -1)             # (B, k+1)
        matches = (drafts == t[:, :k]).to(torch.int32)
        n = torch.cumprod(matches, 1).sum(1)
        idx = torch.arange(k + 1, device=dev)[None, :]
        dpad = torch.cat([drafts, torch.zeros((B, 1), dtype=drafts.dtype,
                                              device=dev)], 1)
        cand = torch.where(idx < n[:, None], dpad, t)
        return (n.to(torch.int32), cand.to(torch.int32), pools_t,
                pools_d)

    return spec_step


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
    Runs on the chain's own device (a bf16 chain has no numpy dtype)."""
    n_to = -(-n_tokens // page_size_to)

    def one(a):
        a = torch.as_tensor(a)
        L, H, n, ps = a.shape[:4]
        tail = tuple(a.shape[4:])
        if n * ps < n_tokens:
            raise ValueError(
                f"repage: chain carries {n}x{ps} slots but claims "
                f"{n_tokens} tokens")
        flat = a.reshape(L, H, n * ps, *tail)[:, :, :n_tokens]
        pad = n_to * page_size_to - n_tokens
        if pad:
            fill = torch.ones if len(tail) == 0 else torch.zeros
            flat = torch.cat(
                [flat, fill((L, H, pad) + tail, dtype=a.dtype,
                            device=a.device)], dim=2)
        return flat.reshape(L, H, n_to, page_size_to, *tail)

    return _tree_map(one, data)


@torch.no_grad()
def compact_kv_pages(pools, mask):
    """Quantize the masked pages of a PRESSURE pool IN PLACE: per-slot
    absmax int8 (``_q8``, as the reference's jitted program computes it)
    written into the int8 arena, tier bits set; returns the same pools.
    Only the masked pages are quantized, one layer at a time (the
    reference quantizes the whole pool and keeps the masked pages: the
    same bits, without a whole-pool f32 temporary).
    The fp slots of a compacted page stay in place but dead: reads go
    through the tier bits, and a write clears its page's bit first."""
    (kf, kq, ks), (vf, vq, vs), tier = pools
    mask = torch.as_tensor(mask, device=tier.device).bool()
    ids = mask.nonzero()[:, 0]
    if ids.numel():
        for fp, qd, sc in ((kf, kq, ks), (vf, vq, vs)):
            for l in range(fp.shape[0]):
                q, s = _q8(fp[l].index_select(1, ids), folded=True)
                qd[l].index_copy_(1, ids, q)
                sc[l].index_copy_(1, ids, s)
    tier |= mask
    return pools


def _page_ids(page_ids, device):
    return torch.as_tensor(list(page_ids), dtype=torch.long, device=device)


def export_quant_pages(pools, page_ids):
    """Slice a PRESSURE pool's pages for a handoff: both arenas AND the
    per-page tier bits travel, so a mixed-tier chain lands exactly on
    import (the engine's default page-axis export cannot carry the 1-D
    tier leaf; this is the factory hook it looks for)."""
    (kf, kq, ks), (vf, vq, vs), tier = pools
    idx = _page_ids(page_ids, tier.device)

    def sl(a):
        return a.index_select(2, idx)

    return ((sl(kf), sl(kq), sl(ks)), (sl(vf), sl(vq), sl(vs)),
            tier.index_select(0, idx))


@torch.no_grad()
def import_quant_pages(pools, page_ids, data):
    """Scatter an exported mixed-tier chain into a PRESSURE pool at
    ``page_ids`` (the importer's freshly allocated pages), IN PLACE;
    returns the same pools. ``data`` may lie on another device (a host
    arena's pinned copy)."""
    (kf, kq, ks), (vf, vq, vs), tier = pools
    (kfd, kqd, ksd), (vfd, vqd, vsd), td = data
    idx = _page_ids(page_ids, tier.device)
    for a, d in ((kf, kfd), (kq, kqd), (ks, ksd), (vf, vfd), (vq, vqd),
                 (vs, vsd)):
        a.index_copy_(2, idx, torch.as_tensor(d).to(a.device, a.dtype))
    tier.index_copy_(0, idx, torch.as_tensor(td).to(tier.device,
                                                     torch.bool))
    return pools


def transcode_kv_data(data, quant_from, quant_to):
    """Transcode an exported full-precision chain ``(k, v)`` into the
    destination codec with the same ``_q8`` the destination's write path
    uses: ``'int8'`` gives ``((k_int8, k_scale), (v_int8, v_scale))``;
    ``'pressure'`` gives both arenas and an all-set tier mask (the chain
    lands parked in the int8 tier, the fp arena keeping the exact source
    values). Quantized sources do not transcode."""
    if quant_from is not None:
        raise ValueError(
            f"transcode: source codec {quant_from!r} is not "
            "transcodable (only full-precision chains re-encode)")
    k, v = (torch.as_tensor(x) for x in data)
    if quant_to == "int8":
        return _q8(k), _q8(v)
    if quant_to == "pressure":
        kq, ks = _q8(k)
        vq, vs = _q8(v)
        tier = torch.ones((k.shape[2],), dtype=torch.bool, device=k.device)
        return (k, kq, ks), (v, vq, vs), tier
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


_PRESSURE_DENSE_REASON = (
    "a kv_quant='pressure' serving factory is paged-only: the "
    "degradation tier compacts PAGES parked in the pool's evictable "
    "LRU, and the dense wave cache has neither pages nor an LRU — "
    "route with policy='paged'")


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
    paged kernel), which also gives the engine the fused ragged lane
    (``prefill_ragged``). ``device``: ``cuda`` unless ``"cpu"`` is asked
    for.

    ``lora`` (``LoRAConfig`` / ``(n_slots, rank)``): the adapter bank's
    hooks ``init_adapter_bank`` / ``upload_adapter`` (``lora_bank_hooks``,
    in the weights' dtype). ``grammar`` (``GrammarConfig`` /
    ``(n_slots, max_states)``): the mask bank's hooks
    ``init_grammar_bank`` / ``upload_grammar``. ``draft`` (a smaller
    model on the same vocabulary): speculative serving, ``spec_parts =
    (draft outer, draft layers, draft pools, draft chunked prefill,
    spec_step)``. The draft gets its own paged programs and pools over the
    same page geometry, indexed by the target's page ids, its parameters
    split once; it shares no tensor with the target.

    ``kv_quant="pressure"``: the paged backend's two-tier pool; the
    factory is paged-only (``dense`` is a ``PagedOnlyDense`` stub and
    ``pick`` always returns the paged backend) and carries the hooks
    ``compact_pages`` / ``export_kv_pages`` / ``import_kv_pages`` the
    engine drives (``compact_kv_pages``, ``export_quant_pages``,
    ``import_quant_pages``).

    Not ported yet, refused by name: ``tp`` (ROADMAP item 11, option 6).
    ``scan_layers`` has no meaning here.
    """
    tp = as_tp_config(tp)
    lora = as_lora_config(lora)
    grammar = as_grammar_config(grammar)
    if kv_quant not in (None, "int8", "pressure"):
        raise ValueError(f"kv_quant {kv_quant!r}: use None, 'int8' or "
                         "'pressure'")
    if tp is not None:
        raise _not_ported("llama_serving_decode_factory(tp=...)", 11)
    if kv_quant == "int8":
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError("kv_quant='int8' IS kv_cache_dtype="
                             f"'int8' — {kv_cache_dtype!r} conflicts")
        kv_cache_dtype = "int8"
    if kv_quant == "pressure":
        if kv_cache_dtype is not None:
            raise ValueError("kv_quant='pressure' owns the pool codec "
                             "— drop kv_cache_dtype")
        if draft is not None:
            raise ValueError(
                "kv_quant='pressure' does not compose with draft= "
                "yet: the draft pool rides the target's page ids but "
                "has no tier mask, so a compacted target page would "
                "desync draft K/V — use kv_quant='int8'")
    if draft is not None:
        if lora is not None:
            raise ValueError(
                "speculative serving does not compose with lora= yet "
                "— the draft has no adapter bank, so a per-row delta "
                "would desync draft proposals from the verified "
                "target (run spec engines single-model)")
        if draft.config.vocab_size != model.config.vocab_size:
            raise ValueError("target and draft must share a "
                             "vocabulary")
    dev = resolve_device(device)
    cfg = model.config
    _check_dense(kv_cache_dtype, None)
    outer, layers = _split_for(model, dev, "llama_serving_decode_factory")
    w_dtype = layers["self_attn.q_proj.weight"].dtype
    if kv_quant == "pressure":
        # paged-only: the dense wave cache has no pages to tier
        gen = PagedOnlyDense(_PRESSURE_DENSE_REASON)
    else:
        gen = _dense_from(cfg, outer, layers, dev, max_len, kv_cache_dtype)
    paged = _paged_from(cfg, outer, layers, dev, page_size, n_pool_pages,
                        chunked_prefill, kv_cache_dtype, "token", "gather",
                        kv_quant, lora.scale if lora is not None else 1.0)
    lora_hooks = (lora_bank_hooks(cfg, lora, w_dtype, dev)
                  if lora is not None else None)
    grammar_hooks = (grammar_bank_hooks(cfg.vocab_size, grammar, dev)
                     if grammar is not None else None)
    spec_built = None
    if draft is not None:
        # the draft's own paged programs over the SAME page geometry:
        # its pool is indexed by the target's page ids, so one
        # PagedKVCache chain per request covers both pools
        d_outer, d_layers = _split_for(draft, dev,
                                       "llama_serving_decode_factory")
        d_outer, d_layers, d_pools, d_prefill, _, _ = _paged_from(
            draft.config, d_outer, d_layers, dev, page_size, n_pool_pages,
            chunked_prefill, None, "token", "gather", None)
        spec_built = (d_outer, d_layers, d_pools, d_prefill,
                      build_spec_step(cfg, draft.config, page_size))

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
        lora_ = lora
        grammar_ = grammar
        grammar_vocab_ = cfg.vocab_size
        kv_quant_ = kv_quant
        page_bytes_ = (kv_quant_page_bytes(cfg, page_size, w_dtype)
                       if kv_quant is not None else None)
        if kv_quant == "pressure":
            compact_pages = staticmethod(compact_kv_pages)
            export_kv_pages = staticmethod(export_quant_pages)
            import_kv_pages = staticmethod(import_quant_pages)
        # a tuple, not a callable, so the attribute never binds
        spec_parts = spec_built
        if getattr(paged[3], "_ragged", None) is not None:
            # the fused lane's one call a turn; absent when prefill
            # attends through the kernel (no mixing of numerics)
            prefill_ragged = staticmethod(paged[3]._ragged)
        if lora_hooks is not None:
            init_adapter_bank = staticmethod(lora_hooks[0])
            upload_adapter = staticmethod(lora_hooks[1])
        if grammar_hooks is not None:
            init_grammar_bank = staticmethod(grammar_hooks[0])
            upload_grammar = staticmethod(grammar_hooks[1])

        def pick(self, lengths, capacity=None, shared_prefix=False,
                 expect_churn=False):
            if self.kv_quant_ == "pressure":
                return "paged", paged   # no dense backend exists
            # the live attribute, so a caller who adjusts capacity sees
            # routing follow
            cap = capacity if capacity is not None else self.capacity
            backend = route_decode(lengths, cap, shared_prefix,
                                   expect_churn)
            return backend, (gen if backend == "dense" else paged)

    return _Serving()
