"""Paged KV-cache attention for the PyTorch port, and the host page
bookkeeper of the serving loop.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``. The TPU
kernel ``_paged_kernel`` becomes ``kernels/paged_attention.cu``, a CUDA
kernel written for Hopper and bound with ``ctypes``. Both entry points,
``paged_attention`` (decode) and ``paged_prefill_attention`` (a chunk of
prefill), reach it through ``_paged_call``:

* a CUDA tensor launches the kernel, or raises;
* a CPU tensor runs ``_paged_plain``, the plain PyTorch version of the
  same function (the tests' path). Nothing else selects the plain version.

``paged_attention.launches`` counts the wrapper's launches from both entry
points, so a run can show that it went through the kernel. The kernel has
three instances, chosen on shapes alone by the kernel's own route
(``paged_attention_instance`` in the ``.cu``, which ``_instance`` asks):

* ``split``, decode (chunk 1, at most ``_DECODE_MAX_GROUP`` rows a kv
  head): the keys of each (sequence, kv head) are split as
  ``_decode_splits`` plans from shapes alone, and the last split to finish
  merges the others' partials;
* ``mma``, a prefill chunk in bf16 over bf16 or int8 pools, head_dim 64,
  128 or 256, pages of a multiple of 64 slots or of a divisor of 64 of at
  least 8: ``wgmma`` on the tensor cores, 64 query rows a CTA against
  64-key tiles of the pages that TMA brings, p split into two bf16 parts
  for P.V;
* ``rows``, everything else (float32 q or pools, other page sizes,
  decode at more than ``_DECODE_MAX_GROUP`` rows a kv head): one block a
  row tile, on the CUDA cores.

Every call runs one CUDA kernel and counts one launch, also in
``paged_attention.instance_launches`` under the instance that the kernel's
entry reports it launched, and in ``paged_attention.int8_launches`` when
its pools are int8. No call reads a length on the host, so none
synchronises.

API (the reference's layouts):
  paged_attention(q, k_pages, v_pages, page_tables, seq_lens)
    q           (B, Hq, D)            one decode position per sequence
    k/v_pages   (Hkv, P, page_size, D) page pools (f32, bf16, or int8 with
                                      k/v_scales (Hkv, P, page_size) f32)
    page_tables (B, pages_per_seq)    int32 page ids
    seq_lens    (B,)                  real lengths -> (B, Hq, D)
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.place import resolve_device
from ..obs import ledger as obs_ledger
from .kernels import _build

NEG_INF = -1e30
_KERNEL = "paged_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128, 256)


def _decode_starts(seq_lens):
    return (seq_lens.to(torch.int32) - 1).clamp_min(0)


def _paged_plain(q4, k_pages, v_pages, page_tables, seq_lens, starts, chunk,
                 sm_scale, k_scales=None, v_scales=None):
    """The plain PyTorch version of the kernel: gather every page of the
    table, mask, exact softmax in f32. q4 (B, Hkv, R, D), row r at
    absolute position starts[b] + r % chunk (decode: starts None, each
    row at seq_lens[b] - 1). A row with no live key is exactly 0, as in
    the kernel."""
    B, Hkv, R, D = q4.shape
    if starts is None:
        starts = _decode_starts(seq_lens)
    page_size = k_pages.shape[2]
    pt = page_tables.long()
    S = pt.shape[1] * page_size

    def gather(pool, scales):
        g = pool[:, pt].to(torch.float32)         # (Hkv, B, W, ps, D)
        if scales is not None:
            g = g * scales[:, pt].to(torch.float32)[..., None]
        return g.transpose(0, 1).reshape(B, Hkv, S, D)

    k = gather(k_pages, k_scales)
    v = gather(v_pages, v_scales)
    s = torch.einsum("bhrd,bhsd->bhrs", q4.to(torch.float32), k) * sm_scale
    dev = q4.device
    row_pos = (starts.long()[:, None]
               + torch.arange(R, device=dev)[None, :] % chunk)  # (B, R)
    col = torch.arange(S, device=dev)
    mask = ((col[None, None, :] <= row_pos[:, :, None])
            & (col[None, None, :] < seq_lens.long()[:, None, None]))
    mask = mask[:, None]                                         # (B,1,R,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    out = torch.einsum("bhrs,bhsd->bhrd", p, v)
    return (out / p.sum(-1, keepdim=True).clamp_min(1e-20)).to(q4.dtype)


_SIGNATURES = {"paged_attention_launch":
               [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int]}
# the kernel's instances, by the number its entry reports
_INSTANCES = {0: "split", 1: "mma", 2: "rows"}

# the kernel's decode instance and its split plan: kDecodeMaxGroup,
# kSplitMinKeys and kSplitItemsPerSm of kernels/paged_attention.cu
_DECODE_MAX_GROUP = 8
_SPLIT_MIN_KEYS = 256
_SPLIT_ITEMS_PER_SM = 4


def _decode_route(chunk: int, rows: int) -> bool:
    """Whether a call takes the split-K decode instance, which needs its
    workspace planned here: one position per sequence (chunk 1) and at
    most _DECODE_MAX_GROUP query rows a kv head. Other calls take the
    prefill or the row-tile instance."""
    return chunk == 1 and rows <= _DECODE_MAX_GROUP


def _instance(chunk: int, rows: int, q_dtype, kv_dtype, head_dim: int,
              page_size: int) -> str:
    """The kernel instance a call of these shapes runs, from the kernel's
    own route (``paged_attention_instance``, by which its launch
    dispatches): "split" (decode), "mma" (prefill on the tensor cores) or
    "rows" (the row-tile kernel). Loads the built library, so it needs
    the card's toolchain."""
    lib = _build.load(_KERNEL, _SIGNATURES)
    return _INSTANCES[lib.paged_attention_instance(
        chunk, rows, _DTYPE_CODE[q_dtype], _DTYPE_CODE[kv_dtype], head_dim,
        page_size)]


def _decode_splits(B: int, Hkv: int, W: int, ps: int,
                   n_sm: int) -> Tuple[int, int]:
    """(n_split, pages a split holds) for a decode call, from shapes alone
    (the kernel's ``plan_splits``): about _SPLIT_ITEMS_PER_SM of the
    B * Hkv * n_split (split, sequence, kv head) items an SM, each split
    at least _SPLIT_MIN_KEYS keys of whole pages, and no split without a
    page of the table. Split s holds table columns
    [s * pages, (s + 1) * pages)."""
    min_pages = -(-_SPLIT_MIN_KEYS // ps)
    want = -(-_SPLIT_ITEMS_PER_SM * n_sm // max(B * Hkv, 1))
    n = max(1, min(want, W // min_pages))
    pages = -(-W // n)
    return -(-W // pages), pages


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The decode instance's counters: a merge ticket a (sequence, kv head),
# then the items taken and the blocks done, all int32 and zero between
# calls (the kernel resets them). Kept per device and stream, since calls
# on two streams may run at once; made with torch.zeros on that stream, so
# the first call needs no synchronisation.
_TICKETS: Dict[tuple, torch.Tensor] = {}


def _tickets(device, n: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t



def _kernel_operands(q4, k_pages, v_pages, page_tables, seq_lens, starts,
                     k_scales, v_scales):
    """Check what the kernel takes, on any device; return q4 (contiguous,
    16-byte aligned) and the int32 tables, lengths and starts (None stays
    None: decode). Raises on anything the kernel does not take."""
    dev = q4.device
    B, Hkv, R, D = q4.shape
    _, P, page_size, _ = k_pages.shape
    quantized = k_scales is not None
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention kernel: q dtype {q4.dtype} "
                        "(use float32 or bfloat16)")
    if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged attention kernel: pools {k_pages.dtype}/"
                        f"{v_pages.dtype} (use float32, bfloat16 or int8)")
    if (k_pages.dtype == torch.int8) != quantized:
        raise TypeError("paged attention kernel: int8 pools go with "
                        "k_scales/v_scales, float pools without")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged attention kernel: head_dim {D} "
                         "(use 64, 128 or 256)")
    tensors = [q4, k_pages, v_pages, page_tables, seq_lens]
    if starts is not None:
        tensors.append(starts)
    if quantized:
        tensors += [k_scales, v_scales]
        for sc in (k_scales, v_scales):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (Hkv, P,
                                                               page_size):
                raise ValueError("scales must be float32 (Hkv, P, "
                                 f"page_size); got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    if any(t.device != dev for t in tensors):
        raise ValueError("paged attention kernel: every operand must lie "
                         f"on {dev}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scales", k_scales), ("v_scales", v_scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pools are "
                             "updated in place and never copied)")
    if page_tables.dim() != 2 or page_tables.shape[0] != B \
            or seq_lens.shape != (B,) \
            or (starts is not None and starts.shape != (B,)):
        raise ValueError("page_tables (B, W), seq_lens (B,), starts (B,) "
                         f"expected for B={B}")
    q4 = q4.contiguous()
    if q4.data_ptr() % 16:   # the kernel reads q in 8- and 16-byte words
        q4 = q4.clone()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return (q4, page_tables.to(torch.int32).contiguous(),
            seq_lens.to(torch.int32).contiguous(),
            None if starts is None else starts.to(torch.int32).contiguous())


def _launch_kernel(q4, k_pages, v_pages, page_tables, seq_lens, starts,
                   chunk, sm_scale, k_scales, v_scales):
    """Check the operands, then launch the CUDA kernel on the current
    stream. Raises on anything the kernel does not take and when the
    card refuses the launch."""
    dev = q4.device
    B, Hkv, R, D = q4.shape
    _, P, page_size, _ = k_pages.shape
    q4, pt, sl, st = _kernel_operands(q4, k_pages, v_pages, page_tables,
                                      seq_lens, starts, k_scales, v_scales)
    W = pt.shape[1]
    out = torch.empty_like(q4)
    n_split, work, tickets = 0, None, None
    if _decode_route(chunk, R):
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        n_split, _ = _decode_splits(B, Hkv, W, page_size, _sm_count(index))
        tickets = _tickets(torch.device("cuda", index), B * Hkv + 2)
        if n_split > 1:       # the splits' partials: acc[D], m, l a row
            work = torch.empty((B, Hkv, n_split, R, D + 2),
                               dtype=torch.float32, device=dev)
    elif st is None:
        st = _decode_starts(sl)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    instance = ctypes.c_int(-1)   # the entry reports what it launched
    _build.launch(
        _build.load(_KERNEL, _SIGNATURES), "paged_attention_launch", dev,
        ptr(q4), ptr(k_pages), ptr(v_pages), ptr(k_scales), ptr(v_scales),
        ptr(pt), ptr(sl), ptr(st), ptr(out), ptr(work), ptr(tickets),
        ctypes.addressof(instance),
        B, Hkv, R, D, P, page_size, W, chunk, n_split, float(sm_scale),
        _DTYPE_CODE[q4.dtype], _DTYPE_CODE[k_pages.dtype])
    paged_attention.launches += 1
    paged_attention.instance_launches[_INSTANCES[instance.value]] += 1
    if k_pages.dtype == torch.int8:
        paged_attention.int8_launches += 1
    return out


def _paged_call(q4, k_pages, v_pages, page_tables, seq_lens, starts, chunk,
                sm_scale, k_scales, v_scales):
    """Shared launcher: q4 (B, Hkv, G*chunk, D) -> same shape out."""
    D = q4.shape[-1]
    if D != k_pages.shape[-1]:
        raise ValueError(f"head_dim mismatch: q {D} vs pages "
                         f"{k_pages.shape[-1]}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pools need BOTH k_scales and v_scales")
    if q4.device.type == "cpu":
        return _paged_plain(q4, k_pages, v_pages, page_tables, seq_lens,
                            starts, chunk, sm_scale, k_scales, v_scales)
    if q4.device.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {q4.device}")
    return _launch_kernel(q4, k_pages, v_pages, page_tables, seq_lens,
                          starts, chunk, sm_scale, k_scales, v_scales)


def _as_lens(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32)


def paged_attention(q, k_pages, v_pages, page_tables, seq_lens,
                    sm_scale=None, k_scales=None, v_scales=None):
    """Decode-step attention over a paged KV pool (shapes in the module
    docstring). ``k_scales``/``v_scales`` (Hkv, P, page_size) select the
    int8-pool path. The chunk=1 case of the shared kernel with
    start = seq_len - 1."""
    B, Hq, D = q.shape
    Hkv = k_pages.shape[0]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads "
                         f"{Hkv}")
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = _paged_call(q.reshape(B, Hkv, G, D), k_pages, v_pages,
                      torch.as_tensor(page_tables, device=q.device),
                      _as_lens(seq_lens, q.device), None, 1, sm_scale,
                      k_scales, v_scales)
    return out.reshape(B, Hq, D)


paged_attention.launches = 0
paged_attention.instance_launches = {name: 0 for name in
                                     _INSTANCES.values()}
# the launches of those over int8 pages
paged_attention.int8_launches = 0


def paged_prefill_attention(q, k_pages, v_pages, page_tables, seq_lens,
                            q_start, sm_scale=None, k_scales=None,
                            v_scales=None):
    """Causal attention of a C-token query chunk against the paged pool
    (the chunk's own K/V must already be in its pages).

    q (B, Hq, C, D); pools as in paged_attention; q_start: absolute
    position of the chunk's first token, shared across the batch.
    Returns (B, Hq, C, D). The chunk=C case of the shared kernel; its
    launches count on ``paged_attention.launches`` and
    ``paged_attention.instance_launches``."""
    B, Hq, C, D = q.shape
    Hkv = k_pages.shape[0]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads "
                         f"{Hkv}")
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    starts = torch.full((B,), int(q_start), dtype=torch.int32,
                        device=q.device)
    out = _paged_call(q.reshape(B, Hkv, G * C, D), k_pages, v_pages,
                      torch.as_tensor(page_tables, device=q.device),
                      _as_lens(seq_lens, q.device), starts, C, sm_scale,
                      k_scales, v_scales)
    return out.reshape(B, Hq, C, D)


def paged_attention_reference(q, k_pages, v_pages, page_tables, seq_lens,
                              sm_scale=None, k_scales=None, v_scales=None,
                              q_start=None):
    """The plain version on any device: decode for q (B, Hq, D), or a
    prefill chunk for q (B, Hq, C, D) starting at ``q_start``. Gathers
    pages, masks, exact softmax; rows with no live key give 0."""
    if q.dim() == 3:
        B, Hq, D = q.shape
        C, q4_shape = 1, (B, k_pages.shape[0], -1, D)
    else:
        B, Hq, C, D = q.shape
        q4_shape = (B, k_pages.shape[0], -1, D)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    sl = _as_lens(seq_lens, q.device)
    if q_start is None:
        starts = None
    else:
        starts = torch.full((B,), int(q_start), dtype=torch.int32,
                            device=q.device)
    out = _paged_plain(q.reshape(q4_shape), k_pages, v_pages,
                       torch.as_tensor(page_tables, device=q.device), sl,
                       starts, C, sm_scale, k_scales, v_scales)
    return out.reshape(q.shape)


class PagedKVCache:
    """Host-side page-pool bookkeeping for serving loops: a free list of
    pages plus per-sequence tables (~ vLLM's BlockManager), an
    exact-match prefix cache with LRU retention, the quantized-tier and
    host-memory-tier overlays the serving engine arms, ``purge`` and
    ``export_chain``. ``write`` updates the pools in place and returns
    them (the reference returns new arrays).

    The serving engine keeps one as pure bookkeeping (``kv_heads =
    head_dim = 1`` on the CPU): its device pages live in the factory's
    pools."""

    def __init__(self, n_pages: int, page_size: int, kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16, device=None):
        self.page_size = page_size
        self.device = resolve_device(device)
        self.k_pages = torch.zeros((kv_heads, n_pages, page_size, head_dim),
                                   dtype=dtype, device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        self._free = list(range(n_pages - 1, 0, -1))  # page 0 = padding
        self.tables: dict = {}
        self.lengths: dict = {}
        # prefix cache (~ vLLM automatic prefix caching / SGLang
        # RadixAttention, flattened to exact-match chain hashing): FULL
        # pages of identical token prefixes are shared across sequences.
        # Key = (parent_page_or_0, tuple of page tokens) -> page id;
        # refcounts keep shared pages alive while anyone holds them.
        # RETENTION: a published page whose refcount hits 0 does NOT
        # return to the free list — it parks in the evictable LRU pool,
        # key intact, so a later identical prefix revives it for free.
        # allocate() reclaims from the LRU leaf-first only once the
        # free list runs dry (a parent page never dies before its
        # children — the chain invariant that keeps recycled page ids
        # from ever matching stale child keys).
        self._prefix: dict = {}
        self._refs: dict = {}       # page id -> holders (resident set)
        self._page_key: dict = {}   # page id -> its prefix key
        self._children: dict = {}   # page id -> keys with it as parent
        self._evictable: dict = {}  # page id -> True; insertion = LRU
        self._stats = {"hit_tokens": 0, "lookup_tokens": 0,
                       "evictions": 0, "compactions": 0}
        # quantized-tier overlay (kv_quant serving): page ids whose
        # device content is stored int8+scale. Strictly a subset of
        # resident|evictable — the resident+evictable+free census is
        # untouched; a page's tier dies with its id (eviction, an
        # unpublished free, purge) so a recycled id never reads stale
        # int8 data.
        self._quant: set = set()
        self._kv_quant: str | None = None
        self._page_bytes: tuple | None = None  # (fp, int8+scale) /page
        self._byte_budget: int | None = None
        self._compact_cb = None
        # host-DRAM offload tier (hostmem serving): pages the eviction
        # scan would recycle spill their content to a byte-budgeted
        # HostArena instead of dying, keyed by FULL token prefix
        # (root..page) so a spilled chain's identity survives device
        # page-id recycling. _spilled maps that key -> True for every
        # page this bookkeeper parked in the arena; spill/page-in data
        # movement is the engine's (the _spill_cb / page_in import_cb
        # closures price it on the virtual clock — this bookkeeper
        # never touches device arrays). None/empty when unarmed: the
        # resident+evictable+free census and every stat dict stay
        # byte-identical to the pre-hostmem engine.
        self._arena = None
        self._spill_cb = None
        self._host_page_bytes: tuple | None = None  # (fp, q) /page
        self._spilled: dict = {}
        self._spill_stats = {"spills": 0, "pageins": 0,
                             "spill_refusals": 0}
        # pool generation: purge() bumps it. Content written under an
        # earlier epoch is unreachable after a purge (every key dropped,
        # every page back on the free list), so a restarted replica
        # over this bookkeeper can never serve pre-crash pages; the
        # tag makes "which generation is this pool" checkable.
        self.epoch = 0
        # per-device pool residency, NOTED by the serving engine when
        # its factory pools are mesh-sharded (this bookkeeper's own
        # arrays are 1-element stand-ins there); None = never noted,
        # and cache_stats stays byte-identical to the unsharded shape
        self._pool_bytes: tuple | None = None

    @property
    def n_pages(self) -> int:
        return int(self.k_pages.shape[1])

    def note_pool_bytes(self, total_bytes: int,
                        per_device_bytes: int | None = None):
        """Record the REAL pool's byte footprint (the serving factory
        owns the device arrays; this bookkeeper owns the accounting):
        ``cache_stats()`` then reports ``bytes_per_device`` — the
        number the tensor-parallel capacity claims are gated on. With
        ``per_device_bytes`` omitted the pool is unsharded (one device
        holds everything)."""
        total = int(total_bytes)
        self._pool_bytes = (total, int(per_device_bytes)
                            if per_device_bytes is not None else total)

    # --- quantized page tier (kv_quant serving) ------------------------

    def note_kv_quant(self, mode: str, fp_bytes_per_page: int | None = None,
                      q_bytes_per_page: int | None = None,
                      byte_budget: int | None = None, compact_cb=None):
        """Arm the quantized-tier accounting. ``mode`` is ``"int8"``
        (every occupied page already stored int8+scale by the factory)
        or ``"pressure"`` (full-precision hot pages; parked pages are
        compacted to int8 under byte pressure). The per-page byte costs
        let ``stored_bytes()`` price the pool as actually stored;
        ``byte_budget`` (pressure only) makes ``allocate()`` reclaim
        bytes by compacting the evictable LRU — oldest first, prefix
        keys intact — BEFORE giving up with MemoryError.
        ``compact_cb(page_ids)`` is the device-side compaction hook the
        engine installs (this bookkeeper never touches device data)."""
        if mode not in ("int8", "pressure"):
            raise ValueError(f"note_kv_quant: unknown mode {mode!r}")
        self._kv_quant = mode
        if fp_bytes_per_page is not None:
            self._page_bytes = (int(fp_bytes_per_page),
                                int(q_bytes_per_page))
        self._byte_budget = int(byte_budget) \
            if byte_budget is not None else None
        self._compact_cb = compact_cb

    def quantized_pages(self) -> set:
        return set(self._quant)

    def mark_quantized(self, page_ids):
        """Record that ``page_ids`` are now stored int8 (e.g. after a
        disaggregated import of a mixed-tier chain). Pages must be
        occupied — a free page has no content to have a tier."""
        for p in page_ids:
            if p not in self._refs and p not in self._evictable:
                raise ValueError(
                    f"mark_quantized: page {p} is not occupied")
            self._quant.add(p)

    def compact_candidates(self):
        """Evictable pages not yet quantized, oldest-parked first —
        the order compaction spends them (mirrors the eviction LRU,
        except nothing is forgotten: keys and census stay intact)."""
        return [p for p in self._evictable if p not in self._quant]

    def compact_evictable(self, max_pages: int | None = None) -> list:
        """Compact up to ``max_pages`` (default: all) evictable
        full-precision pages to int8, oldest first: the device hook
        runs first (so a failure there leaves the tier unmarked), then
        the pages join the quantized tier. Returns the page ids
        compacted. Census is untouched — the pages stay evictable,
        keys live, revivable by the same prefixes."""
        cands = self.compact_candidates()
        if max_pages is not None:
            cands = cands[:max_pages]
        if cands:
            if self._compact_cb is not None:
                self._compact_cb(list(cands))
            self._quant.update(cands)
            self._stats["compactions"] += len(cands)
        return cands

    def stored_bytes(self) -> int | None:
        """Bytes the OCCUPIED pages (resident + evictable) actually
        cost as stored: quantized pages at int8+scale size, the rest
        at full precision. None until note_kv_quant supplied per-page
        costs. This is the dynamic pressure signal — admission grows
        it, compaction shrinks it, eviction zeroes a page's share."""
        if self._page_bytes is None:
            return None
        fp, q = self._page_bytes
        occupied = len(self._refs) + len(self._evictable)
        n_q = len(self._quant)
        if self._kv_quant == "int8":
            return occupied * q
        return (occupied - n_q) * fp + n_q * q

    # --- host-DRAM offload tier (hostmem serving) ----------------------

    def note_hostmem(self, arena, spill_cb,
                     fp_bytes_per_page: int,
                     q_bytes_per_page: int | None = None):
        """Arm the host-arena spill tier. ``arena`` is a
        ``serving.hostmem.HostArena``; ``spill_cb(page_id, quant)``
        is the engine's export closure — it copies the page's device
        content host-side (priced as one ``kv_pageout`` on the
        virtual clock) and returns the opaque data blob the arena
        stores. Per-page byte prices charge the arena budget: a page
        sitting in the int8 tier spills at ``q_bytes_per_page``
        (the kv_quant_page_bytes arithmetic carried across the tier
        boundary), everything else at ``fp_bytes_per_page``."""
        self._arena = arena
        self._spill_cb = spill_cb
        q = int(q_bytes_per_page) if q_bytes_per_page is not None \
            else int(fp_bytes_per_page)
        self._host_page_bytes = (int(fp_bytes_per_page), q)

    def _spill_key(self, p) -> tuple | None:
        """Page ``p``'s FULL token prefix (root..p, a page multiple of
        tokens), reconstructed by walking parent keys — the identity a
        spilled page keeps after its device id recycles. None for an
        unpublished page or a broken walk (nothing to spill under)."""
        parts = []
        while p != 0:
            key = self._page_key.get(p)
            if key is None:
                return None
            parts.append(key[1])
            p = key[0]
        toks: tuple = ()
        for seg in reversed(parts):
            toks += seg
        return toks

    def _try_spill(self, p):
        """Park evicted page ``p``'s content in the host arena before
        its device id recycles. Refusal (arena budget exhausted, or an
        unpublished page with no prefix identity) is silent: the page
        simply dies exactly as it did pre-hostmem. A key the arena
        already holds is NOT re-copied — same token prefix, same K/V
        content."""
        key = self._spill_key(p)
        if key is None:
            return
        if key in self._spilled:
            if key in self._arena:
                return  # identical content already parked host-side
            del self._spilled[key]  # arena LRU reclaimed it since —
            # fall through and re-spill the fresh copy
        quant = p in self._quant
        fp, q = self._host_page_bytes
        try:
            data = self._spill_cb(p, quant)
            self._arena.put(key, data, q if quant else fp,
                            quant=quant, epoch=self.epoch)
        except MemoryError:
            self._spill_stats["spill_refusals"] += 1
            return
        self._spilled[key] = True
        self._spill_stats["spills"] += 1

    def _prune_spilled(self):
        """Drop bookkeeping for keys the arena's own LRU reclaimed
        behind our back (the arena owes the bookkeeper no callback;
        reconciliation is lazy, before any read of ``_spilled``)."""
        gone = [k for k in self._spilled if k not in self._arena]
        for k in gone:
            del self._spilled[k]

    def spilled_extension(self, tokens, start: int) -> list:
        """The spilled keys that would EXTEND ``tokens``' resident
        chain past ``start`` cached tokens (a page multiple), in chain
        order — the admission probe for a priced page-in. Stops at the
        first hole: a mid-chain gap means the earlier pages' K/V is
        gone and everything past it would be wrong-context."""
        out = []
        n = int(start)
        ps = self.page_size
        while n + ps <= len(tokens):
            key = tuple(int(t) for t in tokens[:n + ps])
            if key not in self._spilled \
                    or self._arena.peek(key) is None:
                break
            out.append(key)
            n += ps
        return out

    def page_in(self, seq_id, tokens, start: int, import_cb) -> int:
        """Restore the spilled extension of ``tokens[:start]`` into
        ``seq_id``'s chain: per spilled page, take one device page
        (free list first, eviction — which may itself spill — when
        dry), hand it to ``import_cb(page_id, entry)`` (the engine's
        scatter closure, priced as one ``kv_pagein``), then publish it
        resident under ``seq_id`` exactly as if a prefill had written
        and registered it. Stops — cleanly, partial restores are
        valid prefixes — when the pool cannot yield a page. Returns
        tokens paged in (``lengths[seq_id]`` advanced past them, so
        the prefill resumes beyond the restored prefix). Call between
        ``acquire_prefix`` and ``allocate``; ``rollback_acquire``
        stays exact because restored tokens are counted as hits."""
        table = self.tables.get(seq_id)
        if table is None:
            raise KeyError(f"page_in: unknown sequence {seq_id!r}")
        ps = self.page_size
        n = int(start)
        restored = 0
        for key in self.spilled_extension(tokens, n):
            if not self._free and not self._evictable:
                break
            if not self._free:
                self._evict_lru()  # may itself SPILL, which may evict
                # arena LRU entries — re-probe the key below
            if not self._free:
                break
            entry = self._arena.peek(key)
            if entry is None or entry.epoch != self.epoch:
                break  # evicted arena-side just now, or pre-purge
                # content that must never serve
            p = self._free.pop()
            entry = self._arena.take(key)
            self._spilled.pop(key, None)
            import_cb(p, entry)
            self._refs[p] = 1
            table.append(p)
            parent = table[-2] if len(table) >= 2 else 0
            pkey = (parent, key[n:n + ps])
            self._prefix[pkey] = p
            self._page_key[p] = pkey
            self._children.setdefault(parent, set()).add(pkey)
            if entry.quant:
                self._quant.add(p)
            n += ps
            restored += ps
            self._spill_stats["pageins"] += 1
        if restored:
            self._stats["hit_tokens"] += restored
            self.lengths[seq_id] = n
        return restored

    def spill_chain(self, seq_id, tokens, owner: str) -> list:
        """Preemption-as-swap: park ``seq_id``'s live chain content in
        the arena PINNED under ``owner`` (the rid — a preempted
        request's only K/V copy must survive arbitrary spill traffic
        until it pages back in). Spills every FULL page covered by
        ``lengths[seq_id]`` positions of ``tokens`` (prompt + emitted
        history; the trailing partial page re-prefills on resume).
        ALL-OR-NOTHING: if the arena refuses any page, every put/pin
        this call made is rolled back and [] returns — the caller
        then declines to preempt. Returns the pinned keys on success.
        Pages stay allocated; the caller frees the sequence after."""
        table = self.tables.get(seq_id)
        if table is None:
            raise KeyError(f"spill_chain: unknown sequence "
                           f"{seq_id!r}")
        ps = self.page_size
        n_full = min(int(self.lengths.get(seq_id, 0)) // ps,
                     len(table))
        fp, q = self._host_page_bytes
        put_keys, pinned_keys = [], []
        try:
            for i in range(n_full):
                key = tuple(int(t) for t in tokens[:(i + 1) * ps])
                p = table[i]
                quant = p in self._quant
                if key in self._spilled:
                    e = self._arena.peek(key)
                    if e is not None and e.owner is None:
                        self._arena.pin(key, owner)
                        pinned_keys.append(key)
                    continue  # already parked (or pinned elsewhere —
                    # equally protected); content is identical
                data = self._spill_cb(p, quant)
                self._arena.put(key, data, q if quant else fp,
                                quant=quant, epoch=self.epoch,
                                pin=owner)
                self._spilled[key] = True
                self._spill_stats["spills"] += 1
                put_keys.append(key)
        except MemoryError:
            self._spill_stats["spill_refusals"] += 1
            for key in put_keys:
                self._arena.drop(key)
                self._spilled.pop(key, None)
                self._spill_stats["spills"] -= 1
            for key in pinned_keys:
                self._arena.unpin(key)
            return []
        return put_keys + pinned_keys

    def drop_spilled_owner(self, owner: str) -> int:
        """A preempted request was shed while requeued: its pinned
        chain will never page back in — release the arena bytes and
        forget the keys. Returns entries dropped."""
        dropped = [k for k in list(self._spilled)
                   if (e := self._arena.peek(k)) is not None
                   and e.owner == owner]
        for k in dropped:
            self._arena.drop(k)
            del self._spilled[k]
        return len(dropped)

    def unpin_spilled_owner(self, owner: str):
        """Demote ``owner``'s still-pinned keys to the arena LRU (a
        restored request consumed the keys it needed; leftovers —
        shared-prefix pages that matched resident instead — go back
        to being ordinary spilled cache)."""
        for k in list(self._spilled):
            e = self._arena.peek(k)
            if e is not None and e.owner == owner:
                self._arena.unpin(k)

    def allocate(self, seq_id, n_tokens: int):
        """Reserve pages so ``seq_id`` can hold n_tokens total. The
        free list is spent first; evictable LRU pages are reclaimed
        leaf-first only when it dries. MemoryError fires only when
        free + evictable together cannot cover the need (and mutates
        nothing, so a caller can free()/requeue safely)."""
        table = self.tables.setdefault(seq_id, [])
        need = -(-n_tokens // self.page_size) - len(table)
        if need > len(self._free) + len(self._evictable):
            raise MemoryError(
                f"paged cache exhausted: need {need} pages, "
                f"{len(self._free)} free + {len(self._evictable)} "
                f"evictable")
        if need > 0 and self._byte_budget is not None \
                and self._kv_quant == "pressure":
            # byte-budget admission: new pages land full precision; if
            # that would breach the budget, reclaim bytes by compacting
            # parked LRU pages to int8 FIRST (compaction before
            # shedding — nothing is forgotten). Feasibility is checked
            # before any mutation so MemoryError still mutates nothing.
            # (Conservative: page-count evictions the loop below may do
            # would free more bytes, but refusing early is deterministic
            # and never over-admits.)
            fp, q = self._page_bytes
            projected = self.stored_bytes() + need * fp
            over = projected - self._byte_budget
            if over > 0:
                save = fp - q
                n_compact = -(-over // save) if save > 0 else 0
                cands = self.compact_candidates()
                if save <= 0 or n_compact > len(cands):
                    raise MemoryError(
                        f"paged cache byte budget exhausted: "
                        f"{projected} stored bytes projected > "
                        f"{self._byte_budget} budget and only "
                        f"{len(cands)} compactable pages")
                self.compact_evictable(max_pages=n_compact)
        for _ in range(max(0, need)):
            if not self._free:
                self._evict_lru()
            p = self._free.pop()
            self._refs[p] = 1
            table.append(p)
        return table

    def _evict_lru(self):
        """Reclaim ONE evictable page onto the free list: the least-
        recently-parked page with no LIVE child key (leaf-first). The
        chain invariant — an acquirer always holds a page's parents,
        so refs(parent) >= refs(child) — means an evictable page's
        children are evictable too: a leaf always exists and parents
        are never reclaimed before their children."""
        for p in self._evictable:
            kids = self._children.get(p)
            if kids and any(k in self._prefix for k in kids):
                continue  # still a parent of live keys: not a leaf
            del self._evictable[p]
            if self._arena is not None:
                self._try_spill(p)  # park content host-side BEFORE the
                # prefix identity (and the device id) dies below
            self._drop_keys(p)
            self._quant.discard(p)  # tier dies with the id: a recycled
            # page must never read stale int8 content
            self._stats["evictions"] += 1
            self._free.append(p)
            return
        raise MemoryError("no evictable leaf page")  # unreachable by
        # the chain invariant (kept as a loud guard, not a code path)

    def _drop_keys(self, p):
        """Forget page ``p``'s prefix identity before its id recycles:
        its own key, its membership in the parent's child set, and —
        the wrong-context-KV hazard — every key chained THROUGH it
        (a future sequence must never match stale children under the
        recycled id and share unrelated K/V)."""
        key = self._page_key.pop(p, None)
        if key is not None:
            self._prefix.pop(key, None)
            sibs = self._children.get(key[0])
            if sibs is not None:
                sibs.discard(key)
                if not sibs:
                    self._children.pop(key[0], None)
        for ck in self._children.pop(p, ()):
            page_c = self._prefix.pop(ck, None)
            if page_c is not None \
                    and self._page_key.get(page_c) == ck:
                self._page_key.pop(page_c, None)

    def acquire_prefix(self, seq_id, tokens) -> int:
        """Match ``tokens`` against cached FULL prompt pages; matched
        pages are SHARED into seq_id's table (refcounted) and the
        number of cached tokens (a page multiple) is returned — the
        prefill can resume past them (for a BATCHED prefill, resume at
        the MINIMUM cached count across the batch). Call BEFORE
        allocate(); if allocate() then raises MemoryError, call
        free(seq_id) before retrying or requeueing, or the shared
        refcounts leak."""
        if seq_id in self.tables:
            raise ValueError(
                f"acquire_prefix: {seq_id!r} already holds pages — "
                "free() it first (e.g. after a failed allocate)")
        table = self.tables.setdefault(seq_id, [])
        n = 0
        for page in self._chain(tokens):
            if page in self._evictable:
                del self._evictable[page]  # revival: LRU -> resident
            self._refs[page] = self._refs.get(page, 0) + 1
            table.append(page)
            n += self.page_size
        self._stats["hit_tokens"] += n
        self._stats["lookup_tokens"] += \
            (len(tokens) // self.page_size) * self.page_size
        # write()/decode append after the cached prefix, never inside it
        self.lengths[seq_id] = n
        return n

    def rollback_acquire(self, seq_id, tokens):
        """Leak-proof admit rollback for acquire_prefix -> failed
        allocate: free ``seq_id`` (shared refs released, revived pages
        re-parked evictable) AND unwind the hit/lookup stats the
        acquire recorded — a rolled-back admit was never served from
        cache, and double counting would inflate hit_rate exactly
        under the pool pressure blocked waves retry in. Valid only
        while the table still holds ONLY acquired pages (allocate
        failed without mutating)."""
        n_cached = len(self.tables.get(seq_id, ())) * self.page_size
        self.free(seq_id)
        self._stats["hit_tokens"] -= n_cached
        self._stats["lookup_tokens"] -= \
            (len(tokens) // self.page_size) * self.page_size

    def _chain(self, tokens):
        """Walk the published chain for ``tokens`` from the root,
        yielding each matched page — the ONE matcher under both
        acquire_prefix and match_prefix, so acquisition and admission
        pricing can never disagree on what the cache serves."""
        parent = 0
        n = 0
        ps = self.page_size
        while n + ps <= len(tokens):
            page = self._prefix.get(
                (parent, tuple(int(t) for t in tokens[n:n + ps])))
            if page is None:
                return
            yield page
            parent = page
            n += ps

    def match_prefix(self, tokens) -> int:
        """Non-acquiring probe: how many leading tokens of ``tokens``
        the cache could serve right now (a page multiple). No refcount,
        LRU, or stats mutation — safe for a scheduler to call per
        admission turn to price prefill work before committing."""
        return sum(self.page_size for _ in self._chain(tokens))

    def register_prefix(self, seq_id, tokens):
        """Publish seq_id's FULL prompt pages (now holding real K/V) for
        sharing. Call after the prompt's prefill wrote its pages."""
        table = self.tables.get(seq_id, [])
        parent = 0
        ps = self.page_size
        for i in range(len(tokens) // ps):
            key = (parent, tuple(int(t) for t in tokens[i * ps:(i + 1)
                                                        * ps]))
            page = table[i]
            existing = self._prefix.get(key)
            if existing is None:
                self._prefix[key] = page
                self._page_key[page] = key
                # root (parent == 0) keys are tracked too: _children is
                # the leaf test's reverse index as well as the stale-key
                # invalidator, so EVERY published key must sit under its
                # parent (page 0 is never recycled, but its child set
                # must shrink as root keys die or it leaks forever)
                self._children.setdefault(parent, set()).add(key)
            parent = self._prefix[key]

    def write(self, seq_id, k_new, v_new):
        """Append (Hkv, T, D) keys/values for seq_id. The pools are
        updated IN PLACE (the reference returns new arrays); the same
        pool tensors are returned."""
        T = k_new.shape[1]
        start = self.lengths.get(seq_id, 0)
        self.allocate(seq_id, start + T)
        table = self.tables[seq_id]
        ps = self.page_size
        written = 0
        while written < T:
            pos = start + written
            page = table[pos // ps]
            off = pos % ps
            n = min(ps - off, T - written)  # chunk ends at a page edge
            self.k_pages[:, page, off:off + n] = \
                k_new[:, written:written + n].to(self.k_pages)
            self.v_pages[:, page, off:off + n] = \
                v_new[:, written:written + n].to(self.v_pages)
            written += n
        self.lengths[seq_id] = start + T
        return self.k_pages, self.v_pages

    def free(self, seq_id):
        for p in self.tables.pop(seq_id, []):
            rc = self._refs.get(p, 1) - 1
            if rc <= 0:
                self._refs.pop(p, None)
                if p in self._page_key:
                    # retention: a PUBLISHED page outlives its last
                    # holder — park it in the evictable LRU pool with
                    # its key live, so a recurring prefix revives it
                    # instead of re-prefilling; allocate() reclaims it
                    # leaf-first only under free-list pressure
                    self._evictable[p] = True
                else:
                    self._drop_keys(p)  # stale-chain invalidation for
                    # the recycled id (unpublished pages normally have
                    # no keys; kept defensive)
                    self._quant.discard(p)
                    self._free.append(p)
            else:
                self._refs[p] = rc
        self.lengths.pop(seq_id, None)

    def purge(self):
        """Crash/abort teardown: the pool is GONE, not drained. Every
        sequence's pages are released, every RETAINED (evictable) page
        is reclaimed and every prefix key dropped — unlike ``free()``,
        nothing survives into the retention LRU, because a crashed
        replica's K/V content cannot be trusted — and the pool's
        ``epoch`` is bumped so no later sequence can ever be served
        pages written before the purge. Leaves the census balanced:
        0 resident, 0 evictable, every usable page free. (No per-page
        ``_drop_keys`` walk: the whole key space is wiped below.)"""
        n_pages = self.n_pages
        self.tables.clear()
        self.lengths.clear()
        self._refs.clear()
        self._evictable.clear()
        self._prefix.clear()
        self._page_key.clear()
        self._children.clear()
        self._quant.clear()  # both tiers go: pre-purge int8 content is
        # as untrusted as the full-precision pages
        self._free = list(range(n_pages - 1, 0, -1))
        if self._arena is not None:
            # the host tier dies with the pool: pre-purge spilled
            # content is exactly as untrusted as pre-purge device
            # pages (the epoch guard below would refuse it anyway —
            # dropping keeps the arena census honest about capacity)
            for key in self._spilled:
                self._arena.drop(key)
            self._spilled.clear()
        self.epoch += 1

    def export_chain(self, seq_id, n_tokens: int):
        """The page ids holding ``seq_id``'s first ``n_tokens``
        tokens, in chain order — what a disaggregated serving handoff
        exports (the pages beyond — decode slack the allocation
        reserved — stay behind and are freed with the sequence).
        Raises on an unknown sequence or a chain shorter than the
        asked-for tokens: exporting a hole would hand the importer
        unrelated K/V."""
        table = self.tables.get(seq_id)
        if table is None:
            raise KeyError(f"export_chain: unknown sequence "
                           f"{seq_id!r}")
        need = -(-int(n_tokens) // self.page_size)
        if need > len(table):
            raise ValueError(
                f"export_chain: {seq_id!r} holds {len(table)} pages, "
                f"{need} needed for {n_tokens} tokens")
        return list(table[:need])

    def populations(self) -> Tuple[int, int, int]:
        """The census populations (resident, evictable, free) — the
        counts ``census_ok`` balances against capacity and the cost
        ledger's occupancy sampler integrates per turn."""
        return len(self._refs), len(self._evictable), len(self._free)

    def page_holders(self) -> Dict[int, List[str]]:
        """page -> sorted holder seq_ids, from the live tables — the
        attribution view of the resident tier (a shared prefix page
        lists every sharer; refcounts mirror these memberships, which
        the ledger's occupancy audit cross-checks)."""
        holders: Dict[int, List[str]] = {}
        for sid in sorted(self.tables):
            for p in self.tables[sid]:
                holders.setdefault(p, []).append(sid)
        return holders

    def census_ok(self) -> bool:
        """The accounting invariant in one place: every usable page
        (page 0 is reserved padding) is exactly one of resident /
        evictable / free. The serving engine samples this each turn;
        the serving_prefix bench gate fails if it ever broke."""
        balanced = obs_ledger.census_balanced(
            self.n_pages - 1, *self.populations())
        # the quantized tier is an overlay, never a fourth state: every
        # quantized page must still be occupied
        tier_ok = obs_ledger.overlay_contained(
            self._quant, self._refs, self._evictable)
        if self._arena is not None:
            # the host tier extends the census: spilled is a distinct
            # state (spill != leak, like retention != leak) — after
            # reconciling arena-side LRU deaths, every spilled key
            # must be live in the arena, and the arena's own
            # pinned+evictable+free conservation must hold
            self._prune_spilled()
            if not self._arena.census_ok():
                return False
            if any(k not in self._arena for k in self._spilled):
                return False
        return balanced and tier_ok

    def cache_stats(self) -> dict:
        """Prefix-cache accounting: cumulative hit/lookup tokens and
        evictions plus the live page census. The census satisfies
        ``resident + evictable + free == n_pages - 1`` at all times
        (page 0 is the reserved padding page) — the invariant the
        serving bench gate checks."""
        hit = self._stats["hit_tokens"]
        lookup = self._stats["lookup_tokens"]
        out = {
            "n_pages": self.n_pages - 1,
            "resident_pages": len(self._refs),
            "evictable_pages": len(self._evictable),
            "free_pages": len(self._free),
            "hit_tokens": hit,
            "lookup_tokens": lookup,
            "hit_rate": round(hit / lookup, 4) if lookup else 0.0,
            "evictions": self._stats["evictions"],
        }
        if self._pool_bytes is not None:
            # only when noted (a sharded serving pool): unsharded runs
            # keep the pre-TP dict byte-for-byte
            out["bytes_total"] = self._pool_bytes[0]
            out["bytes_per_device"] = self._pool_bytes[1]
        if self._kv_quant is not None:
            # kv_quant census bucket — present only when the tier is
            # armed (kv_quant=None keeps the dict byte-identical).
            # always-int8 stores every occupied page quantized; pressure
            # counts the compacted overlay.
            occupied = len(self._refs) + len(self._evictable)
            out["quantized_pages"] = (occupied
                                      if self._kv_quant == "int8"
                                      else len(self._quant))
            out["compactions"] = self._stats["compactions"]
            sb = self.stored_bytes()
            if sb is not None:
                out["stored_bytes"] = sb
        if self._arena is not None:
            # hostmem census bucket — present only when the tier is
            # armed (hostmem=None keeps the dict byte-identical)
            self._prune_spilled()
            out["spilled_pages"] = len(self._spilled)
            out["spills"] = self._spill_stats["spills"]
            out["pageins"] = self._spill_stats["pageins"]
            out["spill_refusals"] = self._spill_stats["spill_refusals"]
        return out

    def batch_views(self, seq_ids):
        """(page_tables (B, max_pages), seq_lens (B,)) int32 tensors on
        the bookkeeper's device, padded with the reserved page 0."""
        tables = [self.tables[s] for s in seq_ids]
        width = max((len(t) for t in tables), default=1)
        pt = np.zeros((len(seq_ids), width), np.int32)
        for i, t in enumerate(tables):
            pt[i, :len(t)] = t
        sl = np.asarray([self.lengths[s] for s in seq_ids], np.int32)
        return (torch.from_numpy(pt).to(self.device),
                torch.from_numpy(sl).to(self.device))
