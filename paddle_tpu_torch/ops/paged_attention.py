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
entry reports it launched. No call reads a length on the host, so none
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
    pages, per-sequence tables and an exact-match prefix cache with LRU
    retention (~ vLLM's BlockManager). ``write`` updates the pools in
    place and returns them.

    The quantized tier, the host-memory spill tier, ``purge`` and
    ``export_chain`` of the reference bookkeeper are not ported yet
    (ROADMAP Queue 1, the serving engine)."""

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
        # prefix cache: key = (parent page or 0, page tokens) -> page id.
        # A published page whose refcount reaches 0 parks in the
        # evictable LRU with its key live; allocate() reclaims leaf-first
        # only when the free list runs dry, so a parent never dies
        # before its children.
        self._prefix: dict = {}
        self._refs: dict = {}       # page id -> holders (resident set)
        self._page_key: dict = {}   # page id -> its prefix key
        self._children: dict = {}   # page id -> keys with it as parent
        self._evictable: dict = {}  # page id -> True; insertion = LRU
        self._stats = {"hit_tokens": 0, "lookup_tokens": 0,
                       "evictions": 0}

    @property
    def n_pages(self) -> int:
        return int(self.k_pages.shape[1])

    def allocate(self, seq_id, n_tokens: int):
        """Reserve pages so ``seq_id`` can hold n_tokens total. The free
        list is spent first, then evictable pages leaf-first. MemoryError
        when free + evictable cannot cover the need (nothing mutated)."""
        table = self.tables.setdefault(seq_id, [])
        need = -(-n_tokens // self.page_size) - len(table)
        if need > len(self._free) + len(self._evictable):
            raise MemoryError(
                f"paged cache exhausted: need {need} pages, "
                f"{len(self._free)} free + {len(self._evictable)} "
                f"evictable")
        for _ in range(max(0, need)):
            if not self._free:
                self._evict_lru()
            p = self._free.pop()
            self._refs[p] = 1
            table.append(p)
        return table

    def _evict_lru(self):
        """Reclaim ONE evictable page: the least recently parked page with
        no live child key."""
        for p in self._evictable:
            kids = self._children.get(p)
            if kids and any(k in self._prefix for k in kids):
                continue  # still a parent of live keys: not a leaf
            del self._evictable[p]
            self._drop_keys(p)
            self._stats["evictions"] += 1
            self._free.append(p)
            return
        raise MemoryError("no evictable leaf page")

    def _drop_keys(self, p):
        """Forget page ``p``'s prefix identity before its id recycles:
        its key, its place in the parent's child set, and every key
        chained through it."""
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
        """Share the cached FULL pages matching ``tokens`` into seq_id's
        table (refcounted) and return the cached token count. Call before
        allocate(); after a failed allocate, call rollback_acquire."""
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
        self.lengths[seq_id] = n
        return n

    def rollback_acquire(self, seq_id, tokens):
        """Undo acquire_prefix after a failed allocate: free ``seq_id``
        and unwind the hit/lookup stats the acquire recorded."""
        n_cached = len(self.tables.get(seq_id, ())) * self.page_size
        self.free(seq_id)
        self._stats["hit_tokens"] -= n_cached
        self._stats["lookup_tokens"] -= \
            (len(tokens) // self.page_size) * self.page_size

    def _chain(self, tokens):
        """Walk the published chain for ``tokens`` from the root,
        yielding each matched page."""
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
        """How many leading tokens the cache could serve now (a page
        multiple), without acquiring anything."""
        return sum(self.page_size for _ in self._chain(tokens))

    def register_prefix(self, seq_id, tokens):
        """Publish seq_id's FULL prompt pages for sharing, after its
        prefill wrote them."""
        table = self.tables.get(seq_id, [])
        parent = 0
        ps = self.page_size
        for i in range(len(tokens) // ps):
            key = (parent, tuple(int(t) for t in tokens[i * ps:(i + 1)
                                                        * ps]))
            page = table[i]
            if self._prefix.get(key) is None:
                self._prefix[key] = page
                self._page_key[page] = key
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
            n = min(ps - off, T - written)  # a piece ends at a page edge
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
                    # retention: a published page outlives its last holder
                    self._evictable[p] = True
                else:
                    self._drop_keys(p)
                    self._free.append(p)
            else:
                self._refs[p] = rc
        self.lengths.pop(seq_id, None)

    def populations(self) -> Tuple[int, int, int]:
        """(resident, evictable, free) page counts."""
        return len(self._refs), len(self._evictable), len(self._free)

    def page_holders(self) -> Dict[int, List[str]]:
        """page -> sorted holder seq_ids, from the live tables."""
        holders: Dict[int, List[str]] = {}
        for sid in sorted(self.tables):
            for p in self.tables[sid]:
                holders.setdefault(p, []).append(sid)
        return holders

    def census_ok(self) -> bool:
        """Every usable page (page 0 is reserved) is exactly one of
        resident / evictable / free."""
        return sum(self.populations()) == self.n_pages - 1

    def cache_stats(self) -> dict:
        """Cumulative hit/lookup tokens and evictions plus the live page
        census (resident + evictable + free == n_pages - 1)."""
        hit = self._stats["hit_tokens"]
        lookup = self._stats["lookup_tokens"]
        return {
            "n_pages": self.n_pages - 1,
            "resident_pages": len(self._refs),
            "evictable_pages": len(self._evictable),
            "free_pages": len(self._free),
            "hit_tokens": hit,
            "lookup_tokens": lookup,
            "hit_rate": round(hit / lookup, 4) if lookup else 0.0,
            "evictions": self._stats["evictions"],
        }

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
