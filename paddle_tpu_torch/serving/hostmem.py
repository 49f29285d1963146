"""Host-DRAM offload arena: the serving stack's third memory tier.

Capacity used to end at HBM — under pressure the paged pool compacts
to int8 and then *sheds*. The paper's layer map dedicates a
whole layer to exactly this gap (SURVEY §1, layer 2: host/device
allocators with pinned-host staging below the device runtime), and
production stacks (vLLM swap space, DeepSpeed-Inference/FlexGen
offload) all grow the same organ: a byte-budgeted **host-side page
store** that parks cold prefix-cache pages and preempted requests'
live chains, paged back on demand at a priced transfer cost.

``HostArena`` is the third instance of the budgeted-cache discipline
already proven twice in this codebase (``PagedKVCache``'s page pool,
``AdapterCache``'s device bank):

- **conservation census**: every budgeted byte is exactly one of
  pinned / evictable / free — ``census_ok()`` checks it, the engine
  samples it every turn, and the bench gate fails if it ever broke;
- **atomic refusal**: a ``put`` that cannot fit (even after evicting
  every evictable entry) raises ``MemoryError`` having mutated
  NOTHING, so callers can decline-and-continue safely;
- **LRU retention with pinning**: evictable entries (spilled
  prefix-cache pages) die oldest-first under pressure; pinned entries
  (a preempted request's live chain — its only copy) are never
  reclaimed until their owner unpins them.

The arena stores opaque host objects (whatever the factory's
``export_kv_pages`` returned) priced at caller-declared byte costs —
an int8-compacted page spills at its int8+scale price, the
``kv_quant_page_bytes`` arithmetic carried through the tier boundary.
The arena never touches device state and keeps no engine references;
``PagedKVCache.note_hostmem`` wires it in as the eviction spill
target, and the engine prices every page crossing on its virtual
clock (``kv_pageout`` / ``kv_pagein``, the ``adapter_upload`` /
``KVHandoff`` transfer-pricing pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..obs import ledger as obs_ledger


@dataclasses.dataclass(frozen=True)
class HostMemConfig:
    """Engine-facing knob bundle for ``ServingEngine(hostmem=...)``.

    ``byte_budget`` bounds the arena (host DRAM is big but not free —
    an unbounded swap space hides leaks and lies about capacity).
    ``page_bytes`` optionally overrides the per-page full-precision
    transfer/storage price; by default the engine derives it from the
    factory (``page_bytes_`` when advertised, else the live pool's
    measured bytes / page count)."""

    byte_budget: int
    page_bytes: Optional[int] = None

    def __post_init__(self):
        if self.byte_budget <= 0:
            raise ValueError("hostmem byte_budget must be > 0 bytes")
        if self.page_bytes is not None and self.page_bytes <= 0:
            raise ValueError("hostmem page_bytes must be > 0 bytes")


def as_hostmem_config(spec) -> Optional[HostMemConfig]:
    """None | int byte budget | HostMemConfig -> HostMemConfig."""
    if spec is None or isinstance(spec, HostMemConfig):
        return spec
    if isinstance(spec, bool):
        raise ValueError("hostmem= takes a byte budget (int) or "
                         "HostMemConfig, not a bare bool")
    if isinstance(spec, int):
        return HostMemConfig(byte_budget=spec)
    raise ValueError(f"hostmem= {spec!r}: pass None, a byte budget, "
                     "or a HostMemConfig")


class _Entry:
    __slots__ = ("data", "nbytes", "quant", "epoch", "owner")

    def __init__(self, data, nbytes: int, quant: bool, epoch: int,
                 owner: Optional[str]):
        self.data = data
        self.nbytes = nbytes
        self.quant = quant
        self.epoch = epoch
        self.owner = owner  # pin owner (preempted rid); None = LRU


class HostArena:
    """Byte-budgeted host page store with pin/LRU/census.

    Keys are opaque hashables — the paged bookkeeper keys spilled
    pages by their FULL token prefix (root..page), so a spilled
    chain's identity survives device page-id recycling, replica
    restarts, and arena-internal eviction of unrelated entries.
    """

    def __init__(self, byte_budget: int):
        if byte_budget <= 0:
            raise ValueError("HostArena byte_budget must be > 0")
        self.byte_budget = int(byte_budget)
        self.free_bytes = int(byte_budget)
        self._entries: Dict[object, _Entry] = {}
        self._lru: Dict[object, bool] = {}  # evictable; insertion=LRU
        self._stats = {"pageouts": 0, "pageins": 0, "evictions": 0,
                       "refusals": 0, "peak_bytes": 0}

    # --- state probes -----------------------------------------------------
    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def stored_bytes(self) -> int:
        return self.byte_budget - self.free_bytes

    def pinned_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values()
                   if e.owner is not None)

    def evictable_bytes(self) -> int:
        return sum(self._entries[k].nbytes for k in self._lru)

    def peek(self, key) -> Optional[_Entry]:
        """Non-mutating probe (no LRU refresh, no pagein counted) —
        what the bookkeeper's match path uses to price an admission
        before committing to it."""
        return self._entries.get(key)

    # --- the budgeted store -----------------------------------------------
    def put(self, key, data, nbytes: int, *, quant: bool = False,
            epoch: int = 0, pin: Optional[str] = None) -> None:
        """Store one spilled page. ATOMIC REFUSAL: if ``nbytes``
        cannot fit even after evicting every evictable entry,
        ``MemoryError`` fires having mutated nothing (the caller —
        eviction spill or preemption — declines and proceeds as if
        the arena were absent). Otherwise evictable entries die
        oldest-first until the page fits. Duplicate keys are a caller
        bug (the bookkeeper skips re-spilling a key it already holds).
        """
        nbytes = int(nbytes)
        if nbytes <= 0:
            raise ValueError("put: nbytes must be > 0")
        if key in self._entries:
            raise ValueError(f"put: key already stored: {key!r}")
        if nbytes > self.free_bytes + self.evictable_bytes():
            self._stats["refusals"] += 1
            raise MemoryError(
                f"host arena exhausted: need {nbytes} bytes, "
                f"{self.free_bytes} free + {self.evictable_bytes()} "
                f"evictable of {self.byte_budget} budget")
        while self.free_bytes < nbytes:
            self._evict_lru()
        self.free_bytes -= nbytes
        e = _Entry(data, nbytes, bool(quant), int(epoch), pin)
        self._entries[key] = e
        if pin is None:
            self._lru[key] = True
        self._stats["pageouts"] += 1
        self._stats["peak_bytes"] = max(self._stats["peak_bytes"],
                                        self.stored_bytes())

    def _evict_lru(self):
        key = next(iter(self._lru))
        del self._lru[key]
        e = self._entries.pop(key)
        self.free_bytes += e.nbytes
        self._stats["evictions"] += 1

    def take(self, key) -> _Entry:
        """Page-in: remove and return the entry (the device pool is
        about to hold the content again; keeping a second copy would
        double-count the census — a page that later re-parks simply
        re-spills). Counts one pagein."""
        e = self._entries.pop(key)
        self._lru.pop(key, None)
        self.free_bytes += e.nbytes
        self._stats["pageins"] += 1
        return e

    def drop(self, key) -> bool:
        """Forget an entry without serving it (purge after a crash,
        shed of a preempted request). Idempotent; returns whether the
        key was present."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        self._lru.pop(key, None)
        self.free_bytes += e.nbytes
        return True

    def pin(self, key, owner: str):
        """LRU -> pinned: the entry becomes ``owner``'s (a preempted
        request's live chain must outlive arbitrary spill traffic)."""
        e = self._entries[key]
        if e.owner is None:
            self._lru.pop(key, None)
        e.owner = str(owner)

    def unpin(self, key):
        """Pinned -> LRU (the owner no longer needs the guarantee —
        e.g. a preempted request restored without consuming every
        spilled page). Idempotent for already-evictable entries."""
        e = self._entries.get(key)
        if e is None or e.owner is None:
            return
        e.owner = None
        self._lru[key] = True

    def drop_owner(self, owner: str) -> int:
        """Drop every entry pinned by ``owner`` (a preempted request
        that was shed while queued: its chain will never page back
        in). Returns entries dropped."""
        keys = [k for k, e in self._entries.items()
                if e.owner == owner]
        for k in keys:
            self.drop(k)
        return len(keys)

    # --- census + stats ----------------------------------------------------
    def populations(self) -> Tuple[int, int, int]:
        """The byte-census populations (pinned, evictable, free) —
        shared between ``census_ok`` and the cost ledger's occupancy
        sampler (capacity = ``byte_budget``). Stored bytes are summed
        from the live entries, NOT derived from ``free_bytes``, so
        the balance check cross-checks the two bookkeepers."""
        pinned = sum(e.nbytes for e in self._entries.values()
                     if e.owner is not None)
        evictable = sum(e.nbytes for e in self._entries.values()
                        if e.owner is None)
        return pinned, evictable, self.free_bytes

    def owner_counts(self) -> Dict[str, int]:
        """owner -> live entry count: pinned entries under their
        preemption owner rid, plain LRU spill under ``"cache"`` — the
        attribution view the cost ledger books host-tier page-turns
        by."""
        counts: Dict[str, int] = {}
        for e in self._entries.values():
            owner = e.owner if e.owner is not None else "cache"
            counts[owner] = counts.get(owner, 0) + 1
        return counts

    def census_ok(self) -> bool:
        """The conservation invariant: pinned + evictable + free ==
        budget, every LRU key stored and unpinned, every unpinned
        entry in the LRU (arithmetic shared via
        ``obs.ledger.census_balanced``)."""
        if not obs_ledger.census_balanced(self.byte_budget,
                                          *self.populations()):
            return False
        if any(k not in self._entries or
               self._entries[k].owner is not None for k in self._lru):
            return False
        return all(e.owner is not None or k in self._lru
                   for k, e in self._entries.items())

    def stats(self) -> dict:
        pinned = sum(1 for e in self._entries.values()
                     if e.owner is not None)
        return {
            "byte_budget": self.byte_budget,
            "stored_bytes": self.stored_bytes(),
            "pinned_bytes": self.pinned_bytes(),
            "evictable_bytes": self.evictable_bytes(),
            "free_bytes": self.free_bytes,
            "entries": len(self._entries),
            "pinned_entries": pinned,
            "evictable_entries": len(self._lru),
            "pageouts": self._stats["pageouts"],
            "pageins": self._stats["pageins"],
            "evictions": self._stats["evictions"],
            "refusals": self._stats["refusals"],
            "peak_bytes": self._stats["peak_bytes"],
        }
