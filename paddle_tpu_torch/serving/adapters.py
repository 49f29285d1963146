"""Multi-model LoRA serving: host-resident adapter sets + a budgeted
host<->device adapter cache.

Millions of users means thousands of fine-tuned variants of ONE base
model, not thousands of models. The enabling invariant is the decode path's
weights-as-jit-args: the compiled fixed-shape ``decode_n`` program
takes weights as *inputs*, so N LoRA delta sets can ride through one
compiled program as one more input — a device-resident **adapter
bank** of stacked low-rank ``A @ B`` deltas plus a per-row slot-index
vector (data, not shape), the S-LoRA / Punica batched-multi-adapter
design. Admission/eviction of adapters never recompiles anything.

Two pieces, mirroring the paged KV pool's split between device arrays
and host bookkeeping:

- ``AdapterStore`` — the host-resident registry of named delta sets
  (opaque to this module: the serving factory's ``upload_adapter``
  hook is what consumes a delta set, so the real llama factory stores
  stacked ``(L, in, r)/(L, r, out)`` numpy trees while ``serving.sim``
  stores a salt int).
- ``AdapterCache`` — the budgeted device residency manager: a fixed
  number of bank SLOTS (slot 0 is the reserved identity — all-zero
  deltas — so ``adapter=None`` rows ride the same program), an LRU of
  unpinned-but-retained adapters (a finished request's adapter stays
  resident for the next sharer, exactly the prefix-page
  retention discipline), **pin-while-in-flight** refcounts (an
  adapter serving a live row can never be evicted under pressure),
  and a ``cache_stats()`` census mirroring ``PagedKVCache``'s:
  ``resident + evictable + free == n_slots - 1`` at all times.

``MemoryError`` on acquire means every non-free slot is pinned — the
engine requeues the request and retries as rows finish, the same
discipline a page-pool refusal gets.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..obs import ledger as obs_ledger


class AdapterStore:
    """Host-resident registry of named LoRA delta sets. Values are
    opaque here — the serving factory's ``upload_adapter`` hook
    interprets them (stacked numpy A/B trees for the real llama
    factory, a salt int for ``serving.sim``). One store may back many
    engines/replicas: it is read-only at serve time."""

    def __init__(self, adapters: Optional[Dict[str, object]] = None):
        self._a: Dict[str, object] = {}
        for name, deltas in (adapters or {}).items():
            self.add(name, deltas)

    def add(self, name: str, deltas) -> None:
        if not isinstance(name, str) or not name:
            raise ValueError("adapter name must be a non-empty string")
        if name in self._a:
            raise ValueError(f"adapter {name!r} already registered")
        self._a[name] = deltas

    def get(self, name: str):
        if name not in self._a:
            raise KeyError(f"unknown adapter {name!r} (registered: "
                           f"{sorted(self._a)})")
        return self._a[name]

    def __contains__(self, name) -> bool:
        return name in self._a

    def __len__(self) -> int:
        return len(self._a)

    def names(self) -> List[str]:
        return sorted(self._a)


class AdapterCache:
    """Device residency manager for one engine's adapter bank.

    ``n_slots`` counts the bank's rows INCLUDING slot 0, the reserved
    identity (all-zero deltas; ``adapter=None`` rows decode through it
    and their math is exactly the base model's — adding an exact float
    zero). Usable slots are ``1 .. n_slots-1``; each holds at most one
    uploaded adapter at a time.

    Lifecycle of a slot, mirroring a ``PagedKVCache`` page:

    - **free**: never uploaded, or reclaimed by an eviction;
    - **resident** (pinned): >= 1 in-flight request decodes with it —
      ``acquire(name, rid)`` pins, ``release(name, rid)`` unpins;
      a pinned adapter is NEVER evicted (pin-while-in-flight);
    - **evictable**: uploaded, zero pins — RETAINED with its content
      live (a later ``acquire`` revives it for free: hit, no upload),
      reclaimed LRU-first only when a miss needs a slot and the free
      list is dry.

    ``acquire`` returns ``(slot, uploaded)``; ``uploaded`` is True
    when a real host->device upload ran (the engine prices it on the
    virtual clock — hits are free). ``MemoryError`` when every
    non-free slot is pinned: nothing can be evicted, the caller
    requeues and retries once a row finishes.

    ``init_bank() -> bank`` and ``upload(bank, slot, deltas) -> bank``
    are the factory's device hooks (functional: the returned bank
    rebinds ``self.bank``, functional ``.at[slot].set`` style for the real
    factory, in-place numpy for the sim).
    """

    def __init__(self, store: AdapterStore, n_slots: int,
                 init_bank: Callable[[], object],
                 upload: Callable[[object, int, object], object]):
        if n_slots < 2:
            raise ValueError("need n_slots >= 2 (slot 0 is the "
                             "reserved identity; at least one usable "
                             "slot)")
        self.store = store
        self.n_slots = int(n_slots)
        self.bank = init_bank()
        self._upload = upload
        self._slot: Dict[str, int] = {}      # name -> slot (on device)
        self._pins: Dict[str, set] = {}      # name -> holder rids
        self._evictable: Dict[str, bool] = {}  # insertion order = LRU
        self._free = list(range(self.n_slots - 1, 0, -1))
        self._stats = {"hits": 0, "misses": 0, "uploads": 0,
                       "evictions": 0, "refusals": 0}
        # rids whose admission ROLLED BACK after this cache uploaded
        # for them (page-pool refusal): the retry's acquire is a
        # lookup-level hit, but the ADMISSION still paid one upload —
        # note_rollback/took_upload let the engine report per-request
        # hit/upload telemetry that sums to one event per admission
        self._pending_upload: set = set()

    # --- probes (non-acquiring) -------------------------------------------
    def resident(self, name: str) -> bool:
        """Is ``name`` on device right now (pinned or retained)? The
        cluster's adapter-aware placement probe — no pin, no LRU or
        stats mutation, safe to call per placement decision."""
        return name in self._slot

    def slot_of(self, name: str) -> Optional[int]:
        return self._slot.get(name)

    # --- the acquire/release lifecycle ------------------------------------
    def acquire(self, name: str, rid: str, timed=None):
        """Pin ``name`` for in-flight request ``rid``; returns
        ``(slot, uploaded)``. A resident adapter (pinned by others or
        parked evictable) is a HIT — revived, pinned, no upload. A
        miss takes a free slot (or evicts the LRU unpinned adapter)
        and uploads through the factory hook. ``MemoryError`` when
        every non-free slot is pinned — nothing but the refusal
        counter mutates, so the caller can requeue safely.

        ``timed`` (optional ``f -> f()`` wrapper): the upload call
        runs INSIDE it, so a measured engine clock charges the real
        device transfer to the ``adapter_upload`` span instead of
        letting it bleed into the next prefill/decode call (a fixed
        clock charges its per-upload cost either way)."""
        self.store.get(name)  # unknown adapters refuse loudly
        pins = self._pins.setdefault(name, set())
        if rid in pins:
            raise ValueError(f"adapter {name!r} already pinned for "
                             f"{rid!r}")
        if name in self._slot:
            self._evictable.pop(name, None)  # revival: LRU -> resident
            pins.add(rid)
            self._stats["hits"] += 1
            return self._slot[name], False
        if not self._free and not self._evictable:
            if not pins:
                self._pins.pop(name, None)  # undo the setdefault
            self._stats["refusals"] += 1
            raise MemoryError(
                f"adapter cache exhausted: {self.n_slots - 1} slots "
                f"all pinned by in-flight rows — requeue {rid!r} and "
                "retry when a row finishes")
        self._stats["misses"] += 1
        victim = None
        if self._free:
            slot = self._free.pop()
        else:
            # LRU eviction: the least-recently-parked unpinned adapter
            victim = next(iter(self._evictable))
            del self._evictable[victim]
            slot = self._slot.pop(victim)
            self._pins.pop(victim, None)

        def _run():
            return self._upload(self.bank, slot, self.store.get(name))
        try:
            self.bank = timed(_run) if timed is not None else _run()
        except Exception:
            # exception-safe: a raising upload hook (e.g. a delta set
            # whose rank mismatches the factory's LoRAConfig, caught
            # by the hook's shape check BEFORE any write — the bank
            # rebinds only on success) must not leak the slot out of
            # the census: restore the bookkeeping exactly (an evicted
            # victim's content was never overwritten) and stay loud
            if victim is None:
                self._free.append(slot)
            else:
                self._slot[victim] = slot
                self._evictable[victim] = True
            self._stats["misses"] -= 1
            if not pins:
                self._pins.pop(name, None)
            raise
        if victim is not None:
            self._stats["evictions"] += 1
        self._stats["uploads"] += 1
        self._slot[name] = slot
        pins.add(rid)
        return slot, True

    def release(self, name: str, rid: str) -> None:
        """Unpin ``rid``'s hold on ``name``. The last unpin RETAINS
        the adapter (slot parked in the evictable LRU, content live)
        instead of freeing it — the next sharer hits."""
        pins = self._pins.get(name)
        if pins is None or rid not in pins:
            raise ValueError(f"release: {name!r} holds no pin for "
                             f"{rid!r}")
        pins.discard(rid)
        if not pins:
            self._pins.pop(name, None)
            if name in self._slot:
                self._evictable[name] = True

    def note_rollback(self, name: str, rid: str,
                      uploaded: bool) -> None:
        """``rid``'s admission failed AFTER ``acquire`` (page-pool
        refusal): release the pin and — when that acquire uploaded —
        remember the rid, so ``took_upload`` can attribute the upload
        to the admission that eventually succeeds instead of
        reporting the retry's lookup-hit as a free ride."""
        self.release(name, rid)
        if uploaded:
            self._pending_upload.add(rid)

    def forget_pending(self, rid: str) -> None:
        """Drop ``rid``'s pending-upload marker (no-op without one):
        the request left this engine — shed, or requeued to another
        replica — without re-admitting, so nothing will ever consume
        the marker and a recycled rid must not inherit it."""
        self._pending_upload.discard(rid)

    def took_upload(self, rid: str, uploaded: bool) -> bool:
        """Did ``rid``'s ADMISSION pay an upload — either on this
        acquire or on an earlier rolled-back one? Consumes the
        pending-upload marker."""
        if rid in self._pending_upload:
            self._pending_upload.discard(rid)
            return True
        return uploaded

    # --- census ------------------------------------------------------------
    def resident_count(self) -> int:
        """Adapters on device right now (pinned + retained) — the
        ``serving_adapter_resident`` gauge's value."""
        return len(self._slot)

    def populations(self) -> Tuple[int, int, int]:
        """The census populations (pinned, evictable, free) — the
        counts ``census_ok`` balances against capacity and the cost
        ledger's occupancy sampler integrates per turn."""
        pinned = sum(1 for n in self._slot if self._pins.get(n))
        return pinned, len(self._evictable), len(self._free)

    def pin_owners(self) -> Dict[str, List[str]]:
        """adapter name -> sorted holder rids, pinned slots only —
        the attribution view the cost ledger splits slot-turns by."""
        return {n: sorted(self._pins[n]) for n in self._slot
                if self._pins.get(n)}

    def census_ok(self) -> bool:
        """The accounting invariant, one line: every usable slot
        (slot 0 is the reserved identity) is exactly one of
        pinned-resident / evictable / free (arithmetic shared with
        every budgeted pool via ``obs.ledger.census_balanced``)."""
        return obs_ledger.census_balanced(self.n_slots - 1,
                                          *self.populations())

    def cache_stats(self) -> dict:
        """Adapter-cache accounting, the ``PagedKVCache.cache_stats``
        shape: the live slot census (``resident_slots`` = pinned,
        ``evictable_slots`` = retained at zero pins, ``free_slots``;
        the three sum to ``n_slots - 1``) plus cumulative
        hit/miss/upload/eviction/refusal counters and the derived
        hit rate over lookups."""
        pinned = sum(1 for n in self._slot if self._pins.get(n))
        hits, misses = self._stats["hits"], self._stats["misses"]
        lookups = hits + misses
        return {
            "n_slots": self.n_slots - 1,
            "resident_slots": pinned,
            "evictable_slots": len(self._evictable),
            "free_slots": len(self._free),
            "resident_adapters": len(self._slot),
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / lookups, 4) if lookups else 0.0,
            "uploads": self._stats["uploads"],
            "evictions": self._stats["evictions"],
            "refusals": self._stats["refusals"],
        }
