"""paddle_tpu_torch.obs.ledger — the resource-attribution ledger.

The serving stack prices every action on the virtual clock and budgets
four resource pools; this module attributes that cost back to who
incurred it. Two streams feed one :class:`CostLedger`:

- **clock charges**: every priced ``EngineClock.timed`` delta, tagged
  at the call site with ``(rid | "engine", kind)``. Batched dispatches
  (a decode turn over N rows, a ragged-fused prefill) split pro-rata
  across the dispatched rows — the ``timed(cost=[...])`` list-splitting
  convention extended with an attribution vector. Idle jumps
  (``advance_to``) land in a per-engine ``idle`` book. A priced call
  that reaches the clock with NO attribution lands in the
  ``unattributed`` bucket, which the audit requires to be zero.
- **occupancy integrals**: once per engine turn the sampler books who
  held each budgeted pool slot for that turn — device KV pages per
  holding request (shared prefix pages split across holders),
  adapter/grammar pinned slots per pin owner, host-arena entries per
  preemption owner — against a pool-side integral read from the same
  population counts the census checks use.

All books are INTEGER nano-units (``SCALE`` per clock unit /
slot-turn), every delta fully distributed (pro-rata floor with the
residual on the last row), so the headline invariants hold **exactly**,
per engine, on any clock::

    sum(attributed units) + idle == elapsed clock units
    sum(per-owner slot-turns)    == per-turn pool-occupancy integral

Accounts are keyed by rid in ONE shared ledger, so a handoff, failover
or preemption moves a request's open account exactly once — the source
engine's charges stay on its book (work actually burned there), the
destination's accrue to the same account; nothing is lost or
double-counted at any membership change.

Also here: the shared budgeted-cache census arithmetic
(:func:`census_balanced`, :func:`overlay_contained`) that
``PagedKVCache`` / ``AdapterCache`` / ``GrammarCache`` / ``HostArena``
``census_ok()`` delegate to — the occupancy sampler reads the same
population counts, so the time books and the space books can never
disagree about what "resident" means.

Attribution rules, the invariant definitions and their composition
with chaos/disagg/preempt live in docs/OBSERVABILITY.md.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .slo import _atomic_write

# one clock unit / one slot-turn, in ledger integer units. Every
# booked delta is quantized once (round-half-even at nano precision)
# and then distributed EXACTLY — conservation is integer arithmetic,
# never float summation.
SCALE = 10 ** 9

# kind -> feature dimension (the per-feature rollup is a PARTITION by
# kind: base prefill/decode land on "base", transform-priced kinds on
# their transform — so feature rows sum to the attributed total)
KIND_FEATURE = {
    "adapter_upload": "lora",
    "grammar_compile": "grammar",
    "spec_decode": "spec",
    "spec_prefill": "spec",
    "kv_pageout": "hostmem",
    "kv_pagein": "hostmem",
    "kv_transfer": "disagg",
    # the heterogeneous-handoff transform steps (reshard-on-import):
    # distinct attributable kinds, one feature — the disagg machinery
    # priced them, whichever axis mismatched
    "kv_reshard": "disagg",
    "kv_repage": "disagg",
    "kv_transcode": "disagg",
}

# non-request owners a charge/occupancy entry may carry: engine-owned
# priced work (e.g. a pressure pageout with no single beneficiary),
# the prefix cache's retained pages, and the audit-must-be-zero bucket
_SYSTEM_OWNERS = ("engine", "cache", "unattributed")


def census_balanced(capacity: int, *populations: int) -> bool:
    """The budgeted-cache conservation arithmetic every pool shares:
    the disjoint populations (resident/pinned, evictable, free — or
    stored/free bytes) partition the capacity exactly."""
    return sum(int(p) for p in populations) == int(capacity)


def overlay_contained(overlay, *tiers) -> bool:
    """An overlay population (e.g. the int8 KV tier) may only mark
    members that exist in one of the base tiers — nothing quantized
    may be free."""
    return all(any(k in t for t in tiers) for k in overlay)


def _quantize(delta: float) -> int:
    return int(round(float(delta) * SCALE))


def _split(u: int, n: int, weights=None) -> List[int]:
    """Distribute ``u`` integer units over ``n`` rows, exactly:
    pro-rata by ``weights`` when given (the ``cost=[...]`` vector of a
    fused dispatch), equal otherwise; floors everywhere with the
    residual on the LAST row (deterministic — rows arrive in slot
    order)."""
    if n <= 0:
        return []
    if weights is not None and len(weights) == n:
        tot = float(sum(weights))
        if tot > 0:
            shares = [int(u * float(w) / tot) for w in weights[:-1]]
            shares.append(u - sum(shares))
            if all(s >= 0 for s in shares):
                return shares
    q, rem = divmod(u, n)
    return [q] * (n - 1) + [q + rem]


# the per-turn occupancy sampler splits SCALE among a page's holders
# for every resident page — memoise the (tiny) family of even splits
# it ever asks for, so the hot loop costs a dict hit, not arithmetic
_EVEN_SCALE_SPLITS: Dict[int, List[int]] = {}


def _split_scale(n: int) -> List[int]:
    shares = _EVEN_SCALE_SPLITS.get(n)
    if shares is None:
        shares = _EVEN_SCALE_SPLITS[n] = _split(SCALE, n)
    return shares


class CostLedger:
    """Per-request / per-tenant / per-feature cost accounting with
    conservation audits. One instance may be shared across every
    engine/session/replica of a run (the cluster router does) — books
    are per engine, accounts are global by rid."""

    def __init__(self):
        # engine label -> {"elapsed": int, "idle": int,
        #                  "charges": {(owner, kind): int}}
        self._books: Dict[str, dict] = {}
        # rid -> {"tenant", "features": set, "outcomes": [..],
        #         "est": float|None}
        self._accounts: Dict[str, dict] = {}
        # engine -> {(owner, tier): int} / {tier: int}
        self._occ: Dict[str, Dict[Tuple[str, str], int]] = {}
        self._occ_pool: Dict[str, Dict[str, int]] = {}
        self._turns: Dict[str, int] = {}
        # prometheus watermarks: metric key -> last published int
        self._published: Dict[tuple, int] = {}

    # --- accounts ---------------------------------------------------------
    def _account(self, rid: str) -> dict:
        acct = self._accounts.get(rid)
        if acct is None:
            acct = {"tenant": None, "features": set(),
                    "outcomes": [], "est": None}
            self._accounts[rid] = acct
        return acct

    def open(self, rid: str, tenant: Optional[str] = None,
             features=()) -> None:
        """Open (or re-open: MERGE, never reset) ``rid``'s account —
        a failed-over / handed-off request keeps one account across
        every engine it touches."""
        acct = self._account(rid)
        if tenant is not None:
            acct["tenant"] = tenant
        acct["features"].update(features)

    def tag(self, rid: str, feature: str) -> None:
        self._account(rid)["features"].add(feature)

    def note_outcome(self, rid: str, outcome: str) -> None:
        """Record a lifecycle outcome ("completed", "shed",
        "failover", "handoff", ... — the trace-root vocabulary). A
        moved account collects the move AND its final outcome, in
        order — the exactly-once evidence chaos tests assert on."""
        self._account(rid)["outcomes"].append(outcome)

    def note_estimate(self, rid: str, units: float) -> None:
        """The admission-time estimator price (prefill + headroomed
        decode) — accumulated per rid across retries, the calibration
        signal ``tools/cost_report.py`` compares against actuals."""
        acct = self._account(rid)
        acct["est"] = (acct["est"] or 0.0) + float(units)

    # --- clock charges ----------------------------------------------------
    def _book(self, engine: str) -> dict:
        book = self._books.get(engine)
        if book is None:
            book = {"elapsed": 0, "idle": 0, "charges": {}}
            self._books[engine] = book
        return book

    def charge(self, engine: str, kind: str, delta: float, *,
               rid: Optional[str] = None,
               rids: Optional[List[str]] = None,
               weights=None) -> None:
        """Book one priced clock delta on ``engine``'s books. ``rid``
        attributes to one owner (a request, or ``"engine"`` for
        engine-owned work); ``rids`` splits pro-rata across a batched
        dispatch (by ``weights`` when the call priced per-row costs);
        neither lands in ``unattributed`` — audited to zero."""
        u = _quantize(delta)
        book = self._book(engine)
        book["elapsed"] += u
        if u == 0:
            return
        ch = book["charges"]
        if rids:
            for r, s in zip(rids, _split(u, len(rids), weights)):
                if s:
                    ch[(r, kind)] = ch.get((r, kind), 0) + s
        else:
            owner = rid if rid is not None else "unattributed"
            ch[(owner, kind)] = ch.get((owner, kind), 0) + u

    def idle(self, engine: str, delta: float) -> None:
        """Book an idle clock jump (``advance_to`` past now)."""
        u = _quantize(delta)
        book = self._book(engine)
        book["elapsed"] += u
        book["idle"] += u

    # --- occupancy integrals ----------------------------------------------
    def sample_occupancy(self, engine: str, book=None, acache=None,
                         gcache=None, arena=None) -> None:
        """One engine turn's occupancy: who held each budgeted slot
        for this turn. Pool-side integrals come from the same
        population counts ``census_ok`` checks, so the per-owner sum
        cross-checks the caches' own bookkeeping (tables vs refcounts,
        pins vs slots) — audited exact every run.

        Tiers: ``kv`` (device pages; shared prefix pages split across
        their holders, retained evictable pages owned by ``"cache"``),
        ``adapter`` / ``grammar`` (pinned slots per pin owner),
        ``host`` (arena entries per preemption owner; plain LRU spill
        owned by ``"cache"``)."""
        occ = self._occ.setdefault(engine, {})
        pool = self._occ_pool.setdefault(engine, {})
        self._turns[engine] = self._turns.get(engine, 0) + 1

        def bump(owner, tier, units):
            if units:
                occ[(owner, tier)] = occ.get((owner, tier), 0) + units

        if book is not None:
            resident, evictable, _free = book.populations()
            holders = book.page_holders()
            # aggregate unshared pages (the vast majority) into one
            # bump per holder; only shared pages need the pro-rata
            # split, and only THEY need sorting (residual-on-last
            # determinism) — additions commute
            counts: Dict[str, int] = {}
            shared = []
            for page, rids in holders.items():
                if len(rids) == 1:
                    r = rids[0]
                    counts[r] = counts.get(r, 0) + 1
                else:
                    shared.append(page)
            for r, n in counts.items():
                bump(r, "kv", n * SCALE)
            for page in sorted(shared):
                rids = holders[page]
                for r, s in zip(rids, _split_scale(len(rids))):
                    bump(r, "kv", s)
            bump("cache", "kv", evictable * SCALE)
            pool["kv"] = pool.get("kv", 0) \
                + (resident + evictable) * SCALE
        for tier, cache in (("adapter", acache), ("grammar", gcache)):
            if cache is None:
                continue
            pinned = cache.populations()[0]
            owners = cache.pin_owners()
            for name in sorted(owners):
                rids = owners[name]
                for r, s in zip(rids, _split_scale(len(rids))):
                    bump(r, tier, s)
            pool[tier] = pool.get(tier, 0) + pinned * SCALE
        if arena is not None:
            counts = arena.owner_counts()
            for owner in sorted(counts):
                bump(owner, "host", counts[owner] * SCALE)
            pool["host"] = pool.get("host", 0) \
                + sum(counts.values()) * SCALE

    # --- audits -----------------------------------------------------------
    def audit(self, engine: Optional[str] = None) -> dict:
        """The conservation audit: per engine (or every engine),
        ``sum(attributed) + idle == elapsed`` on the clock books,
        ``sum(per-owner) == pool integral`` per occupancy tier, and
        zero unattributed units. Integer arithmetic — exact, not
        tolerance-checked."""
        engines = [engine] if engine is not None \
            else sorted(set(self._books) | set(self._occ_pool))
        conserved = occupancy = True
        unattributed = 0
        for e in engines:
            book = self._books.get(e)
            if book is not None:
                attributed = sum(book["charges"].values())
                if attributed + book["idle"] != book["elapsed"]:
                    conserved = False
                unattributed += sum(
                    v for (o, _k), v in book["charges"].items()
                    if o == "unattributed")
            occ = self._occ.get(e, {})
            pool = self._occ_pool.get(e, {})
            for tier, total in pool.items():
                got = sum(v for (_o, t), v in occ.items()
                          if t == tier)
                if got != total:
                    occupancy = False
            for (_o, t) in occ:
                if t not in pool:
                    occupancy = False
        return {"conserved_ok": conserved,
                "occupancy_ok": occupancy,
                "unattributed_units": round(unattributed / SCALE, 9),
                "ok": conserved and occupancy and unattributed == 0}

    # --- views ------------------------------------------------------------
    @staticmethod
    def _units(u: int) -> float:
        return round(u / SCALE, 9)

    def cost_stats(self, engine: str) -> dict:
        """One engine's banked accounting (the ``ServeResult
        .cost_stats`` payload): the integer books in clock units, per
        kind, plus this engine's audit verdicts."""
        book = self._books.get(engine,
                               {"elapsed": 0, "idle": 0, "charges": {}})
        kinds: Dict[str, int] = {}
        for (_owner, kind), v in book["charges"].items():
            kinds[kind] = kinds.get(kind, 0) + v
        occ = self._occ.get(engine, {})
        tiers: Dict[str, int] = {}
        for (_owner, tier), v in occ.items():
            tiers[tier] = tiers.get(tier, 0) + v
        audit = self.audit(engine)
        return {
            "engine": engine,
            "elapsed_units": self._units(book["elapsed"]),
            "idle_units": self._units(book["idle"]),
            "attributed_units": self._units(
                sum(book["charges"].values())),
            "kinds": {k: self._units(v)
                      for k, v in sorted(kinds.items())},
            "page_turns": {t: self._units(v)
                           for t, v in sorted(tiers.items())},
            "turns": self._turns.get(engine, 0),
            "conserved_ok": audit["conserved_ok"],
            "occupancy_ok": audit["occupancy_ok"],
            "unattributed_units": audit["unattributed_units"],
        }

    def _request_totals(self) -> Dict[str, dict]:
        """rid -> {"units": {kind: int}, "page_turns": {tier: int}}
        summed across every engine book (system owners excluded)."""
        per: Dict[str, dict] = {}

        def row(owner):
            e = per.get(owner)
            if e is None:
                e = {"units": {}, "page_turns": {}}
                per[owner] = e
            return e

        for book in self._books.values():
            for (owner, kind), v in book["charges"].items():
                if owner in _SYSTEM_OWNERS:
                    continue
                d = row(owner)["units"]
                d[kind] = d.get(kind, 0) + v
        for occ in self._occ.values():
            for (owner, tier), v in occ.items():
                if owner in _SYSTEM_OWNERS:
                    continue
                d = row(owner)["page_turns"]
                d[tier] = d.get(tier, 0) + v
        return per

    def _features_of(self, rid: str, totals: dict) -> List[str]:
        """The account's tagged features plus the kinds-derived ones
        (a request that paid adapter_upload used lora, etc.)."""
        feats = set(self._accounts.get(rid, {}).get("features", ()))
        for kind in totals["units"]:
            f = KIND_FEATURE.get(kind)
            if f is not None:
                feats.add(f)
        if totals["page_turns"].get("host"):
            feats.add("hostmem")
        return sorted(feats)

    def tenant_costs(self) -> Dict[str, dict]:
        """tenant -> {"cost_units", "page_turns"} across every engine
        — the ``MetricsCollector.report()`` per-tenant columns.
        Untenanted requests are skipped (the QoS block only rolls up
        named tenants)."""
        out: Dict[str, dict] = {}
        for rid, tot in self._request_totals().items():
            tenant = self._accounts.get(rid, {}).get("tenant")
            if tenant is None:
                continue
            e = out.setdefault(tenant,
                               {"cost_units": 0, "page_turns": 0})
            e["cost_units"] += sum(tot["units"].values())
            e["page_turns"] += sum(tot["page_turns"].values())
        return {t: {"cost_units": self._units(v["cost_units"]),
                    "page_turns": self._units(v["page_turns"])}
                for t, v in sorted(out.items())}

    def rollup(self) -> dict:
        """The cluster-level summary (``ClusterResult.cost_rollup``):
        per-tenant and per-feature unit totals, per-engine books, the
        global audit."""
        per_req = self._request_totals()
        tenants: Dict[str, dict] = {}
        features: Dict[str, int] = {}
        for rid, tot in per_req.items():
            acct = self._accounts.get(rid, {})
            tenant = acct.get("tenant") or "-"
            te = tenants.setdefault(
                tenant, {"requests": 0, "cost_units": 0,
                         "page_turns": 0})
            te["requests"] += 1
            te["cost_units"] += sum(tot["units"].values())
            te["page_turns"] += sum(tot["page_turns"].values())
            for kind, v in tot["units"].items():
                f = KIND_FEATURE.get(kind, "base")
                features[f] = features.get(f, 0) + v
        for book in self._books.values():
            for (owner, kind), v in book["charges"].items():
                if owner in _SYSTEM_OWNERS:
                    f = KIND_FEATURE.get(kind, "base")
                    features[f] = features.get(f, 0) + v
        audit = self.audit()
        return {
            "requests": len(per_req),
            "tenants": {
                t: {"requests": e["requests"],
                    "cost_units": self._units(e["cost_units"]),
                    "page_turns": self._units(e["page_turns"])}
                for t, e in sorted(tenants.items())},
            "features": {f: self._units(v)
                         for f, v in sorted(features.items())},
            "engines": {e: self.cost_stats(e)
                        for e in sorted(self._books)},
            **audit,
        }

    # --- artifacts --------------------------------------------------------
    def save_costs(self, path: str) -> str:
        """Dump the ledger as JSONL (atomic, the shared ``obs`` write
        discipline): per-request rows, per-tenant rows, per-feature
        rows, per-engine rows — and the global audit row LAST (the
        report-tool convention)."""
        rows: List[dict] = []
        per_req = self._request_totals()
        for rid in sorted(per_req):
            tot = per_req[rid]
            acct = self._accounts.get(rid, {})
            row = {"row": "request", "rid": rid,
                   "tenant": acct.get("tenant"),
                   "features": self._features_of(rid, tot),
                   "units": {k: self._units(v) for k, v
                             in sorted(tot["units"].items())},
                   "total_units": self._units(
                       sum(tot["units"].values())),
                   "page_turns": {t: self._units(v) for t, v
                                  in sorted(tot["page_turns"].items())},
                   "outcomes": list(acct.get("outcomes", []))}
            if acct.get("est") is not None:
                row["est_units"] = round(acct["est"], 9)
            rows.append(row)
        roll = self.rollup()
        for tenant, e in roll["tenants"].items():
            rows.append({"row": "tenant", "tenant": tenant, **e})
        for feat, v in roll["features"].items():
            rows.append({"row": "feature", "feature": feat,
                         "cost_units": v})
        for engine, stats in roll["engines"].items():
            rows.append({"row": "engine", **stats})
        rows.append({"row": "global",
                     "requests": roll["requests"],
                     "cost_units": self._units(sum(
                         sum(b["charges"].values())
                         for b in self._books.values())),
                     "conserved_ok": roll["conserved_ok"],
                     "occupancy_ok": roll["occupancy_ok"],
                     "unattributed_units": roll["unattributed_units"],
                     "ok": roll["ok"]})
        _atomic_write(path, "".join(json.dumps(r) + "\n"
                                    for r in rows))
        return path

    def publish(self, registry) -> None:
        """Export the books into the metrics registry (armed-only —
        the caller guards, so a ledger-less run's registry stays
        byte-identical): ``serving_cost_units_total{tenant,kind}`` and
        ``serving_page_turns_total{tenant,tier}``. Watermarked: safe
        to call once per session on a shared ledger — each call
        increments by the delta since the last publish."""
        def bump(name, help_, key, value, **labels):
            prev = self._published.get(key, 0)
            if value > prev:
                registry.counter(name, help_, **labels).inc(
                    (value - prev) / SCALE)
                self._published[key] = value

        units: Dict[Tuple[str, str], int] = {}
        for book in self._books.values():
            for (owner, kind), v in book["charges"].items():
                if owner in _SYSTEM_OWNERS:
                    tenant = owner
                else:
                    tenant = self._accounts.get(owner, {}) \
                                 .get("tenant") or "-"
                key = (tenant, kind)
                units[key] = units.get(key, 0) + v
        for (tenant, kind) in sorted(units):
            bump("serving_cost_units_total",
                 "attributed virtual-clock cost units",
                 ("u", tenant, kind), units[(tenant, kind)],
                 tenant=tenant, kind=kind)
        turns: Dict[Tuple[str, str], int] = {}
        for occ in self._occ.values():
            for (owner, tier), v in occ.items():
                if owner in _SYSTEM_OWNERS:
                    tenant = owner
                else:
                    tenant = self._accounts.get(owner, {}) \
                                 .get("tenant") or "-"
                key = (tenant, tier)
                turns[key] = turns.get(key, 0) + v
        for (tenant, tier) in sorted(turns):
            bump("serving_page_turns_total",
                 "pool slot-turns held (pages x engine turns)",
                 ("t", tenant, tier), turns[(tenant, tier)],
                 tenant=tenant, tier=tier)


def load_costs(path: str) -> List[dict]:
    """Read a ``save_costs`` JSONL back (tolerant: blank lines
    skipped), for the report tools."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
