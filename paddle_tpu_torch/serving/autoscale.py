"""SLO-driven elastic autoscaling: the control plane that closes the
detect -> act loop.

Every prior serving layer is an INPUT here. The SLO layer detects
(incidents, burn rates, heartbeats), the router can drain/join
replicas and assign prefill/decode roles, the QoS scheduler can
degrade admission budgets — but until
now no component ever ACTED on a signal: an incident was a report.
``Autoscaler`` is the policy that converts the shared ``IncidentLog``
stream plus live utilization probes into membership and policy
actions, so the fleet sizes itself to the workload instead of to the
peak:

- **scale up** (join): while a sustained error-budget burn is open
  (a ``BurnRateRule`` incident — the multi-window rule IS the
  "sustained" filter), a cold replica from the standby pool joins the
  shared virtual timeline. The triggering incidents close with
  resolution ``action_taken`` (``Incident.act``), stamping WHICH
  action resolved them into the postmortem evidence. The standby
  need NOT be a twin of the fleet it joins: since handoff placement
  scores tp-degree / page-geometry / codec mismatches by priced
  reshard cost instead of filtering them out, a
  compatible-but-unequal standby (say a tp=1 int8 decode box behind
  tp=2 fp prefill workers) is a legal join target — its imports pay
  the ``kv_reshard``/``kv_repage``/``kv_transcode`` spans on its own
  clock, which is the autoscaler's capacity-vs-transform-price
  trade, not a refusal.
- **scale down** (drain): when the budget has recovered (no open
  scale/degrade incidents) and cluster decode-slot utilization stays
  below ``drain_below`` for ``drain_sustain`` units, the idlest
  replica drains; its base name returns to the standby pool and a
  later join recycles it under a generation suffix (``s0#2``) — the
  router's exactly-once census is per-request, so recycled names
  conserve it.
- **role rebalance**: in a disaggregated cluster, when the measured
  prefill-chunk backlog per prefill worker crosses ``prefill_hi``
  (prefill-starved) or falls under ``prefill_lo`` while decode slots
  are exhausted (decode-starved), one dedicated worker flips
  prefill <-> decode. Role-less clusters never rebalance.
- **QoS degradation**: every page-severity incident is fanned into
  each live replica's ``QoSScheduler.note_incident`` THE MOMENT it
  opens (not at the next tick) — the scheduler's
  ``incident_degrade`` tier then clamps admission budgets while the
  incident stays open, shedding less by answering shorter. This is
  the "flip tiers before shedding" action the scheduler's incident
  seam was declared for.

**Why it cannot oscillate.** Every action kind carries its own
cooldown, and join/drain are coupled by hysteresis: a drain is
refused within ``hold_after_join`` of any join (and vice versa within
``hold_after_drain``), a drain additionally requires the low-util
signal SUSTAINED for ``drain_sustain``, and a join requires an open
burn incident — which a drain-worthy (idle, budget-recovered) cluster
cannot have. ``count_oscillations`` is the audit the bench gate runs
over the action log.

**Determinism.** Decisions are evaluated ONLY at fixed ticks on the
shared virtual timeline (every ``interval`` units, scheduled like the
heartbeat probe ticks) plus the incident-open callback; all inputs
(incident state, per-replica load/backlog/slot probes) are themselves
deterministic under a seeded trace, so two replays produce a
byte-identical action log — the property the ``serving_autoscale``
gate asserts. With ``ClusterRouter(autoscale=None)`` none of this
code runs and the replay is byte-identical to a pre-autoscale router.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..obs.slo import SEVERITIES


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """The control plane's knobs. Times are virtual clock units.

    ``standby``: base names of the cold replica pool, join order.
    ``min_replicas`` / ``max_replicas``: live-fleet bounds the
    autoscaler may never cross (None = unbounded above).
    ``interval``: evaluation tick period on the shared timeline.
    ``join_cooldown`` / ``drain_cooldown`` / ``role_cooldown`` /
    ``degrade_cooldown``: minimum gap between two actions of the same
    kind (the degrade cooldown bounds LOGGING, not actuation — every
    page incident reaches the schedulers).
    ``hold_after_join`` / ``hold_after_drain``: the join<->drain
    hysteresis band — no drain within ``hold_after_join`` of a join,
    no join within ``hold_after_drain`` of a drain.
    ``drain_below`` / ``drain_sustain``: cluster busy-slot fraction
    that must hold for that long (with zero shedding and scale-up
    disarmed) before a drain fires.
    ``join_above``: while scale-up is ARMED, utilization at or above
    this also carries joins (the saturation path for fleets without
    an admission-shedding front door). The (``drain_below``,
    ``join_above``) dead band is directional hysteresis.
    ``recover_sustain``: how long the fleet must stay CALM (no sheds,
    no open scale incident) before the armed episode ends — a burn
    rule fires ONE incident per episode however many replicas short
    the fleet is, so the episode, not the incident, is what joins
    track.
    ``scale_on`` / ``scale_severity``: incident kinds (and minimum
    severity) that justify a join; the default is exactly the
    sustained multi-window ``BurnRateRule``.
    ``degrade``: fan page-severity incidents into every live
    replica's ``QoSScheduler.note_incident``.
    ``role_rebalance`` + ``prefill_hi`` / ``prefill_lo``: the
    disaggregated role-flip thresholds in prefill chunks per
    dedicated prefill worker (see module docstring).
    """

    standby: Tuple[str, ...] = ("s0", "s1")
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    interval: float = 20.0
    join_cooldown: float = 60.0
    drain_cooldown: float = 240.0
    role_cooldown: float = 240.0
    degrade_cooldown: float = 60.0
    hold_after_join: float = 300.0
    hold_after_drain: float = 60.0
    drain_below: float = 0.35
    drain_sustain: float = 240.0
    join_above: float = 0.85
    recover_sustain: float = 120.0
    scale_on: Tuple[str, ...] = ("burn_rate",)
    scale_severity: str = "warn"
    degrade: bool = True
    role_rebalance: bool = False
    prefill_hi: float = 24.0
    prefill_lo: float = 2.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas is not None \
                and self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.interval <= 0:
            raise ValueError("interval must be > 0 clock units")
        for k in ("join_cooldown", "drain_cooldown", "role_cooldown",
                  "degrade_cooldown", "hold_after_join",
                  "hold_after_drain", "drain_sustain",
                  "recover_sustain"):
            if getattr(self, k) < 0:
                raise ValueError(f"{k} must be >= 0")
        if not 0.0 < self.drain_below <= 1.0:
            raise ValueError("drain_below is a busy fraction in (0, 1]")
        if not self.drain_below < self.join_above <= 1.0:
            raise ValueError("join_above is a busy fraction in "
                             "(drain_below, 1] — the dead band between "
                             "them is what keeps the loop from "
                             "oscillating")
        if self.scale_severity not in SEVERITIES:
            raise ValueError(f"scale_severity {self.scale_severity!r}: "
                             f"use one of {SEVERITIES}")
        if self.prefill_lo > self.prefill_hi:
            raise ValueError("prefill_lo must be <= prefill_hi")


class Autoscaler:
    """One run's autoscaling policy + its action log.

    The ``ClusterRouter`` owns execution; this object owns DECISION
    state (open incidents, cooldown stamps, the low-utilization
    timer, the standby pool) and the append-only ``actions`` log the
    determinism gate replays. Like a router, an Autoscaler runs ONCE
    — build a fresh one per replay, or the second run's log would
    start with the first run's cooldowns.
    """

    def __init__(self, config: Optional[AutoscaleConfig] = None, **kw):
        if config is not None and kw:
            raise ValueError("pass an AutoscaleConfig OR field "
                             "overrides, not both")
        self.cfg = config if config is not None else AutoscaleConfig(**kw)
        self.actions: List[dict] = []
        self._standby: List[str] = list(self.cfg.standby)
        self._open_scale: List[object] = []   # incidents justifying a join
        self._open_page: List[object] = []    # open page incidents (degrade)
        self._last = {"join": None, "drain": None, "role": None,
                      "degrade": None}
        self._low_since: Optional[float] = None
        # scale-up ARMED: a scale incident opened an episode that has
        # not yet RECOVERED (no-shed calm sustained). Joins continue
        # at cooldown cadence while armed and loss persists, because
        # one burn episode fires ONE incident per monitor however
        # many replicas short the fleet is.
        self._armed = False
        self._calm_since: Optional[float] = None
        self._last_sheds = 0
        self._attached = False

    # --- router plumbing ---------------------------------------------------
    def attach(self):
        """Claimed by ONE ClusterRouter run (mirrors the router's own
        run-once discipline: stale cooldowns/actions from a previous
        replay would silently skew the next one)."""
        if self._attached:
            raise RuntimeError("an Autoscaler drives one ClusterRouter "
                               "run — build a fresh one per replay")
        self._attached = True

    def standby_available(self) -> List[str]:
        return list(self._standby)

    def open_page_incidents(self) -> List[object]:
        """Still-open page incidents (a joiner's scheduler is told
        about these at join time, so it degrades like its peers)."""
        self._open_page = [i for i in self._open_page if i.open]
        return list(self._open_page)

    # --- the incident subscription (the on_incident/subscribe seam) --------
    def note_incident(self, inc) -> Optional[str]:
        """Called as each incident OPENS (the router appends this to
        the monitors' ``on_incident`` list). Tracks scale-worthy and
        page-severity incidents; returns ``"degrade"`` when the
        router should fan this incident into every live scheduler
        (page severity + ``cfg.degrade``), else None."""
        cfg = self.cfg
        sev_ok = SEVERITIES.index(inc.severity) \
            >= SEVERITIES.index(cfg.scale_severity)
        if inc.kind in cfg.scale_on and sev_ok:
            self._open_scale.append(inc)
        if not (cfg.degrade and inc.severity == "page"):
            return None
        self._open_page.append(inc)
        return "degrade"

    def log_degrade(self, inc):
        """The router's confirmation callback: the fan-out for ``inc``
        reached >= 1 live scheduler, so the degrade belongs in the
        action log (a fleet of FIFO engines actuates nothing, and the
        log must not claim otherwise). The log entry — not the
        actuation — is cooldown-capped, so an incident storm cannot
        flood the action log."""
        t = inc.t_open
        last = self._last["degrade"]
        if last is None \
                or t - last >= self.cfg.degrade_cooldown - 1e-12:
            self._last["degrade"] = t
            self.actions.append({"t": round(t, 6), "action": "degrade",
                                 "incident": inc.id, "rule": inc.rule})

    # --- the tick ----------------------------------------------------------
    def _cool(self, kind: str, t: float, span: float) -> bool:
        last = self._last[kind]
        return last is None or t - last >= span - 1e-12

    def decide(self, t: float, reps: Sequence, namer,
               sheds_total: int = 0) -> List[dict]:
        """One evaluation tick at virtual time ``t`` over the live
        replica set (the router's ``_Replica`` objects, duck-typed:
        ``name``/``role``/``admitting``/``index``/``session``).
        ``namer(base) -> unique replica name`` is the router's
        generation-suffix allocator; ``sheds_total`` the cluster-wide
        cumulative shed count (live sessions + banked results) — the
        loss signal that carries an armed scale-up episode, because
        an admission-shedding QoS front door converts overload into
        sheds, not slot saturation. Returns the actions the router
        must execute NOW, already appended to ``self.actions``."""
        cfg = self.cfg
        acts: List[dict] = []
        self._open_scale = [i for i in self._open_scale if i.open]
        self._open_page = [i for i in self._open_page if i.open]
        live = [r for r in reps if r.admitting]
        alive = [r for r in live if not r.session.crashed]

        # --- role rebalance (dedicated roles only) ----------------------
        if cfg.role_rebalance and self._cool("role", t, cfg.role_cooldown):
            act = self._decide_role(t, alive)
            if act is not None:
                self._last["role"] = t
                acts.append(act)

        # --- the load signals -------------------------------------------
        slots = sum(r.session.eng.slots for r in alive)
        busy = sum(r.session.eng.slots - r.session.free_slot_count()
                   for r in alive)
        frac = busy / slots if slots else 0.0
        shed_delta = max(0, sheds_total - self._last_sheds)
        self._last_sheds = sheds_total
        # arm on incident; disarm only after a sustained CALM window
        # (no loss, no open incident) — the episode outlives the one
        # incident that opened it
        if self._open_scale:
            self._armed = True
        if shed_delta or self._open_scale:
            self._calm_since = None
        elif self._calm_since is None:
            self._calm_since = t
        if self._armed and self._calm_since is not None \
                and t - self._calm_since >= cfg.recover_sustain - 1e-12:
            self._armed = False

        # --- scale up: a sustained burn opened the episode; ongoing
        # loss (sheds) or saturation carries it until the fleet
        # actually catches up ---------------------------------------------
        trigger = None
        if self._open_scale:
            trigger = "sustained_burn"
        elif self._armed and shed_delta:
            trigger = "armed_shedding"
        elif self._armed and frac >= cfg.join_above:
            trigger = "armed_saturation"
        # the max_replicas bound counts every non-crashed replica the
        # router still holds — a DRAINING replica (not admitting,
        # in-flight rows still streaming) keeps consuming slots and
        # pages, so it must block a join or the live fleet could
        # transiently exceed the bound
        occupying = sum(1 for r in reps if not r.session.crashed)
        if trigger is not None and self._standby \
                and self._cool("join", t, cfg.join_cooldown) \
                and self._cool("drain", t, cfg.hold_after_drain) \
                and (cfg.max_replicas is None
                     or occupying < cfg.max_replicas):
            base = self._standby.pop(0)
            name = namer(base)
            self._last["join"] = t
            self._low_since = None
            act = {"t": round(t, 6), "action": "join", "replica": name,
                   "base": base, "reason": trigger,
                   "busy_frac": round(frac, 4),
                   "incidents": [i.id for i in self._open_scale]}
            for inc in self._open_scale:
                inc.act(t, f"join:{name}")
            self._open_scale = []
            acts.append(act)

        # --- scale down: budget recovered + sustained low utilization ----
        if self._armed or self._open_page or shed_delta \
                or frac >= cfg.drain_below:
            self._low_since = None
        elif self._low_since is None:
            self._low_since = t
        if self._low_since is not None \
                and t - self._low_since >= cfg.drain_sustain - 1e-12 \
                and self._cool("drain", t, cfg.drain_cooldown) \
                and self._cool("join", t, cfg.hold_after_join) \
                and len(alive) > cfg.min_replicas:
            target = self._drain_target(live)
            if target is not None:
                self._last["drain"] = t
                if target.session.crashed:
                    # the drain decision landed on a replica that is
                    # mid-crash (silent, failover pending): a graceful
                    # drain is impossible and forcing one would race
                    # the failure detector — noop LOUDLY and let the
                    # failover own the removal. The drain cooldown is
                    # still charged so a dead replica cannot be
                    # "drained" again every tick.
                    acts.append({"t": round(t, 6),
                                 "action": "drain_noop_crashed",
                                 "replica": target.name,
                                 "reason": "mid-crash-failover"})
                else:
                    self._standby.append(target.name.split("#", 1)[0])
                    acts.append({"t": round(t, 6), "action": "drain",
                                 "replica": target.name,
                                 "reason": "budget_recovered_low_util",
                                 "busy_frac": round(frac, 4),
                                 "low_since": round(self._low_since,
                                                    6)})
        self.actions.extend(acts)
        return acts

    def _drain_target(self, live: Sequence):
        """The idlest admitting replica: least load, then fewest busy
        slots, then the LATEST-joined among equals (LIFO scale-down —
        the longest-lived replicas hold the warmest prefix caches).
        With dedicated roles, never the last prefill-capable or last
        decode-capable worker."""
        cands = list(live)
        roled = any(r.role != "both" for r in cands)
        if roled:
            pre = [r for r in cands if r.role in ("prefill", "both")]
            dec = [r for r in cands if r.role in ("decode", "both")]
            cands = [r for r in cands
                     if not (len(pre) <= 1 and r in pre)
                     and not (len(dec) <= 1 and r in dec)]
        if not cands:
            return None
        return min(cands, key=lambda r: (
            r.session.load(),
            r.session.eng.slots - r.session.free_slot_count(),
            -r.index))

    def _decide_role(self, t: float, alive: Sequence) -> Optional[dict]:
        cfg = self.cfg
        pre = [r for r in alive if r.role == "prefill"]
        dec = [r for r in alive if r.role == "decode"]
        if not pre or not dec:
            return None
        backlog = sum(r.session.prefill_backlog() for r in pre) \
            / len(pre)
        open_slots = sum(r.session.free_slot_count() for r in dec)
        if backlog >= cfg.prefill_hi and len(dec) >= 2 \
                and open_slots > 0:
            # prefill-starved: flip the decode worker with the most
            # open slots (it is the one decode misses least)
            r = min(dec, key=lambda x: (-x.session.free_slot_count(),
                                        x.session.load(), x.index))
            return {"t": round(t, 6), "action": "role",
                    "replica": r.name, "from": "decode",
                    "to": "prefill",
                    "reason": "prefill_backlog_high",
                    "backlog_per_prefill": round(backlog, 4)}
        if backlog <= cfg.prefill_lo and len(pre) >= 2 \
                and open_slots == 0:
            # decode-starved: flip the prefill worker with the least
            # pending work
            r = min(pre, key=lambda x: (x.session.prefill_backlog(),
                                        x.session.load(), x.index))
            return {"t": round(t, 6), "action": "role",
                    "replica": r.name, "from": "prefill",
                    "to": "decode", "reason": "decode_slots_exhausted",
                    "backlog_per_prefill": round(backlog, 4)}
        return None

    # --- rollup ------------------------------------------------------------
    def summary(self) -> dict:
        """The ``ClusterResult.autoscale`` block: the full action log
        plus per-kind counts and the standby pool that remains."""
        by: dict = {}
        for a in self.actions:
            by[a["action"]] = by.get(a["action"], 0) + 1
        return {"actions": list(self.actions),
                "joins": by.get("join", 0),
                "drains": by.get("drain", 0),
                "drain_noops": by.get("drain_noop_crashed", 0),
                "role_changes": by.get("role", 0),
                "degrades": by.get("degrade", 0),
                "standby_left": list(self._standby)}


def count_oscillations(actions: Sequence[dict], window: float) -> int:
    """The oscillation audit the ``serving_autoscale`` gate runs: a
    join at ``t`` followed by ANY drain within ``window`` units is one
    oscillation (capacity added then immediately taken away — the
    thrash hysteresis exists to forbid). Zero on a healthy log."""
    joins = [a["t"] for a in actions if a["action"] == "join"]
    drains = [a["t"] for a in actions if a["action"] == "drain"]
    return sum(1 for tj in joins for td in drains
               if 0.0 <= td - tj < window)
