"""paddle_tpu_torch.obs — the observability spine: request-scoped tracing +
a process-global metrics registry.

Two halves, both dependency-free and import-light (no torch at all):

- ``obs.trace``: ``Tracer`` (tracks, nested spans, async request
  lifecycles, chrome://tracing export), a process-global active
  tracer for layers that cannot be handed one (the jit program cache,
  ``route_decode``), and a ``trace_id`` contextvar tying spans to the
  request that caused them. ``ServingEngine(trace=...)`` threads one
  through the serving lifecycle; ``tools/trace_report.py`` summarizes
  the export (per-request waterfall, top recompiles, shed timeline,
  slot occupancy).
- ``obs.metrics``: counters / gauges / fixed-bucket histograms with
  Prometheus text exposition (``REGISTRY.expose_text()``) and JSONL
  snapshots (``REGISTRY.write_jsonl(path)``). Counters stay live even
  when no trace records; ``REGISTRY.disable()`` is the no-obs
  baseline arm of ``tools/bench_gate.py obs`` (tracing-off overhead
  gated <= 2% on the serving workload bench).

Two ACTIVE halves evaluate those streams:

- ``obs.slo``: declarative SLO rules (threshold, multi-window
  burn-rate over an error budget, heartbeat silence) evaluated
  STREAMING on the virtual clock by ``SLOMonitor``, firing typed
  ``Incident`` objects into a shareable ``IncidentLog`` (JSONL,
  deterministic ids). ``ServingEngine(slo=...)`` and
  ``ClusterRouter(slo=...)`` thread monitors through the serving
  stack; ``tools/slo_report.py`` renders the incident timeline and
  per-rule budget burn-down.
- ``obs.flight``: the incident flight recorder — an always-on bounded
  ring of recent trace events (via the Tracer mirror sink) + metric
  samples that freezes a deterministic postmortem bundle
  (chrome-trace excerpt, metrics JSONL, incident JSON, offending
  rids) the moment an incident fires.

And the ACCOUNTING half:

- ``obs.ledger``: the resource-attribution ledger — ``CostLedger``
  books every priced virtual-clock unit against ``(rid | "engine",
  kind)`` and per-turn pool occupancy against its holders, rolled up
  request -> tenant -> feature, with exact integer conservation
  audits (``attributed + idle == elapsed``; per-owner slot-turns ==
  pool integral). Also the shared budgeted-cache census arithmetic
  (``census_balanced`` / ``overlay_contained``) the four pool
  ``census_ok()`` checks delegate to. ``ServingEngine(ledger=...)``
  and ``ClusterRouter(cost_ledger=...)`` thread one through;
  ``tools/cost_report.py`` renders the tables.

Span taxonomy, metric names, the SLO rule grammar / burn-rate math /
bundle layout and the Perfetto how-to live in docs/OBSERVABILITY.md.
"""
from . import flight, ledger, metrics, slo, trace  # noqa: F401
from .ledger import (SCALE, CostLedger,  # noqa: F401
                     census_balanced, load_costs, overlay_contained)
from .flight import FlightRecorder, load_bundle  # noqa: F401
from .metrics import (REGISTRY, Counter, Gauge,  # noqa: F401
                      Histogram, MetricsRegistry, get_registry)
from .slo import (BurnRateRule, HeartbeatRule,  # noqa: F401
                  Incident, IncidentLog, SLOMonitor, ThresholdRule,
                  default_serving_rules, load_incidents)
from .trace import (Tracer, activate, active,  # noqa: F401
                    deactivate, get_trace_id, trace_scope, use)
