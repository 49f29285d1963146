"""paddle_tpu_torch.serving — the continuous-batching serving engine and
its workload harness, in the PyTorch port.

Counterpart of ``paddle_tpu/serving``: a request-stream engine
(``ServingEngine``) driving the dense cache and the paged KV pool behind
a pluggable routing policy, a QoS scheduling front door
(``scheduler.QoSScheduler``), a seeded replayable trace generator
(``workload``), per-request TTFT/TPOT/SLO/goodput/fairness metrics
(``metrics``), the host-only simulated factory (``sim.SimServing``), and
the adapter and grammar caches (``adapters``, ``grammar``: their device
banks come from the serving factory), the memory tiers (the pressure
page tier, ``kv_quant="pressure"`` / ``kv_quant_budget``, compacting
parked pages into the pool's int8 arena; and the host-memory tier,
``hostmem``, whose ``HostArena`` keeps spilled and preempted pages as
pinned host copies), dispatch-ahead decode turns (``dispatch_ahead``),
and the multi-replica layer: the cluster router
(``cluster.ClusterRouter``: round_robin / least_loaded / prefix_aware /
disaggregated placement over N ``EngineSession`` replicas on one shared
virtual timeline, drain/join, KV handoffs across page sizes and into
int8 or pressure pools), seeded fault plans with failover (``faults``)
and the autoscaler (``autoscale``). Still refused by name: ``tp`` (ROADMAP
item 11, option 6), and so a ``kv_reshard`` handoff.
The whole stack is watchable by ``paddle_tpu_torch.obs``.
"""
from .adapters import AdapterCache, AdapterStore  # noqa: F401
from .autoscale import (AutoscaleConfig, Autoscaler,  # noqa: F401
                        count_oscillations)
from .cluster import (ClusterResult, ClusterRouter,  # noqa: F401
                      DisaggregatedPlacement, LeastLoadedPlacement,
                      PlacementPolicy, PrefixAwarePlacement,
                      RoundRobinPlacement, make_placement)
from ..models.nlp.llama_decode import (GrammarConfig,  # noqa: F401
                                       LoRAConfig, SpecConfig,
                                       TPConfig,
                                       synthesize_lora_deltas)
from .grammar import (CompiledGrammar, GrammarCache,  # noqa: F401
                      GrammarStore, TokenVocab, compile_grammar,
                      compile_schema, compile_source, schema_accepts)
from .engine import (DecodeError, EngineClock,  # noqa: F401
                     EngineSession, FixedPolicy, KVHandoff, Policy,
                     RoutedPolicy, ServeResult, ServingEngine,
                     UnstampedHandoffError, load_engine_log,
                     make_policy)
from .faults import (FailoverConfig, FaultEvent,  # noqa: F401
                     FaultPlan, synthesize_fault_plan)
from .hostmem import (HostArena, HostMemConfig,  # noqa: F401
                      as_hostmem_config)
from .metrics import (MetricsCollector, goodput_tokens,  # noqa: F401
                      jain_fairness)
from .scheduler import (QoSScheduler, SchedDecision,  # noqa: F401
                        ServiceEstimator)
from .sim import SimServing, make_sim_serving  # noqa: F401
from .workload import (DEFAULT_TENANTS, Request,  # noqa: F401
                       load_trace, merge_traces, save_trace,
                       synthesize_admission_burst_trace,
                       synthesize_cluster_trace,
                       synthesize_deadline_mix_trace,
                       synthesize_diurnal_trace,
                       synthesize_flash_crowd_trace,
                       synthesize_overload_trace,
                       synthesize_prefill_heavy_trace,
                       synthesize_recurring_prefix_trace,
                       synthesize_schema_trace,
                       synthesize_session_trace,
                       synthesize_trace,
                       synthesize_zipf_adapter_trace, trace_stats)
