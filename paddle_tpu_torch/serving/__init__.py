"""paddle_tpu_torch.serving — the continuous-batching serving engine and
its workload harness, in the PyTorch port.

Counterpart of ``paddle_tpu/serving``: a request-stream engine
(``ServingEngine``) driving the dense cache and the paged KV pool behind
a pluggable routing policy, a QoS scheduling front door
(``scheduler.QoSScheduler``), a seeded replayable trace generator
(``workload``), per-request TTFT/TPOT/SLO/goodput/fairness metrics
(``metrics``), the host-only simulated factory (``sim.SimServing``), and
the adapter and grammar caches (``adapters``, ``grammar``: their device
banks come from the serving factory) and the host half of the
host-memory tier (``hostmem``, whose engine option is refused until its
device half is ported, ROADMAP item 11). The multi-replica layer (``cluster``, ``autoscale``, ``faults``) is not
ported yet (ROADMAP item 9). The whole stack is watchable by
``paddle_tpu_torch.obs``.
"""
from .adapters import AdapterCache, AdapterStore  # noqa: F401
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
