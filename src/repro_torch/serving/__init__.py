"""Continuous-batching paged-KV serving (counterpart of
``repro.serving``, attention-only models), with the telemetry and
observability planes and adaptive object-level re-interleaving."""
from .config import (ClusterOptions, ConfigError, ExpertOptions,
                     QoSOptions, ROUTER_POLICIES, TieringOptions,
                     validate_args)
from .engine import (check_paged_support, kind_bases, kind_tiers,
                     ServingConfig, ServingEngine, ServingReport)
from .kv_pool import (FAST_KIND, KVBlock, KVBlockSpec, PagedKVPool,
                      PoolExhausted, spec_from_config, TieredKVCache)
from .metrics import percentile, PoolSample, RequestMetrics, ServingMetrics
from .scheduler import (AdmissionPlan, ContinuousBatchingScheduler,
                        plan_admission, Request, RequestState,
                        SchedulerConfig)
from .tiering import KVBlockTierer, make_tiering_policy, POLICIES

__all__ = [
    "AdmissionPlan", "check_paged_support", "ClusterOptions", "ConfigError",
    "ContinuousBatchingScheduler", "ExpertOptions", "FAST_KIND",
    "kind_bases", "kind_tiers", "KVBlock", "KVBlockSpec", "KVBlockTierer",
    "make_tiering_policy", "PagedKVPool", "percentile", "plan_admission",
    "POLICIES", "PoolExhausted", "PoolSample", "QoSOptions", "Request",
    "RequestMetrics", "RequestState", "ROUTER_POLICIES", "SchedulerConfig",
    "ServingConfig", "ServingEngine", "ServingMetrics", "ServingReport",
    "spec_from_config", "TieredKVCache", "TieringOptions", "validate_args",
]
