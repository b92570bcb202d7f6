"""Continuous-batching paged-KV serving (counterpart of
``repro.serving``, dense attention-only models)."""
from .engine import (check_paged_support, ServingConfig, ServingEngine,
                     ServingReport)
from .kv_pool import (FAST_KIND, KVBlock, KVBlockSpec, PagedKVPool,
                      PoolExhausted, spec_from_config)
from .metrics import percentile, PoolSample, RequestMetrics, ServingMetrics
from .scheduler import (AdmissionPlan, ContinuousBatchingScheduler,
                        plan_admission, Request, RequestState,
                        SchedulerConfig)
from .tiering import KVBlockTierer, make_tiering_policy, POLICIES

__all__ = [
    "AdmissionPlan", "check_paged_support", "ContinuousBatchingScheduler",
    "FAST_KIND", "KVBlock", "KVBlockSpec", "KVBlockTierer",
    "make_tiering_policy", "PagedKVPool", "percentile", "plan_admission",
    "POLICIES", "PoolExhausted", "PoolSample", "Request", "RequestMetrics",
    "RequestState", "SchedulerConfig", "ServingConfig", "ServingEngine",
    "ServingMetrics", "ServingReport", "spec_from_config",
]
