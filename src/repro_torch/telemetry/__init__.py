"""Online access telemetry and adaptive re-interleaving (counterpart of
``repro.telemetry``; framework-free copies):

- events:  per-object access events in a ring-buffered, epoch-bucketed
           AccessTrace
- sampler: deterministic PEBS-analogue sampling front-end with a
           modeled profiling-overhead account
- phases:  workload-phase detection from trace deltas
- replan:  the adaptive controller: measured traffic -> re-run
           ObjectLevelInterleave -> gate with the cost model -> execute
           the placement delta through a MigrationExecutor
"""
from .events import AccessEvent, AccessTrace, EpochBucket, ObjectTraffic
from .phases import (classify_traffic, PhaseDetector, PhaseShift,
                     traffic_distance, traffic_signature)
from .replan import AdaptiveReplanner, ReplanConfig, ReplanDecision
from .sampler import AccessSampler, LINE_BYTES, SamplerConfig

__all__ = [
    "AccessEvent", "AccessTrace", "EpochBucket", "ObjectTraffic",
    "LINE_BYTES", "AccessSampler", "SamplerConfig",
    "PhaseDetector", "PhaseShift", "classify_traffic", "traffic_distance",
    "traffic_signature",
    "AdaptiveReplanner", "ReplanConfig", "ReplanDecision",
]
