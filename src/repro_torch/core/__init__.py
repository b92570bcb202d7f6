"""Core library of the port: the paper's contribution as composable
pieces (counterpart of ``repro.core``).

- tiers: memory-tier descriptors and performance models (copy)
- objects: data-object metadata, the unit of OLI placement (copy)
- policies: preferred / first-touch / interleave / OLI (copy)
- costmodel: analytic step-time model and policy search (copy)
- migration: AutoNUMA / Tiering-0.8 / TPP runtimes, the executor (copy)
- tiered_array: memory kinds on a CUDA host, ``TieredArray``
- interleave: policy -> placement orchestration over tensor trees
"""
from .costmodel import (compare_policies, plan_step_cost, policy_search,
                        SearchResult, StepCost)
from .interleave import (distance_weighted_policy, distance_weights,
                         objects_from_pytree, plan_and_place, realize_plan,
                         recommend_streams)
from .migration import (AutoNUMA, Block, BlockMove, MigrationExecutor,
                        NoBalance, PlacementDelta, Tiering08, TPP)
from .objects import (DataObject, hpc_workload_objects, llm_serve_objects,
                      llm_train_objects, select_interleave_candidates,
                      total_footprint)
from .policies import (FirstTouch, make_policy, ObjectLevelInterleave,
                       PlacementPlan, Policy, TierPreferred,
                       UniformInterleave, WeightedInterleave)
from .tiered_array import (gather_pytree, LOGICAL_KINDS, place_pytree,
                           resolve_device, TIER_TO_MEMORY_KIND, TieredArray,
                           to_kind)
from .tiers import GB, GiB, MemoryTier, paper_system

__all__ = [
    "AutoNUMA", "Block", "BlockMove", "compare_policies", "DataObject",
    "distance_weighted_policy", "distance_weights", "FirstTouch",
    "gather_pytree", "GB", "GiB", "hpc_workload_objects",
    "llm_serve_objects", "llm_train_objects", "LOGICAL_KINDS",
    "make_policy", "MemoryTier", "MigrationExecutor", "NoBalance", "ObjectLevelInterleave", "objects_from_pytree",
    "paper_system", "place_pytree", "PlacementDelta", "PlacementPlan",
    "plan_and_place", "plan_step_cost", "Policy", "policy_search",
    "realize_plan", "recommend_streams", "resolve_device", "SearchResult",
    "select_interleave_candidates", "StepCost", "TIER_TO_MEMORY_KIND",
    "TieredArray", "Tiering08", "TierPreferred", "to_kind",
    "total_footprint", "TPP", "UniformInterleave", "WeightedInterleave",
]
