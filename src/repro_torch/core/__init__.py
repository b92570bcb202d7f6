"""Framework-free tier models and migration policies (copies of the
reference's ``repro.core.tiers`` / ``repro.core.migration``) plus the
memory-kind mapping onto CUDA and host memory, with ``TieredArray``."""
from .migration import (AutoNUMA, Block, BlockMove, MigrationExecutor,
                        NoBalance, PlacementDelta, Tiering08, TPP)
from .tiered_array import (gather_pytree, LOGICAL_KINDS, place_pytree,
                           resolve_device, TIER_TO_MEMORY_KIND, TieredArray,
                           to_kind)
from .tiers import GB, GiB, MemoryTier, paper_system

__all__ = ["AutoNUMA", "Block", "BlockMove", "GB", "GiB", "MemoryTier",
           "gather_pytree", "LOGICAL_KINDS", "MigrationExecutor",
           "NoBalance", "paper_system", "place_pytree", "PlacementDelta",
           "resolve_device", "TIER_TO_MEMORY_KIND", "TieredArray",
           "Tiering08", "to_kind", "TPP"]
