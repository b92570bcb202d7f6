"""Framework-free tier models and migration policies (copies of the
reference's ``repro.core.tiers`` / ``repro.core.migration``) plus the
memory-kind mapping onto CUDA and host memory."""
from .migration import (AutoNUMA, Block, BlockMove, MigrationExecutor,
                        NoBalance, PlacementDelta, Tiering08, TPP)
from .tiered_array import LOGICAL_KINDS, resolve_device, to_kind
from .tiers import GB, GiB, MemoryTier, paper_system

__all__ = ["AutoNUMA", "Block", "BlockMove", "GB", "GiB", "MemoryTier",
           "LOGICAL_KINDS", "MigrationExecutor", "NoBalance",
           "paper_system", "PlacementDelta", "resolve_device", "Tiering08",
           "to_kind", "TPP"]
