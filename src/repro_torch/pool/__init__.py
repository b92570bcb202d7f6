"""Multi-tenant residency ledger, tier arbitration and tiered training
state (counterpart of ``repro.pool``):

- ledger:    ``ResidencyLedger``, the single source of truth for
             bytes-per-tier-per-tenant
- arbiter:   ``TierBudgetArbiter`` splits the fast tier across tenant
             namespaces from measured (or predicted) per-tenant demand
- movesched: ``MoveScheduler`` batches every tenant's placement deltas
             per round, coalesces them, and orders them
             priority-weighted over the links their paths share
- state_store: ``TieredStateStore`` holds tensor trees (the fp32
             optimizer state) as TieredArrays and executes replanner
             deltas as real block re-placements recorded in the ledger
"""
from .arbiter import (ArbiterDecision, OBJECTIVES, PhaseDemand,
                      PhaseDemandTable, TenantDemand, TierBudgetArbiter)
from .ledger import (LedgerCounters, LedgerError, ResidencyLedger, Tenant,
                     UNBOUNDED)
from .movesched import MoveRound, MoveScheduler, ScheduledMove
from .state_store import TieredStateStore

__all__ = [
    "LedgerCounters", "LedgerError", "ResidencyLedger", "Tenant",
    "UNBOUNDED",
    "OBJECTIVES", "ArbiterDecision", "PhaseDemand", "PhaseDemandTable",
    "TenantDemand", "TierBudgetArbiter",
    "MoveRound", "MoveScheduler", "ScheduledMove",
    "TieredStateStore",
]
