"""Multi-tenant residency ledger and tier arbitration (counterpart of
``repro.pool``; copies):

- ledger:    ``ResidencyLedger``, the single source of truth for
             bytes-per-tier-per-tenant
- arbiter:   ``TierBudgetArbiter`` splits the fast tier across tenant
             namespaces from measured (or predicted) per-tenant demand
- movesched: ``MoveScheduler`` batches every tenant's placement deltas
             per round, coalesces them, and orders them
             priority-weighted over the links their paths share

``TieredStateStore`` (adaptive training state) is not ported yet.
"""
from .arbiter import (ArbiterDecision, OBJECTIVES, PhaseDemand,
                      PhaseDemandTable, TenantDemand, TierBudgetArbiter)
from .ledger import (LedgerCounters, LedgerError, ResidencyLedger, Tenant,
                     UNBOUNDED)
from .movesched import MoveRound, MoveScheduler, ScheduledMove

__all__ = [
    "LedgerCounters", "LedgerError", "ResidencyLedger", "Tenant",
    "UNBOUNDED",
    "OBJECTIVES", "ArbiterDecision", "PhaseDemand", "PhaseDemandTable",
    "TenantDemand", "TierBudgetArbiter",
    "MoveRound", "MoveScheduler", "ScheduledMove",
]
