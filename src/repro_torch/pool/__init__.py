"""Residency ledger (copy of ``repro.pool.ledger``)."""
from .ledger import LedgerCounters, LedgerError, ResidencyLedger, Tenant

__all__ = ["LedgerCounters", "LedgerError", "ResidencyLedger", "Tenant"]
