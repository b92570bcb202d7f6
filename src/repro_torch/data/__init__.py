"""Deterministic synthetic token pipeline (a copy of the reference's
``repro.data``, numpy only)."""
from .pipeline import (batch_for_step, DataConfig, DataIterator,
                       global_batch_for_step)

__all__ = [
    "batch_for_step", "DataConfig", "DataIterator",
    "global_batch_for_step",
]
