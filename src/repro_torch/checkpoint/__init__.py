"""Atomic, checksummed checkpoints of tensor trees (counterpart of
``repro.checkpoint``), in the reference's on-disk format."""
from .store import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
