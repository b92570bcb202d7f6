"""Hierarchical tenant keys (copy of ``repro.cluster.namespace``)."""
from .namespace import is_pattern, Namespace

__all__ = ["is_pattern", "Namespace"]
