"""The sharded multi-host serving plane (counterpart of
``repro.cluster``).

``Namespace`` (hierarchical ``replica/tenant/obj`` ledger keys) is
imported eagerly — it is dependency-free and the pool/obs planes key on
it.  The heavier members (replica meshes, the session router, the
cluster plane) load lazily so ``repro_torch.pool`` can import the
namespace module without dragging the serving stack into every ledger
user.
"""
from __future__ import annotations

from .namespace import (
    DEFAULT_REPLICA,
    is_pattern,
    Namespace,
    reset_bare_key_warning,
)

__all__ = [
    "AxisMapping",
    "ClusterPlane",
    "ClusterReport",
    "DEFAULT_REPLICA",
    "Namespace",
    "Replica",
    "ReplicaView",
    "SessionRequest",
    "SessionRouter",
    "axis_mapping",
    "current_axis_mapping",
    "is_pattern",
    "replica_meshes",
    "replica_shard_map",
    "reset_bare_key_warning",
    "shard_lm_params",
]

_LAZY = {
    "AxisMapping": "sharding",
    "axis_mapping": "sharding",
    "current_axis_mapping": "sharding",
    "replica_meshes": "sharding",
    "replica_shard_map": "sharding",
    "shard_lm_params": "sharding",
    "Replica": "replica",
    "ClusterPlane": "plane",
    "ClusterReport": "plane",
    "ReplicaView": "router",
    "SessionRequest": "router",
    "SessionRouter": "router",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
