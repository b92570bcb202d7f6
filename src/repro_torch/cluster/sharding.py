"""Named-axis placement for the multi-host serving plane (counterpart of
``repro.cluster.sharding``).

* **axis mapping**: model code names *logical* axes ("vocab",
  "experts"); a thread-local :class:`AxisMapping` resolves them to
  *physical* mesh axes at placement time, so the same model runs
  replicated, tensor-sharded or expert-sharded by swapping one context.
* **shard_map adapter**: :func:`replica_shard_map` runs a function over
  a replica mesh.

The meshes come from :func:`replica_meshes`, which partitions devices
into per-replica groups.  With fewer devices than replicas every
replica gets a one-device mesh sharing a device, as the reference's
tests run on one CPU device: the cluster plane runs its replicas so on
one card.  On a one-device mesh placement moves a tensor to that
device (or returns it as it is) and the adapter calls its function
directly; a mesh of more than one device raises naming
``launch.mesh.MULTI_DEVICE_ITEM``.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..launch.mesh import cuda_devices, Mesh, MULTI_DEVICE_ITEM
from ..models.shardings import PartitionSpec

__all__ = ["AxisMapping", "axis_mapping", "current_axis_mapping",
           "replica_meshes", "replica_shard_map", "shard_lm_params"]

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class AxisMapping:
    """Logical-axis -> physical-mesh-axis resolution table.

    ``mapping["vocab"] == "model"`` means "partition logical axis
    *vocab* over mesh axis *model*"; a logical axis absent from the
    table (or mapped to None) is replicated.  Immutable so it can be
    stacked on the thread-local context without aliasing surprises.
    """

    mapping: Mapping[str, Optional[str]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "mapping", dict(self.mapping))

    def physical(self, logical: str) -> Optional[str]:
        return self.mapping.get(logical)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """PartitionSpec for a leaf whose dims carry these logical
        names (None = unnamed dim, always replicated)."""
        return PartitionSpec(*(self.physical(ax) if ax else None
                               for ax in logical))

    def merged(self, other: "AxisMapping") -> "AxisMapping":
        out = dict(self.mapping)
        out.update(other.mapping)
        return AxisMapping(out)


# replicate-everything default: capacity (tiering), not FLOPs, binds
# serving in the paper
_DEFAULT = AxisMapping({})
_tls = threading.local()


def current_axis_mapping() -> AxisMapping:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else _DEFAULT


@contextmanager
def axis_mapping(mapping: "AxisMapping | Mapping[str, Optional[str]]"):
    """Install an axis mapping for the dynamic extent.  Nested contexts
    merge (inner wins per logical axis)."""
    if not isinstance(mapping, AxisMapping):
        mapping = AxisMapping(mapping)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    merged = (stack[-1].merged(mapping) if stack else
              _DEFAULT.merged(mapping))
    stack.append(merged)
    try:
        yield merged
    finally:
        stack.pop()


def replica_meshes(n_replicas: int, axis_name: str = MODEL_AXIS,
                   devices: Optional[Sequence] = None) -> List[Mesh]:
    """Partition ``devices`` (every CUDA device by default) into
    ``n_replicas`` 1-D meshes.

    With ``d`` devices and ``n`` replicas each mesh gets ``d // n``
    devices (remainder unused, keeping replicas symmetric).  With fewer
    devices than replicas, replicas *share* devices round-robin:
    one-device meshes.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    devs = [torch.device(d) for d in devices] if devices is not None \
        else cuda_devices()
    per = len(devs) // n_replicas
    meshes = []
    for r in range(n_replicas):
        if per >= 1:
            group = devs[r * per:(r + 1) * per]
        else:
            group = [devs[r % len(devs)]]
        grid = np.empty(len(group), dtype=object)
        grid[:] = group
        meshes.append(Mesh(grid, (axis_name,)))
    return meshes


def _one_device(mesh: Mesh, what: str) -> torch.device:
    if mesh.size != 1:
        raise NotImplementedError(
            f"{what} over a mesh of {mesh.size} devices "
            f"{dict(mesh.shape)}: {MULTI_DEVICE_ITEM}")
    return mesh.device


def _map(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_lm_params(params, mesh: Mesh,
                    mapping: Optional[AxisMapping] = None):
    """Place an LM param tree on ``mesh`` under the axis mapping.

    The reference partitions a dim whose logical axis (``vocab``,
    ``experts``) the mapping routes to a mesh axis.  On a one-device
    mesh every axis has size 1, so every leaf stays whole on that
    device, whatever the mapping: a leaf already there is returned as
    it is (replicas sharing a card share its weights), any other is
    moved there.  A mesh of more than one device raises
    (``MULTI_DEVICE_ITEM``)."""
    dev = _one_device(mesh, "shard_lm_params")

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return leaf if leaf.device == dev else leaf.to(dev)

    return _map(place, params)


def replica_shard_map(fn, mesh: Mesh, in_specs, out_specs,
                      check_rep: bool = False):
    """``fn`` over a replica mesh: on a one-device mesh every spec keeps
    whole tensors on that device, so this is ``fn`` itself.  A mesh of
    more than one device raises (``MULTI_DEVICE_ITEM``)."""
    _one_device(mesh, "replica_shard_map")
    return fn
