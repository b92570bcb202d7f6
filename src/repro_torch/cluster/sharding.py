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
tests run on one CPU device.  A mesh may list one physical device
several times (logical devices), as the reference's CI forces several
host devices onto one CPU.

:func:`shard_lm_params` places an LM param tree on a mesh: each leaf
becomes a ``models.shardings.ShardedTensor`` (the counterpart of a
``jax.Array`` with a ``NamedSharding``), split where the mapping routes
its logical axis to a mesh axis that divides it; the model reads a
split leaf through the helpers there.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..launch.mesh import cuda_devices, Mesh
from ..models.shardings import PartitionSpec, ShardedTensor, shard_tensor

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
    """Partition ``devices`` (every CUDA device by default; entries may
    repeat a device) into ``n_replicas`` 1-D meshes.

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


# ---------------------------------------------------------------------- #
# placement                                                               #
# ---------------------------------------------------------------------- #
def _leaf_logical_axes(path: Tuple[str, ...],
                       ndim: int) -> List[Optional[str]]:
    """Logical axis names for an LM param leaf, by its tree path (the
    reference's rule).  ``embed``/``lm_head`` are (vocab, d_model); MoE
    leaves name dim 1 of a unit-stacked leaf (dim 0 otherwise)
    ``experts``.  So does the stacked router (U, D, E), whose dim 1 is
    d_model: placed as the reference places it, and gathered whole
    before the router product."""
    axes: List[Optional[str]] = [None] * ndim
    if path and path[-1] in ("embed", "lm_head") and ndim >= 1:
        axes[0] = "vocab"
    if "moe" in path and ndim >= 2:
        axes[1 if "units" in path else 0] = "experts"
    return axes


def _map(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_lm_params(params, mesh: Mesh,
                    mapping: Optional[AxisMapping] = None):
    """Place an LM param tree on ``mesh`` under the axis mapping (the
    active one by default).

    Every tensor leaf becomes a :class:`ShardedTensor`: dims whose
    logical axis the mapping routes to a mesh axis are partitioned
    *when evenly divisible* (otherwise replicated, as the reference
    does: a 50k vocab on a 3-device mesh should not crash serving), all
    other dims replicated.  With the default empty mapping this is pure
    replication.  A leaf already on the mesh's devices is not copied."""
    mapping = mapping or current_axis_mapping()
    sizes = dict(mesh.shape)

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = []
        for dim, logical in zip(leaf.shape,
                                _leaf_logical_axes(path, leaf.ndim)):
            phys = mapping.physical(logical) if logical else None
            ok = phys in sizes and dim % sizes[phys] == 0
            spec.append(phys if ok else None)
        return shard_tensor(leaf, mesh, PartitionSpec(*spec))

    return _map(place, params)


def replica_shard_map(fn, mesh: Mesh, in_specs, out_specs,
                      check_rep: bool = False):
    """``shard_map`` over a replica mesh: the returned function runs
    ``fn`` once per mesh device on that device's blocks of its
    arguments and assembles each output from the devices' outputs as a
    :class:`ShardedTensor` on the mesh.  ``in_specs``: one
    ``PartitionSpec`` (or None: passed as it is) per argument, or one
    spec for a function of one argument; ``out_specs``: one spec, or a
    tuple of them for a tuple output.  ``check_rep`` is the reference's
    option and is not read."""
    specs = (in_specs,) if in_specs is None or isinstance(
        in_specs, PartitionSpec) else tuple(in_specs)

    def place(a, spec):
        if spec is None or isinstance(a, ShardedTensor) or \
                not isinstance(a, torch.Tensor):
            return a
        return shard_tensor(a, mesh, spec)

    def mapped(*args):
        if len(args) != len(specs):
            raise ValueError(f"{len(args)} arguments for {len(specs)} "
                             "in_specs")
        placed = [place(a, s) for a, s in zip(args, specs)]
        outs = [fn(*(a.shards[i] if isinstance(a, ShardedTensor) else a
                     for a in placed)) for i in range(mesh.size)]
        single = not isinstance(outs[0], tuple)
        ospecs = (out_specs,) if single else tuple(out_specs)
        res = []
        for j, ospec in enumerate(ospecs):
            locs = [o if single else o[j] for o in outs]
            st = ShardedTensor(locs[0].shape, ospec, mesh, locs)
            st.shape = torch.Size(n * st.parts(d)
                                  for d, n in enumerate(locs[0].shape))
            res.append(st)
        return res[0] if single else tuple(res)
    return mapped
