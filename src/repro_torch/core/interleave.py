"""Interleaving orchestration: policy -> concrete TieredArray placements
(counterpart of ``repro.core.interleave``).

Bridges the analytic layer (objects/policies/costmodel) and the tensor
layer (tiered_array): given a tree of tensors with object metadata, plan
with a policy and realize per-leaf block placements, with the Sec. III
stream-assignment used to size the block granularity.

Leaves are visited in the reference's order (dict keys sorted, sequences
by index) and named as it names them, ``"/".join(key or index)`` (e.g.
``units/layers/0/attn/wq``), so both packages derive the same objects from the
same tree; torch's pytree keeps dict insertion order, so the paths it
returns are sorted here.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch.utils._pytree as pytree

from .objects import DataObject
from .policies import PlacementPlan, Policy, WeightedInterleave
from .tiered_array import DeviceLike, TIER_TO_MEMORY_KIND, TieredArray
from .tiers import assign_streams, MemoryTier


def _path_part(p):
    return getattr(p, "key", getattr(p, "idx", p))


def _named_leaves(tree) -> List[Tuple[str, object]]:
    """(name, leaf) pairs in the reference's leaf order."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    flat.sort(key=lambda pl: tuple(_path_part(p) for p in pl[0]))
    return [("/".join(str(_path_part(p)) for p in path), leaf)
            for path, leaf in flat]


def objects_from_pytree(tree, traffic_fn=None,
                        group: str = "params") -> List[DataObject]:
    """Derive DataObjects from tree leaves (tensors or numpy arrays).

    traffic_fn(name, leaf) -> (read_bytes, write_bytes, random_fraction);
    default: one streaming read per step (weights-like).
    """
    objs = []
    for name, leaf in _named_leaves(tree):
        nbytes = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        if traffic_fn is None:
            r, w, rf = nbytes, 0, 0.0
        else:
            r, w, rf = traffic_fn(name, leaf)
        objs.append(DataObject(name, nbytes, r, w, rf, group=group))
    return objs


def realize_plan(tree, plan: PlacementPlan,
                 block_rows: Optional[int] = 64, *,
                 device: DeviceLike = None) -> Dict[str, TieredArray]:
    """Place each tree leaf according to the plan's shares."""
    out: Dict[str, TieredArray] = {}
    for name, leaf in _named_leaves(tree):
        shares = plan.shares.get(name, [("HBM", 1.0)])
        n_kinds = len({TIER_TO_MEMORY_KIND.get(t, "device")
                       for t, _ in shares})
        br = block_rows if n_kinds > 1 else None
        out[name] = TieredArray.from_plan(leaf, shares, block_rows=br,
                                          device=device)
    return out


def plan_and_place(tree, policy: Policy, tiers: Mapping[str, MemoryTier],
                   traffic_fn=None, block_rows: Optional[int] = 64, *,
                   device: DeviceLike = None
                   ) -> Tuple[PlacementPlan, Dict[str, TieredArray]]:
    objs = objects_from_pytree(tree, traffic_fn)
    plan = policy.plan(objs, tiers)
    return plan, realize_plan(tree, plan, block_rows, device=device)


def recommend_streams(tiers: Mapping[str, MemoryTier],
                      total_streams: int = 32) -> Dict[str, int]:
    """Sec. III bandwidth packing: DMA streams per tier (the 6/23/23 trick)."""
    alloc, _ = assign_streams(tiers, total_streams)
    return alloc


# ---------------------------------------------------------------------- #
# Distance-weighted interleaving (Linux weighted-interleave analogue).    #
# ---------------------------------------------------------------------- #
def distance_weights(topology, tiers: Mapping[str, MemoryTier],
                     origin: Optional[str] = None,
                     tier_set: Optional[Sequence[str]] = None
                     ) -> Dict[str, float]:
    """Per-tier interleave weights ∝ path-capped bandwidth from ``origin``.

    ``topology`` is a topology graph (``tier_weights(tiers, origin)``); a
    tier reached through a UPI hop weighs in at the hop's bottleneck
    bandwidth, not its DIMM bandwidth.  NVMe-class tiers are excluded by
    the graph.
    """
    w = topology.tier_weights(tiers, origin)
    if tier_set is not None:
        w = {t: w[t] for t in tier_set if t in w}
        total = sum(w.values())
        if total <= 0:
            raise ValueError(f"tier_set {list(tier_set)} has no "
                             "interleavable bandwidth")
        w = {t: v / total for t, v in w.items()}
    return w


def distance_weighted_policy(topology, tiers: Mapping[str, MemoryTier],
                             origin: Optional[str] = None,
                             tier_set: Optional[Sequence[str]] = None,
                             name: Optional[str] = None
                             ) -> WeightedInterleave:
    """A ``WeightedInterleave`` whose weights come from the topology:
    equal capacity, but per-node shares follow ``path_bw_GBps`` so the
    slowest-reachable node no longer gates the aggregate (the Sec. V
    uniform-interleave failure mode)."""
    w = distance_weights(topology, tiers, origin, tier_set)
    return WeightedInterleave(
        w, name=name or f"distance_weighted[{topology.name}]")
