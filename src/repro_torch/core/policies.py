"""PyTorch-port copy of ``repro.core.policies`` (framework-free).

Placement policies: preferred / first-touch / uniform interleave / OLI.

A policy maps a list of DataObjects onto tiers, producing a PlacementPlan:
for each object, a list of (tier_name, fraction) shares.  Fractions are
block-granular when realized by `tiered_array.TieredArray`; here they are
exact rationals of the object's footprint.

The paper's policies (§V, §VI):

* ``TierPreferred(fast)``  — numactl --preferred analogue: fill `fast` until
  capacity, spill to the next-closest tier (NUMA-distance order).
* ``FirstTouch``           — allocation-order placement into the fastest tier
  with room (Linux default without numactl).
* ``UniformInterleave``    — Linux round-robin page interleave across a tier
  set: every object spread proportional to nothing — equal page shares.
* ``WeightedInterleave``   — Linux weighted-interleave analogue: per-node
  shares from explicit weights (usually topology path bandwidth; see
  ``interleave.distance_weighted_policy``).
* ``ObjectLevelInterleave``— THE PAPER'S CONTRIBUTION (§V-B): objects passing
  the two selection criteria (≥10% footprint, access-intensive, not
  latency-sensitive) are interleaved across fast+slow with *bandwidth-
  proportional* shares; everything else is fast-preferred.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .objects import DataObject, select_interleave_candidates
from .tiers import GiB, MemoryTier


Share = Tuple[str, float]  # (tier name, fraction of object)


@dataclasses.dataclass
class PlacementPlan:
    """Result of planning: object name -> shares; plus bookkeeping."""

    shares: Dict[str, List[Share]]
    policy: str
    # bytes placed per tier (for capacity accounting / reporting)
    tier_bytes: Dict[str, int]

    def fraction_on(self, obj_name: str, tier: str) -> float:
        return sum(f for t, f in self.shares.get(obj_name, []) if t == tier)

    def fast_bytes(self, fast: str) -> int:
        return self.tier_bytes.get(fast, 0)


def _tier_order(tiers: Mapping[str, MemoryTier]) -> List[str]:
    """Tiers ordered by NUMA distance (unloaded latency)."""
    return sorted(tiers, key=lambda k: tiers[k].unloaded_latency_ns
                  + tiers[k].hop_latency_ns)


class Policy:
    name = "base"

    def plan(self, objs: Sequence[DataObject],
             tiers: Mapping[str, MemoryTier]) -> PlacementPlan:
        raise NotImplementedError


class TierPreferred(Policy):
    """Fill `preferred` first; on exhaustion spill in NUMA-distance order.

    Matches the paper's 'LDRAM preferred' / 'CXL preferred' runs.  Objects
    are placed in the order given (allocation order), which is exactly why
    the paper finds 'LDRAM preferred' fragile when fast memory is scarce
    (OLI observation 2 reason 1: latency-sensitive objects allocated late
    end up on CXL).
    """

    def __init__(self, preferred: str):
        self.preferred = preferred
        self.name = f"{preferred}_preferred"

    def plan(self, objs, tiers):
        order = [self.preferred] + [t for t in _tier_order(tiers)
                                    if t != self.preferred]
        free = {k: int(tiers[k].capacity_GiB * GiB) for k in tiers}
        shares: Dict[str, List[Share]] = {}
        placed = {k: 0 for k in tiers}
        for o in objs:
            remaining = o.nbytes
            sh: List[Share] = []
            for t in order:
                if remaining <= 0:
                    break
                take = min(remaining, free[t])
                if take > 0:
                    sh.append((t, take / max(o.nbytes, 1)))
                    free[t] -= take
                    placed[t] += take
                    remaining -= take
            if remaining > 0:  # out of memory everywhere: overflow slowest
                t = order[-1]
                sh.append((t, remaining / max(o.nbytes, 1)))
                placed[t] += remaining
            shares[o.name] = sh
        return PlacementPlan(shares, self.name, placed)


class FirstTouch(TierPreferred):
    """Linux default: first touch = local node preferred, allocation order."""

    def __init__(self, fast: str):
        super().__init__(fast)
        self.name = "first_touch"


class UniformInterleave(Policy):
    """Linux round-robin interleave across `tier_set` (equal page shares),
    subject to capacity (a full tier drops out of the rotation, like the
    kernel's interleave falling back when a node is exhausted)."""

    def __init__(self, tier_set: Sequence[str], name: str = None):
        self.tier_set = list(tier_set)
        self.name = name or ("uniform_interleave[" + "+".join(tier_set) + "]")

    def plan(self, objs, tiers):
        free = {k: int(tiers[k].capacity_GiB * GiB) for k in self.tier_set}
        shares: Dict[str, List[Share]] = {}
        placed = {k: 0 for k in tiers}
        for o in objs:
            live = [t for t in self.tier_set if free[t] > 0]
            if not live:
                live = [self.tier_set[-1]]
            per = o.nbytes // len(live)
            sh = []
            for t in live:
                take = min(per, max(free[t], 0)) if free[t] > 0 else per
                sh.append((t, take / max(o.nbytes, 1)))
                free[t] -= take
                placed[t] += take
            # distribute rounding remainder to first live tier
            rem = o.nbytes - sum(int(f * o.nbytes) for _, f in sh)
            if rem > 0:
                t = live[0]
                sh[0] = (t, sh[0][1] + rem / max(o.nbytes, 1))
                placed[t] += rem
            shares[o.name] = sh
        return PlacementPlan(shares, self.name, placed)


class WeightedInterleave(Policy):
    """Linux weighted-interleave analogue: per-node page shares set by
    explicit weights instead of round-robin.

    The kernel's ``/sys/kernel/mm/mempolicy/weighted_interleave`` knobs
    expect an operator to type in per-node weights; here they usually
    come from the topology (``interleave.distance_weighted_policy``
    sets them ∝ each tier's path-capped bandwidth from the compute
    origin), which is what makes interleaving stop *undermining*
    performance when one node is a 38 GB/s far-socket CXL card next to
    a 460 GB/s LDRAM (Sec. V takeaway).
    """

    def __init__(self, weights: Mapping[str, float],
                 name: Optional[str] = None):
        w = {t: float(v) for t, v in weights.items() if v > 0}
        if not w:
            raise ValueError("weighted interleave needs positive weights")
        total = sum(w.values())
        self.weights = {t: v / total for t, v in w.items()}
        self.name = name or ("weighted_interleave[" + "+".join(
            f"{t}:{v:.2f}" for t, v in sorted(self.weights.items())) + "]")

    def plan(self, objs, tiers):
        names = [t for t in self.weights if t in tiers]
        if not names:
            raise ValueError("no weighted tiers present in tier set")
        free = {t: int(tiers[t].capacity_GiB * GiB) for t in names}
        shares: Dict[str, List[Share]] = {}
        placed = {k: 0 for k in tiers}
        for o in objs:
            live = [t for t in names if free[t] > 0]
            if not live:           # everything full: overflow heaviest
                live = [max(names, key=lambda t: self.weights[t])]
            wsum = sum(self.weights[t] for t in live)
            taken: Dict[str, int] = {}
            for t in live:
                want = int(o.nbytes * self.weights[t] / wsum)
                taken[t] = min(want, max(free[t], 0)) if free[t] > 0 \
                    else want
            rem = o.nbytes - sum(taken.values())
            # spill the rounding/capacity remainder by descending weight
            for t in sorted(live, key=lambda t: -self.weights[t]):
                if rem <= 0:
                    break
                extra = min(rem, max(free[t] - taken[t], 0))
                taken[t] += extra
                rem -= extra
            if rem > 0:            # over capacity everywhere: heaviest
                taken[max(live, key=lambda t: self.weights[t])] += rem
            sh = []
            for t, b in taken.items():
                if b <= 0:
                    continue
                sh.append((t, b / max(o.nbytes, 1)))
                free[t] -= b
                placed[t] += b
            shares[o.name] = sh
        return PlacementPlan(shares, self.name, placed)


class ObjectLevelInterleave(Policy):
    """The paper's §V-B object-level interleaving (OLI).

    * Selection: footprint ≥ `footprint_threshold` of total AND access-
      intensive AND not latency-sensitive/pinned (criteria verbatim from the
      paper, plus the latency-sensitivity exclusion its §V-A observation 3
      motivates).
    * Selected objects: interleaved across `fast` + `slow_set` with shares
      **proportional to each tier's achievable bandwidth** (beyond-paper
      refinement; the paper interleaves uniformly across the chosen nodes —
      set ``bandwidth_weighted=False`` for the faithful variant).
    * Everything else: `fast`-preferred.
    """

    def __init__(self, fast: str, slow_set: Sequence[str],
                 footprint_threshold: float = 0.10,
                 bandwidth_weighted: bool = False,
                 fast_reserve_fraction: float = 0.0):
        self.fast = fast
        self.slow_set = list(slow_set)
        self.footprint_threshold = footprint_threshold
        self.bandwidth_weighted = bandwidth_weighted
        self.fast_reserve_fraction = fast_reserve_fraction
        self.name = ("oli_bw" if bandwidth_weighted else "oli") + \
            f"[{fast}+{'+'.join(self.slow_set)}]"

    def _weights(self, tiers) -> Dict[str, float]:
        names = [self.fast] + self.slow_set
        if not self.bandwidth_weighted:
            return {t: 1.0 / len(names) for t in names}
        bows = {t: tiers[t].bandwidth(tiers[t].saturation_streams * 2)
                for t in names}
        s = sum(bows.values())
        return {t: b / s for t, b in bows.items()}

    def plan(self, objs, tiers):
        cand = {o.name for o in select_interleave_candidates(
            list(objs), self.footprint_threshold)}
        free = {k: int(tiers[k].capacity_GiB * GiB) for k in tiers}
        # reserve part of fast tier for the latency-sensitive residue
        reserve = int(free[self.fast] * self.fast_reserve_fraction)
        free[self.fast] -= reserve
        shares: Dict[str, List[Share]] = {}
        placed = {k: 0 for k in tiers}
        w = self._weights(tiers)
        order = _tier_order(tiers)

        # pass 1: latency-sensitive + pinned objects go fast-preferred FIRST
        # (fixes the allocation-order fragility of LDRAM-preferred).
        def place_preferred(o: DataObject):
            remaining = o.nbytes
            sh = []
            for t in [self.fast] + [x for x in order if x != self.fast]:
                if remaining <= 0:
                    break
                take = min(remaining, max(free[t], 0))
                if take > 0:
                    sh.append((t, take / max(o.nbytes, 1)))
                    free[t] -= take
                    placed[t] += take
                    remaining -= take
            if remaining > 0:
                t = order[-1]
                sh.append((t, remaining / max(o.nbytes, 1)))
                placed[t] += remaining
            shares[o.name] = sh

        for o in objs:
            if o.name not in cand and (o.pin_fast or o.latency_sensitive):
                place_preferred(o)
        free[self.fast] += reserve  # release reserve for remaining objects

        # pass 2: interleave the selected bandwidth-hungry objects
        for o in objs:
            if o.name in cand:
                sh = []
                for t, frac in w.items():
                    take = min(int(o.nbytes * frac), max(free[t], 0))
                    sh.append((t, take / max(o.nbytes, 1)))
                    free[t] -= take
                    placed[t] += take
                got = sum(f for _, f in sh)
                if got < 1.0 - 1e-9:  # spill remainder in NUMA order
                    rem = int(o.nbytes * (1.0 - got))
                    for t in order:
                        if rem <= 0:
                            break
                        take = min(rem, max(free[t], 0))
                        if take > 0:
                            sh.append((t, take / max(o.nbytes, 1)))
                            free[t] -= take
                            placed[t] += take
                            rem -= take
                    if rem > 0:
                        sh.append((order[-1], rem / max(o.nbytes, 1)))
                        placed[order[-1]] += rem
                shares[o.name] = sh

        # pass 3: everything else, fast-preferred
        for o in objs:
            if o.name not in shares:
                place_preferred(o)
        return PlacementPlan(shares, self.name, placed)


def make_policy(spec: str, tiers: Mapping[str, MemoryTier],
                fast: Optional[str] = None) -> Policy:
    """Policy factory from a CLI-ish string spec."""
    fast = fast or _tier_order(tiers)[0]
    slow = [t for t in tiers if t != fast and tiers[t].kind != "nvme"]
    if spec == "preferred":
        return TierPreferred(fast)
    if spec.startswith("preferred:"):
        return TierPreferred(spec.split(":", 1)[1])
    if spec == "first_touch":
        return FirstTouch(fast)
    if spec == "uniform":
        return UniformInterleave([fast] + slow)
    if spec.startswith("uniform:"):
        return UniformInterleave(spec.split(":", 1)[1].split("+"))
    if spec.startswith("weighted:"):   # weighted:LDRAM=3+CXL=1
        pairs = [kv.split("=") for kv in spec.split(":", 1)[1].split("+")]
        return WeightedInterleave({k: float(v) for k, v in pairs})
    if spec == "oli":
        return ObjectLevelInterleave(fast, slow)
    if spec == "oli_bw":
        return ObjectLevelInterleave(fast, slow, bandwidth_weighted=True)
    raise ValueError(f"unknown policy spec {spec!r}")
