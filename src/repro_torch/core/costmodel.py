"""PyTorch-port copy of ``repro.core.costmodel`` (framework-free).

Analytic step-time cost model over a PlacementPlan.

Evaluates what the paper measures: given data objects, their per-step
traffic, and a placement plan, estimate per-step memory time per tier and
the end-to-end step time.  Used by:

  * the OLI planner's policy comparison (benchmarks/oli_hpc.py → Figs 13-15),
  * the FlexGen-style serving policy search (offload/serve_engine.py),
  * the ZeRO-Offload train-time breakdown (benchmarks/zero_offload_train.py).

Model (deliberately simple, mirrors the paper's reasoning):
  - streaming traffic to tier T takes bytes / bandwidth(streams_T);
  - random traffic pays loaded-latency per cache line, amortized over
    concurrent misses;
  - tiers serve in parallel (each has its own controller/queue), so total
    memory time = max over tiers (bandwidth-bound composition), PLUS a
    serial latency term for dependent (pointer-chasing) access chains;
  - compute can overlap memory up to `compute_time_s`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .objects import DataObject
from .policies import PlacementPlan, Policy
from .tiers import GB, MemoryTier


@dataclasses.dataclass
class StepCost:
    """Decomposed per-step cost (seconds)."""

    per_tier_time: Dict[str, float]
    latency_serial_s: float
    compute_s: float
    phased_s: float = 0.0   # sum over object phases of max-tier time
    # per shared interconnect link (topology mode): traffic crossing one
    # link serializes on it even when the endpoint tiers are independent
    link_time: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def memory_s(self) -> float:
        base = max(self.per_tier_time.values()) if self.per_tier_time \
            else 0.0
        if self.link_time:
            base = max(base, max(self.link_time.values()))
        return max(base, self.phased_s) + self.latency_serial_s

    @property
    def step_s(self) -> float:
        # memory and compute overlap; the longer one gates the step
        return max(self.memory_s, self.compute_s) + 0.15 * min(
            self.memory_s, self.compute_s)  # imperfect overlap tax

    @property
    def bound(self) -> str:
        return "memory" if self.memory_s >= self.compute_s else "compute"


def plan_step_cost(objs: Sequence[DataObject], plan: PlacementPlan,
                   tiers: Mapping[str, MemoryTier],
                   total_streams: int = 32,
                   compute_time_s: float = 0.0,
                   topology=None, origin: Optional[str] = None,
                   calibrator=None) -> StepCost:
    """Evaluate a placement plan with PHASED access semantics.

    HPC sweeps touch objects in phases (one array at a time), so the step
    time is the SUM over objects of each object's access time; within one
    object's phase the tiers holding its pages serve in parallel (gated by
    the slowest share — this is why uniform 50/50 interleave with a slow
    CXL card undermines performance, Sec. V takeaway), and random accesses
    pay loaded latency per cache line with `total_streams` outstanding
    misses (CG-style latency sensitivity).

    With a ``topology`` (a ``repro.topology.TopologyGraph``) the tiers
    are first distance-adjusted as seen from ``origin`` (path latency,
    bottleneck bandwidth), and traffic is additionally charged against
    every interconnect link it crosses: tiers behind one UPI/PCIe hop
    *interfere* instead of serving in parallel, within an object's
    phase and across the step.

    With a ``calibrator`` (``repro.obs.calibrate.CostModelCalibrator``)
    the tier descriptors and the graph's link parameters are replaced
    by their probe-fitted / online-corrected versions first, so the
    step price reflects measured hardware instead of builder defaults.
    """
    if calibrator is not None:
        tiers, topology = calibrator.calibrated_view(tiers, topology)
    tier_links = {}
    if topology is not None:
        tiers = topology.effective_tiers(tiers, origin)
        tier_links = {t: topology.tier_links(t, origin) for t in tiers}
    per_tier_time: Dict[str, float] = {k: 0.0 for k in tiers}
    link_time: Dict[str, float] = {}
    lat_serial = 0.0
    phased_total = 0.0
    any_traffic = False
    for o in objs:
        if o.bytes_per_step <= 0:
            continue
        any_traffic = True
        phase_t = 0.0
        phase_link_t: Dict[str, float] = {}
        for t, frac in plan.shares.get(o.name, []):
            tier = tiers[t]
            b = o.bytes_per_step * frac
            if b <= 0:
                continue
            streams = max(1.0, min(float(total_streams),
                                   tier.saturation_streams * 1.5))
            bw = tier.bandwidth(streams) * GB
            t_stream = (b * (1.0 - o.random_fraction)) / bw
            lat_ns = tier.loaded_latency(tier.bandwidth(streams) * 0.6)
            t_rand = (b * o.random_fraction / 64.0) * (lat_ns * 1e-9) \
                / total_streams
            share_t = t_stream + t_rand
            per_tier_time[t] += share_t
            phase_t = max(phase_t, share_t)
            for link in tier_links.get(t, ()):
                key = f"{link.key[0]}--{link.key[1]}"
                lt = b / (link.bw_GBps * GB)
                link_time[key] = link_time.get(key, 0.0) + lt
                phase_link_t[key] = phase_link_t.get(key, 0.0) + lt
            # truly serial pointer-chase slice of the random misses:
            # indirect-index chains have limited MLP, so ~2% of misses
            # serialize on the loaded latency — this is what makes random
            # access on CXL catastrophic (HPC observation 3 / CG).
            lat_serial += (b * o.random_fraction / 64.0) * (
                lat_ns * 1e-9) * 0.02
        if phase_link_t:
            phase_t = max(phase_t, max(phase_link_t.values()))
        phased_total += phase_t

    if not any_traffic:
        return StepCost({k: 0.0 for k in tiers}, 0.0, compute_time_s)
    return StepCost(per_tier_time, lat_serial, compute_time_s,
                    phased_s=phased_total, link_time=link_time)


def compare_policies(objs: Sequence[DataObject],
                     policies: Sequence[Policy],
                     tiers: Mapping[str, MemoryTier],
                     total_streams: int = 32,
                     compute_time_s: float = 0.0,
                     topology=None, origin: Optional[str] = None
                     ) -> Dict[str, StepCost]:
    out = {}
    for p in policies:
        plan = p.plan(objs, tiers)
        out[p.name] = plan_step_cost(objs, plan, tiers, total_streams,
                                     compute_time_s, topology=topology,
                                     origin=origin)
    return out


# ---------------------------------------------------------------------- #
# FlexGen-style placement search (§IV-B): choose per-object tier fractions
# to maximize throughput under capacity constraints.  The paper uses an LP;
# our decision space is small enough for exact search over a fraction grid,
# which is LP-equivalent here (piecewise-linear objective) and dependency-
# free.                                                                    #
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class SearchResult:
    fractions: Dict[str, Dict[str, float]]  # obj -> tier -> fraction
    step_s: float
    plan: PlacementPlan


def policy_search(objs: Sequence[DataObject],
                  tiers: Mapping[str, MemoryTier],
                  fast: str,
                  grid: int = 10,
                  total_streams: int = 32,
                  compute_time_s: float = 0.0,
                  topology=None, origin: Optional[str] = None,
                  calibrator=None) -> SearchResult:
    """Grid search over fast-tier fractions per movable object.

    Mirrors FlexGen's cost-model-driven search: for each non-pinned object,
    try fast-fractions k/grid; spill the remainder across slow tiers in
    NUMA-distance order.  Objective: minimize modeled step time subject to
    capacities.  Complexity grid^n_movable — we cap movable objects at 4 by
    taking the largest (everything else fast-preferred), matching FlexGen's
    weights/KV/activation granularity.

    With a ``topology``, spill order and candidate costing both use the
    distance-adjusted (path-aware) view from ``origin`` — a far-socket
    CXL card spills *after* remote DRAM, and plans that route traffic
    over a shared hop are priced with that hop's serialization.

    A ``calibrator`` swaps both the tiers and the graph for their
    measured-corrected versions before the search, so the chosen plan
    optimizes real numbers (capacities stay the builder's — calibration
    corrects speeds, not sizes).
    """
    from .policies import _tier_order  # local import to avoid cycle

    if calibrator is not None:
        tiers, topology = calibrator.calibrated_view(tiers, topology)
    search_tiers = (topology.effective_tiers(tiers, origin)
                    if topology is not None else tiers)
    order = _tier_order(search_tiers)
    slow_order = [t for t in order if t != fast]
    movable = sorted([o for o in objs if not o.pin_fast],
                     key=lambda o: o.nbytes, reverse=True)[:4]
    fixed = [o for o in objs if o not in movable]
    cap = {k: int(tiers[k].capacity_GiB * (1024**3)) for k in tiers}

    best: Optional[SearchResult] = None
    fracs = [i / grid for i in range(grid + 1)]
    for combo in itertools.product(fracs, repeat=len(movable)):
        free = dict(cap)
        shares: Dict[str, List[Tuple[str, float]]] = {}
        placed = {k: 0 for k in tiers}
        feasible = True

        def put(o: DataObject, fast_frac: float) -> bool:
            nonlocal feasible
            sh = []
            fb = int(o.nbytes * fast_frac)
            if fb > free[fast]:
                return False
            if fb:
                sh.append((fast, fast_frac))
                free[fast] -= fb
                placed[fast] += fb
            rem = o.nbytes - fb
            for t in slow_order:
                if rem <= 0:
                    break
                take = min(rem, free[t])
                if take > 0:
                    sh.append((t, take / max(o.nbytes, 1)))
                    free[t] -= take
                    placed[t] += take
                    rem -= take
            if rem > 0:
                return False
            shares[o.name] = sh
            return True

        for o in fixed:  # pinned/fixed objects first, fully fast
            if not put(o, 1.0):
                feasible = False
                break
        if feasible:
            for o, f in zip(movable, combo):
                if not put(o, f):
                    feasible = False
                    break
        if not feasible:
            continue
        plan = PlacementPlan(shares, "search", placed)
        cost = plan_step_cost(objs, plan, tiers, total_streams,
                              compute_time_s, topology=topology,
                              origin=origin)
        if best is None or cost.step_s < best.step_s:
            best = SearchResult(
                {o.name: dict(shares[o.name]) for o in movable},
                cost.step_s, plan)
    if best is None:
        raise RuntimeError("no feasible placement (capacity too small)")
    return best
