"""Dynamic memory-tiering runtimes (§VI): AutoNUMA / Tiering-0.8 / TPP analogues.

The paper studies hint-fault-driven page migration between fast and slow
tiers and finds (PMO 1-5) that: no single policy wins; Tiering-0.8's
throttling + adaptive promotion threshold wins under first-touch; migration
integrates badly with interleaving (interleaved pages live in unmigratable
regions → hint faults vanish); and migration can *hurt* OLI.

We reproduce that dynamics at block granularity.  A `MigrationSim` holds a
set of blocks with per-tier residency and replays an access trace (block
touch counts per epoch).  Policies decide promotions/demotions per epoch:

  * ``AutoNUMA``    — promote any block touched this epoch (hint fault) with
    probability ∝ sampling rate; no throttle; demote coldest on pressure.
  * ``Tiering08``   — promote only blocks whose re-touch interval < adaptive
    threshold; migration-rate throttle (pages/epoch cap); threshold adapts
    to keep promotion traffic near the target (the patch's dynamic knob).
  * ``TPP``         — promote on touch if block is on the (simulated) active
    LRU list (touched in the previous epoch too); aggressive, higher
    profiling overhead per hint fault.

Faithful quirk (PMO 3): blocks whose placement came from *interleaving* are
flagged `unmigratable` and never produce hint faults — matching the kernel
behaviour the paper uncovered.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .tiers import GB, MemoryTier

# Per-page kernel cost of a migration (unmap, copy setup, TLB shootdown) —
# the stall that makes migration hurt OLI by up to -88% in the paper (PMO 4).
PAGE_BYTES = 4096
PAGE_COST_S = 1.5e-6
# Object-level moves go through huge mappings (THP-sized), so the replanner's
# executor defaults to 2 MiB pages instead of base pages.
HUGE_PAGE_BYTES = 2 * 1024**2


def migration_time_s(nbytes: int, tier: MemoryTier, streams: float = 4.0,
                     page_bytes: int = PAGE_BYTES,
                     page_cost_s: float = PAGE_COST_S) -> float:
    """Time to move `nbytes` through `tier` (bandwidth + per-page kernel work).

    The charging MigrationSim applies per epoch, factored out so the
    telemetry replanner and the serving tierer price moves identically.
    """
    if nbytes <= 0:
        return 0.0
    return (nbytes / (tier.bandwidth(streams) * GB)
            + (nbytes / page_bytes) * page_cost_s)


def coldest_first(blocks: Sequence, last_touch: Callable,
                  touches: Optional[Callable] = None) -> List:
    """Victim order for capacity pressure: least-recently-touched first.

    Shared by MigrationSim's demotion loop and serving.KVBlockTierer;
    accessors bridge the two block dataclasses (last_touch_epoch vs
    last_touch_step)."""
    if touches is None:
        return sorted(blocks, key=last_touch)
    return sorted(blocks, key=lambda b: (last_touch(b), touches(b)))


@dataclasses.dataclass
class Block:
    obj: str
    idx: int
    nbytes: int
    tier: str
    unmigratable: bool = False  # interleaved placement => no hint faults
    last_touch_epoch: int = -(10**9)
    touch_count: int = 0


@dataclasses.dataclass
class MigrationStats:
    hint_faults: int = 0
    promoted: int = 0
    demoted: int = 0
    migrated_bytes: int = 0
    profiling_overhead_s: float = 0.0


class MigrationPolicy:
    name = "no_balance"
    # per-hint-fault CPU cost (s); TPP pays more (paper PMO 2: profiling
    # overhead differentiates the policies).
    fault_cost_s = 2e-6

    def promote_set(self, touched: Sequence[Block], epoch: int,
                    stats: MigrationStats) -> List[Block]:
        return []


class NoBalance(MigrationPolicy):
    name = "no_balance"


class AutoNUMA(MigrationPolicy):
    """Default Linux numa_balancing=1: promote on hint fault, no throttle."""

    name = "autonuma"
    fault_cost_s = 2e-6

    def promote_set(self, touched, epoch, stats):
        stats.hint_faults += len(touched)
        return list(touched)


class Tiering08(MigrationPolicy):
    """Linux tiering-0.8 patch: recency (re-fault interval) + adaptive
    threshold + migration throttle.  59x fewer hint faults than TPP in the
    paper because only slow-tier candidate pages are sampled."""

    name = "tiering08"
    fault_cost_s = 1.5e-6

    def __init__(self, throttle_blocks: int = 64,
                 target_promotions: int = 32):
        self.threshold_epochs = 2
        self.throttle_blocks = throttle_blocks
        self.target = target_promotions

    def promote_set(self, touched, epoch, stats):
        # rate-limited scanning: sample a strided slice of touched blocks,
        # capped per epoch (this is where the paper's 59x hint-fault
        # reduction vs TPP comes from)
        sampled = touched[::3][: self.target]
        stats.hint_faults += len(sampled)
        hot = [b for b in sampled
               if epoch - b.last_touch_epoch <= self.threshold_epochs]
        hot = hot[: self.throttle_blocks]
        # adapt threshold toward the promotion target
        if len(hot) > self.target:
            self.threshold_epochs = max(1, self.threshold_epochs - 1)
        elif len(hot) < self.target // 2:
            self.threshold_epochs = min(8, self.threshold_epochs + 1)
        return hot


class TPP(MigrationPolicy):
    """Meta's TPP: promote on touch if on active list (touched last epoch);
    every touch is a hint fault -> large profiling overhead (PMO 2)."""

    name = "tpp"
    fault_cost_s = 4e-6

    def promote_set(self, touched, epoch, stats):
        stats.hint_faults += len(touched)
        return [b for b in touched if epoch - b.last_touch_epoch <= 1]


@dataclasses.dataclass
class SimResult:
    exec_time_s: float
    stats: MigrationStats
    fast_hit_fraction: float


class MigrationSim:
    """Replays an access trace over blocks under a migration policy.

    access_trace: per epoch, a dict {block_id: touches}.  Block ids are
    (obj, idx).  Execution time per epoch = time to serve the touched bytes
    from their current tiers (parallel-tier composition, as costmodel) plus
    migration traffic plus per-fault profiling overhead.
    """

    def __init__(self, blocks: Sequence[Block],
                 tiers: Mapping[str, MemoryTier], fast: str,
                 policy: MigrationPolicy,
                 fast_capacity_bytes: Optional[int] = None,
                 slow_tier: Optional[str] = None):
        self.blocks = {(b.obj, b.idx): b for b in blocks}
        self.tiers = dict(tiers)
        self.fast = fast
        self.policy = policy
        cap = (fast_capacity_bytes if fast_capacity_bytes is not None
               else int(tiers[fast].capacity_GiB * (1024**3)))
        self.fast_capacity = cap
        # demotion target: the slow tier blocks actually came from (CXL in
        # the paper's two-tier setup), not an arbitrary other node
        if slow_tier is None:
            slow_counts: Dict[str, int] = {}
            for b in blocks:
                if b.tier != fast:
                    slow_counts[b.tier] = slow_counts.get(b.tier, 0) + 1
            slow_tier = max(slow_counts, key=slow_counts.get) \
                if slow_counts else fast
        self.slow_tier = slow_tier
        self.stats = MigrationStats()

    def _fast_usage(self) -> int:
        return sum(b.nbytes for b in self.blocks.values()
                   if b.tier == self.fast)

    def run(self, access_trace: Sequence[Mapping[Tuple[str, int], int]],
            streams: int = 32) -> SimResult:
        total_time = 0.0
        fast_bytes_served = 0
        total_bytes_served = 0

        for epoch, trace in enumerate(access_trace):
            # --- serve accesses from current residency --------------------
            per_tier = {t: 0.0 for t in self.tiers}
            for bid, touches in trace.items():
                b = self.blocks[bid]
                served = b.nbytes * touches
                per_tier[b.tier] += served
                total_bytes_served += served
                if b.tier == self.fast:
                    fast_bytes_served += served
            epoch_t = 0.0
            for t, by in per_tier.items():
                if by > 0:
                    bw = self.tiers[t].bandwidth(
                        min(streams, self.tiers[t].saturation_streams * 1.5)
                    ) * GB
                    epoch_t = max(epoch_t, by / bw)

            # --- hint faults & promotion decision -------------------------
            touched_slow = [self.blocks[bid] for bid in trace
                            if self.blocks[bid].tier != self.fast
                            and not self.blocks[bid].unmigratable]
            promoted = self.policy.promote_set(touched_slow, epoch,
                                               self.stats)
            # capacity pressure: demote coldest fast blocks to make room
            mig_bytes = 0
            for b in promoted:
                need = b.nbytes
                usage = self._fast_usage()
                if usage + need > self.fast_capacity:
                    victims = coldest_first(
                        [v for v in self.blocks.values()
                         if v.tier == self.fast and not v.unmigratable],
                        last_touch=lambda v: v.last_touch_epoch)
                    freed = 0
                    for v in victims:
                        if usage + need - freed <= self.fast_capacity:
                            break
                        v.tier = self.slow_tier
                        freed += v.nbytes
                        mig_bytes += v.nbytes
                        self.stats.demoted += 1
                    if usage + need - freed > self.fast_capacity:
                        continue  # cannot promote
                b.tier = self.fast
                mig_bytes += b.nbytes
                self.stats.promoted += 1

            # --- update recency AFTER decisions (re-fault interval) -------
            for bid, touches in trace.items():
                b = self.blocks[bid]
                b.last_touch_epoch = epoch
                b.touch_count += touches

            # migration traffic rides the slow tier's bandwidth, and each
            # migrated 4 KiB page pays ~1.5us of kernel work (unmap, copy
            # setup, TLB shootdown) — this stall is why the paper sees up
            # to -88% from migration under OLI (PMO 4).
            if mig_bytes:
                epoch_t += migration_time_s(mig_bytes,
                                            self.tiers[self.slow_tier])
            epoch_t += (self.stats.hint_faults * self.policy.fault_cost_s
                        ) / max(epoch + 1, 1) * 0.1
            self.stats.migrated_bytes += mig_bytes
            total_time += epoch_t

        self.stats.profiling_overhead_s = (
            self.stats.hint_faults * self.policy.fault_cost_s)
        total_time += self.stats.profiling_overhead_s
        frac = fast_bytes_served / max(total_bytes_served, 1)
        return SimResult(total_time, self.stats, frac)


# ---------------------------------------------------------------------- #
# Trace generators matching the paper's §VI workload taxonomy.            #
# ---------------------------------------------------------------------- #
def make_blocks_from_plan(plan_shares: Mapping[str, List[Tuple[str, float]]],
                          obj_bytes: Mapping[str, int],
                          block_bytes: int = 64 * 1024**2,
                          interleaved_objs: Sequence[str] = ()
                          ) -> List[Block]:
    """Blocks with initial residency from a PlacementPlan's shares.

    Blocks of objects placed by *interleaving* are marked unmigratable
    (PMO 3: interleaved pages never fault).
    """
    blocks: List[Block] = []
    for obj, shares in plan_shares.items():
        total = obj_bytes[obj]
        n = max(1, total // block_bytes)
        # expand shares into per-block tier assignment round-robin
        tier_seq: List[str] = []
        for t, frac in shares:
            tier_seq.extend([t] * max(1, int(round(frac * n))))
        interleaved = obj in interleaved_objs and len(
            {t for t, _ in shares}) > 1
        for i in range(n):
            tier = tier_seq[i % len(tier_seq)] if tier_seq else shares[0][0]
            blocks.append(Block(obj, i, total // n, tier,
                                unmigratable=interleaved))
    return blocks


def trace_stable_hotset(block_ids: Sequence[Tuple[str, int]], epochs: int,
                        hot_fraction: float = 0.1, seed: int = 0
                        ) -> List[Dict[Tuple[str, int], int]]:
    """PageRank-like: small, stable hot set (first-touch wins, PMO 1)."""
    rng = np.random.default_rng(seed)
    ids = list(block_ids)
    hot = ids[: max(1, int(len(ids) * hot_fraction))]
    out = []
    for _ in range(epochs):
        tr = {b: 8 for b in hot}
        for b in rng.choice(len(ids), size=max(1, len(ids) // 20),
                            replace=False):
            tr[ids[int(b)]] = tr.get(ids[int(b)], 0) + 1
        out.append(tr)
    return out


def trace_scattered_hotset(block_ids: Sequence[Tuple[str, int]], epochs: int,
                           hot_fraction: float = 0.2, seed: int = 0,
                           drift: float = 0.3
                           ) -> List[Dict[Tuple[str, int], int]]:
    """Graph500-like: scattered hot set drifting across tiers (interleave+
    migration wins)."""
    rng = np.random.default_rng(seed)
    ids = list(block_ids)
    k = max(1, int(len(ids) * hot_fraction))
    hot = set(rng.choice(len(ids), size=k, replace=False).tolist())
    out = []
    for _ in range(epochs):
        tr = {ids[i]: 4 for i in hot}
        out.append(tr)
        moved = set(rng.choice(len(ids), size=max(1, int(k * drift)),
                               replace=False).tolist())
        hot = set(list(hot)[: k - len(moved)]) | moved
    return out


def trace_uniform(block_ids: Sequence[Tuple[str, int]], epochs: int,
                  seed: int = 0) -> List[Dict[Tuple[str, int], int]]:
    """FT/SP-like: uniformly touched working set (migration only hurts)."""
    return [{b: 2 for b in block_ids} for _ in range(epochs)]


# ---------------------------------------------------------------------- #
# Reusable placement-delta executor.                                      #
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class BlockMove:
    """One object-level byte move between tiers."""

    obj: str
    src: str
    dst: str
    nbytes: int


@dataclasses.dataclass
class PlacementDelta:
    """The byte moves that turn one placement into another."""

    moves: List[BlockMove]

    @property
    def total_bytes(self) -> int:
        return sum(m.nbytes for m in self.moves)

    def bytes_into(self, tier: str) -> int:
        return sum(m.nbytes for m in self.moves if m.dst == tier)

    def bytes_out_of(self, tier: str) -> int:
        return sum(m.nbytes for m in self.moves if m.src == tier)


class MigrationExecutor:
    """Computes, prices, and applies placement deltas between plans.

    Extracted from the move/price mechanics MigrationSim and
    serving.KVBlockTierer each grew privately, so the telemetry
    replanner, the KV pool, and the simulators share one executor:

      * ``delta(old, new, nbytes)``  — per-object byte moves between two
        ``PlacementPlan.shares``-style mappings (greedy surplus->deficit
        matching; objects absent from either side produce no moves —
        allocation is not migration);
      * ``cost_s(delta)``            — migration_time_s charging, each
        move priced at the *slower* endpoint tier (the copy rides the
        slow link, exactly how MigrationSim charges demotions); with a
        ``topology`` the move is priced over its actual path — every
        per-page setup pays the path's round-trip latency, and moves
        whose paths cross one link (or endpoint tier) *serialize* on it
        while moves on disjoint paths proceed in parallel;
      * ``execute(delta)``           — applies moves through ``move_fn``
        (e.g. PagedKVPool.migrate, or a TieredArray re-place); without
        one it only accounts.  ``move_fn(obj, src, dst, nbytes)`` returns
        the bytes actually moved (capacity may deny part of a move); the
        per-move outcome is kept in ``last_moves`` so a planner can feed
        the *realized* placement back into its next costing pass.
    """

    def __init__(self, tiers: Mapping[str, MemoryTier],
                 streams: float = 4.0,
                 page_bytes: int = HUGE_PAGE_BYTES,
                 page_cost_s: float = PAGE_COST_S,
                 move_fn: Optional[Callable[[str, str, str, int], int]]
                 = None,
                 topology=None):
        self.tiers = dict(tiers)
        self.streams = streams
        self.page_bytes = page_bytes
        self.page_cost_s = page_cost_s
        self.move_fn = move_fn
        self.topology = topology   # repro.topology.TopologyGraph or None
        self.tracer = None         # optional repro.obs.TraceRecorder
        self.audit = None          # optional repro.obs.PredictionLedger
        self.calibrator = None     # optional obs.CostModelCalibrator
        # True when move_fn performs real transfers whose wall time is
        # comparable to the model's seconds (e.g. TieredStateStore's
        # device_put re-placements) — gates wall-clock audit joins and
        # the online calibration feed; bookkeeping move_fns leave it off
        self.physical_moves = False
        # the un-calibrated parameters recalibrate() corrects from
        self._base_tiers = dict(tiers)
        self._base_topology = topology
        self._executions = 0
        self.stats = MigrationStats()
        # (move, bytes actually moved) for the most recent execute()
        self.last_moves: List[Tuple[BlockMove, int]] = []

    def recalibrate(self) -> None:
        """Swap pricing parameters for the calibrator's corrected view.

        Idempotent and cheap; the owner calls it after a probe fit or
        whenever online scales moved (e.g. each replan epoch), so
        ``cost_s`` / ``move_cost_s`` / fluid schedules price with
        measured numbers.  Without a calibrator it is a no-op."""
        if self.calibrator is None:
            return
        self.tiers, self.topology = self.calibrator.calibrated_view(
            self._base_tiers, self._base_topology)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _tier_bytes(shares: Sequence[Tuple[str, float]],
                    total: int) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for t, frac in shares:
            out[t] = out.get(t, 0) + int(round(frac * total))
        return out

    def delta(self, old_shares: Mapping[str, Sequence[Tuple[str, float]]],
              new_shares: Mapping[str, Sequence[Tuple[str, float]]],
              nbytes_by_obj: Mapping[str, int]) -> PlacementDelta:
        moves: List[BlockMove] = []
        for obj, total in nbytes_by_obj.items():
            if obj not in old_shares or obj not in new_shares:
                continue
            old = self._tier_bytes(old_shares[obj], total)
            new = self._tier_bytes(new_shares[obj], total)
            surplus = {t: old.get(t, 0) - new.get(t, 0)
                       for t in set(old) | set(new)
                       if old.get(t, 0) > new.get(t, 0)}
            deficit = {t: new.get(t, 0) - old.get(t, 0)
                       for t in set(old) | set(new)
                       if new.get(t, 0) > old.get(t, 0)}
            for src in sorted(surplus):
                for dst in sorted(deficit):
                    if surplus[src] <= 0:
                        break
                    take = min(surplus[src], deficit[dst])
                    if take > 0:
                        moves.append(BlockMove(obj, src, dst, take))
                        surplus[src] -= take
                        deficit[dst] -= take
        return PlacementDelta(moves)

    def _slow_endpoint(self, move: BlockMove) -> MemoryTier:
        src, dst = self.tiers.get(move.src), self.tiers.get(move.dst)
        if src is None or dst is None:
            return src or dst
        return src if (src.bandwidth(self.streams)
                       <= dst.bandwidth(self.streams)) else dst

    def cost_s(self, delta: PlacementDelta) -> float:
        if self.topology is None:
            total = 0.0
            for m in delta.moves:
                tier = self._slow_endpoint(m)
                if tier is None:
                    continue
                total += migration_time_s(m.nbytes, tier, self.streams,
                                          self.page_bytes,
                                          self.page_cost_s)
            return total
        return self._path_cost_s(delta)

    def move_resource_times(self, m: BlockMove
                            ) -> Tuple[Dict[object, float], float]:
        """One move's per-resource occupancy seconds plus its fixed
        overhead (per-page kernel work + path round-trip latency).

        The building block ``cost_s`` and the cross-tenant
        ``pool.MoveScheduler`` both price with: a resource is an
        endpoint tier or a traversed link, moves sharing one serialize
        on it, moves on disjoint resources overlap.  Without a
        topology the single resource is the slower endpoint tier (the
        copy rides it), matching the flat-tier charging.
        """
        res_time: Dict[object, float] = {}
        if m.nbytes <= 0:
            return res_time, 0.0
        if self.topology is None:
            tier = self._slow_endpoint(m)
            if tier is None:
                return res_time, 0.0
            res_time[("tier", tier.name)] = \
                m.nbytes / (tier.bandwidth(self.streams) * GB)
            return res_time, (m.nbytes / self.page_bytes) * self.page_cost_s
        links = self.topology.tier_path(m.src, m.dst)
        pages = -(-m.nbytes // self.page_bytes)   # ceil
        lat_ns = sum(l.latency_ns for l in links)
        overhead = pages * (self.page_cost_s + 2.0 * lat_ns * 1e-9)
        for tname in (m.src, m.dst):
            tier = self.tiers.get(tname)
            if tier is None:
                continue
            bw = tier.bandwidth(self.streams) * GB
            key = ("tier", tname)
            res_time[key] = res_time.get(key, 0.0) + m.nbytes / bw
        for link in links:
            key = ("link", link.key)
            res_time[key] = res_time.get(key, 0.0) \
                + m.nbytes / (link.bw_GBps * GB)
        return res_time, overhead

    def move_resources(self, m: BlockMove) -> List[object]:
        """The resource keys one move occupies (for grouping/ordering)."""
        return list(self.move_resource_times(m)[0])

    def move_cost_s(self, m: BlockMove) -> float:
        """One move priced alone (bottleneck resource + overhead)."""
        if self.topology is None:
            tier = self._slow_endpoint(m)
            if tier is None or m.nbytes <= 0:
                return 0.0
            return migration_time_s(m.nbytes, tier, self.streams,
                                    self.page_bytes, self.page_cost_s)
        res_time, overhead = self.move_resource_times(m)
        return (max(res_time.values()) if res_time else 0.0) + overhead

    def _path_cost_s(self, delta: PlacementDelta) -> float:
        """Topology pricing: bandwidth charged per traversed resource
        (endpoint tiers + every link on the path), per-page kernel work
        plus the path's round-trip latency per page.  Resources compose
        like the cost model's tiers: moves sharing a resource serialize
        on it, disjoint moves overlap — so two promotions squeezing
        through one UPI hop take twice as long, while promotions into
        different sockets proceed concurrently."""
        res_time: Dict[object, float] = {}
        overhead = 0.0
        for m in delta.moves:
            r, oh = self.move_resource_times(m)
            overhead += oh
            for key, t in r.items():
                res_time[key] = res_time.get(key, 0.0) + t
        return (max(res_time.values()) if res_time else 0.0) + overhead

    def tier_rank(self) -> Dict[str, int]:
        """Tiers ranked fastest (0) to slowest — the promote/demote
        classification view.  Needs the *distance* view: with
        local-normalized tier descriptors the hop latency lives in the
        topology, and fast/slow would tie without it."""
        rank_tiers = (self.topology.effective_tiers(self.tiers)
                      if self.topology is not None else self.tiers)
        order = sorted(rank_tiers,
                       key=lambda k: (rank_tiers[k].unloaded_latency_ns
                                      + rank_tiers[k].hop_latency_ns,
                                      -rank_tiers[k].peak_bw_GBps))
        return {t: i for i, t in enumerate(order)}

    def execute(self, delta: PlacementDelta,
                stats: Optional[MigrationStats] = None) -> MigrationStats:
        stats = stats if stats is not None else self.stats
        rank = self.tier_rank()
        self.last_moves = []
        # audit the priced move time against the realized wall time —
        # only meaningful when move_fn performs real transfers
        audited = (self.audit is not None and self.physical_moves
                   and self.move_fn is not None and delta.moves)
        if audited:
            self._executions += 1
            key = self._executions
            predicted = self.cost_s(delta)
            self.audit.predict("migration.move_time", key, predicted,
                               moves=len(delta.moves),
                               nbytes=delta.total_bytes)
            t0 = time.perf_counter()
        for m in delta.moves:
            done = (self.move_fn(m.obj, m.src, m.dst, m.nbytes)
                    if self.move_fn is not None else m.nbytes)
            self.last_moves.append((m, max(int(done), 0)))
            if self.tracer is not None:
                self.tracer.event(
                    "migration.move", cat="migration", obj=m.obj,
                    src=m.src, dst=m.dst, nbytes=m.nbytes,
                    done_bytes=max(int(done), 0))
            if done <= 0:
                continue
            stats.migrated_bytes += int(done)
            if rank.get(m.dst, 0) < rank.get(m.src, 0):
                stats.promoted += 1
            elif rank.get(m.dst, 0) > rank.get(m.src, 0):
                stats.demoted += 1
        if audited:
            realized = time.perf_counter() - t0
            touched = sorted({t for m in delta.moves
                              for t in (m.src, m.dst)})
            self.audit.realize("migration.move_time", key, realized,
                               resources=touched)
            if self.calibrator is not None and predicted > 0.0:
                self.calibrator.observe_time_ratio(realized / predicted,
                                                   tiers=touched)
                self.recalibrate()
        return stats

    @staticmethod
    def realized_shares(
            old_shares: Mapping[str, Sequence[Tuple[str, float]]],
            moves_done: Sequence[Tuple[BlockMove, int]],
            nbytes_by_obj: Mapping[str, int]
    ) -> Dict[str, List[Tuple[str, float]]]:
        """The placement that actually resulted from a (possibly
        partially denied) execute: old residency plus the bytes each
        move really transferred.  Feeding this — not the intended plan —
        into the next costing pass keeps the planner honest when the
        fast-block budget rejects part of a delta."""
        out: Dict[str, List[Tuple[str, float]]] = {}
        done_by_obj: Dict[str, List[Tuple[BlockMove, int]]] = {}
        for m, done in moves_done:
            done_by_obj.setdefault(m.obj, []).append((m, done))
        for obj, shares in old_shares.items():
            total = int(nbytes_by_obj.get(obj, 0))
            if total <= 0:
                out[obj] = list(shares)
                continue
            tier_bytes = MigrationExecutor._tier_bytes(shares, total)
            for m, done in done_by_obj.get(obj, ()):
                moved = min(done, max(tier_bytes.get(m.src, 0), 0))
                if moved <= 0:
                    continue
                tier_bytes[m.src] -= moved
                tier_bytes[m.dst] = tier_bytes.get(m.dst, 0) + moved
            out[obj] = [(t, b / total) for t, b in tier_bytes.items()
                        if b > 0]
        return out
