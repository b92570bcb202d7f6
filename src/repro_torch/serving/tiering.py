"""PyTorch-port copy of ``repro.serving.tiering``.

Online KV-block tiering: core.migration policies driving the pool.

The paper's §VI runtimes (AutoNUMA / Tiering-0.8 / TPP) decide page
promotion from observed hint faults; "Dissecting CXL Memory Performance
at Scale" makes the same point for serving — placement must follow
observed access heat.  Here the *policy classes from core.migration are
reused verbatim*: each scheduler iteration is one epoch, a decode read
of a slow-tier block is a hint fault, and the chosen policy's
``promote_set`` picks which touched slow blocks to promote.  Capacity
pressure on the fast tier is resolved the way MigrationSim does —
demote the coldest fast blocks first — except the demotions act on the
*real* pool (tensor copies between memory kinds), not a simulation.

``policy="static"`` (NoBalance) is the baseline: whatever split the
allocator chose stays put, exactly the statically-split KV shares the
one-shot engine uses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..core import migration as mig
from ..obs.trace import hot_span, TraceRecorder
from .kv_pool import FAST_KIND, KVBlock, PagedKVPool

POLICIES = ("static", "autonuma", "tiering08", "tpp")


def make_tiering_policy(name: str) -> mig.MigrationPolicy:
    name = name.lower()
    if name in ("static", "none", "no_balance"):
        return mig.NoBalance()
    if name == "autonuma":
        return mig.AutoNUMA()
    if name == "tiering08":
        return mig.Tiering08()
    if name == "tpp":
        return mig.TPP()
    raise ValueError(f"unknown tiering policy {name!r}; "
                     f"choose from {POLICIES}")


@dataclasses.dataclass
class TieringStats:
    epochs: int = 0
    hint_faults: int = 0
    promoted: int = 0
    demoted: int = 0
    migrated_bytes: int = 0
    denied_promotions: int = 0   # fast tier full, no cold victim

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class KVBlockTierer:
    """Promotion/demotion loop over a PagedKVPool.

    One ``step`` per scheduler iteration: the pool's heat counters are
    mirrored into core.migration ``Block`` shadows (the policies operate
    on that dataclass), the policy nominates promotions among touched
    slow-tier blocks, and capacity pressure demotes the coldest
    fast-tier blocks of *non-running* sequences first.

    ``spans``: the recorder each epoch's span ``engine.tier_epoch``
    goes into (the engine's tracer while its hot-path spans are on).
    """

    def __init__(self, pool: PagedKVPool, policy: str = "tiering08",
                 slow_kind: Optional[str] = None):
        self.pool = pool
        self.policy = make_tiering_policy(policy)
        self.policy_name = self.policy.name
        self.slow_kind = slow_kind or pool.slow_kind
        self.stats = TieringStats()
        self._mig_stats = mig.MigrationStats()
        # shadow core.migration blocks, keyed by pool block id
        self._shadow: Dict[int, mig.Block] = {}
        self.spans: Optional[TraceRecorder] = None

    # ------------------------------------------------------------------ #
    def _shadow_of(self, b: KVBlock) -> mig.Block:
        s = self._shadow.get(b.bid)
        if s is None or s.obj != f"seq{b.seq_id}":
            s = mig.Block(obj=f"seq{b.seq_id}", idx=b.bid,
                          nbytes=self.pool.block_nbytes(), tier=b.kind)
            self._shadow[b.bid] = s
        s.tier = b.kind
        s.last_touch_epoch = b.last_touch_step
        s.touch_count = b.touch_count
        return s

    def _demote_for(self, need_blocks: int, epoch: int,
                    protect: Sequence[int]) -> int:
        """Demote the coldest fast blocks until ``need_blocks`` fit.

        ``protect`` holds block ids that must not be demoted this epoch
        (the promotion candidates themselves).  Returns #demoted.
        """
        pool = self.pool
        headroom = pool.fast_block_budget - pool.fast_used()
        if headroom >= need_blocks:
            return 0
        protect_set = set(protect)
        victims = mig.coldest_first(
            [b for b in pool.blocks
             if not b.free and b.kind == FAST_KIND
             and b.bid not in protect_set],
            last_touch=lambda b: b.last_touch_step,
            touches=lambda b: b.touch_count)
        demoted = 0
        for v in victims:
            if headroom + demoted >= need_blocks:
                break
            if pool.migrate(v.bid, self.slow_kind):
                demoted += 1
        return demoted

    # ------------------------------------------------------------------ #
    def step(self, touched_seq_ids: Sequence[int], epoch: int) -> int:
        """Run one tiering epoch; returns #blocks promoted.

        ``touched_seq_ids``: sequences whose blocks decode read this
        iteration (the pool's heat counters were already bumped by
        ``touch_seq``).
        """
        with hot_span(self.spans, "engine.tier_epoch", epoch=epoch):
            return self._epoch(touched_seq_ids, epoch)

    def _epoch(self, touched_seq_ids: Sequence[int], epoch: int) -> int:
        pool = self.pool
        self.stats.epochs += 1
        if isinstance(self.policy, mig.NoBalance):
            return 0

        # hint faults: touched blocks resident on a slow kind
        touched_slow: List[mig.Block] = []
        candidates: Dict[int, KVBlock] = {}
        for sid in touched_seq_ids:
            for b in pool.seq_blocks(sid):
                if b.kind != FAST_KIND:
                    touched_slow.append(self._shadow_of(b))
                    candidates[b.bid] = b
        faults_before = self._mig_stats.hint_faults
        promote = self.policy.promote_set(touched_slow, epoch,
                                          self._mig_stats)
        self.stats.hint_faults += self._mig_stats.hint_faults - faults_before

        promoted = 0
        if promote:
            want = [s.idx for s in promote]
            self._demote_for(len(want), epoch, protect=want)
            for bid in want:
                if pool.fast_used() >= pool.fast_block_budget:
                    self.stats.denied_promotions += len(want) - promoted
                    break
                if pool.migrate(bid, FAST_KIND):
                    promoted += 1
        self.stats.promoted = pool.counters.promoted
        self.stats.demoted = pool.counters.demoted
        self.stats.migrated_bytes = pool.counters.migrated_bytes
        return promoted

    # ------------------------------------------------------------------ #
    def profiling_overhead_s(self) -> float:
        """Per-fault CPU cost, as core.migration charges it (PMO 2)."""
        return self.stats.hint_faults * self.policy.fault_cost_s
