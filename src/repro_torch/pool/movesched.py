"""PyTorch-port copy of ``repro.pool.movesched`` (framework-free).

MoveScheduler: cross-tenant migration batching over shared links.

"CXL-Interference" shows the failure mode this module closes: tenants
that execute their placement deltas *independently* contend on the
bottleneck UPI/CXL links their moves share — the ``MigrationExecutor``
already prices that serialization per delta, but nothing orders moves
*across* tenants, so every tenant pays as if it owned the link.  The
scheduler collects all tenants' ``PlacementDelta``s for one round and:

  1. **coalesces** — within each submitted delta, same-direction
     moves of one object merge, and opposing moves (A->B queued
     together with B->A) net out before any byte is copied (netting
     is per-submission: objects are tenant-namespaced, and a
     replanner defers at most one apply per round, so cross-submission
     opposition does not arise);
  2. **groups by bottleneck resource** — each move's occupied
     resources (endpoint tiers + every link on its ``TopologyGraph``
     path) come from ``MigrationExecutor.move_resource_times``;
  3. **orders** — priority-weighted (the ledger's tenant weights),
     with capacity-*freeing* moves (demotions out of the contended
     fast tier) ahead of promotions at equal priority so a physical
     client's promote is not denied for space a queued demote is
     about to release;
  4. **schedules** — fluid list schedule: in order, each move's
     traffic queues behind the earlier moves' traffic on every
     resource it crosses, so moves sharing a bottleneck serialize
     while moves on disjoint resources overlap.  The round's
     ``makespan_s`` is what the batch actually costs; its
     ``independent_s`` is what the same moves cost executed
     per-tenant with no coordination (the sum the bench compares
     against);
  5. **executes** — in scheduled order through each submission's
     ``move_fn`` (the tenant's physical client), crediting per-tenant
     ``MigrationStats`` and invoking each submission's completion
     callback with the realized ``(move, done_bytes)`` list so a
     deferring ``AdaptiveReplanner`` adopts the residency that really
     resulted;
  6. **preempts** — a submission whose ``submit`` lands *mid-round*
     (reentrantly, from a client's ``move_fn``) with strictly higher
     priority than the move about to execute interrupts the round:
     its moves are priced and spliced ahead of everything remaining,
     and the interrupted tenant's copy resumes afterwards.  Long
     low-priority copies yield at block granularity — per queued
     ``BlockMove``, or finer when the submitter opted into
     ``chunk_bytes`` splitting (declaring its ``move_fn`` safe to
     call with partial byte counts).  ``movesched.preemptions``
     counts the interruptions; each emits a ``movesched.preempt``
     trace event.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..core.migration import (BlockMove, MigrationExecutor, MigrationStats,
                              PlacementDelta)
from .ledger import ResidencyLedger


@dataclasses.dataclass
class ScheduledMove:
    """One move with its placement in the round's schedule."""

    tenant: str
    move: BlockMove
    priority: float
    resources: List[object]
    cost_s: float                  # priced alone (bottleneck + overhead)
    start_s: float = 0.0
    finish_s: float = 0.0
    done_bytes: int = 0
    orig_move: Optional[BlockMove] = None  # pre-chunking move (if split)


@dataclasses.dataclass
class MoveRound:
    """One flush: the ordered schedule and its makespan accounting."""

    epoch: int
    moves: List[ScheduledMove]
    makespan_s: float              # batched, link-aware schedule
    independent_s: float           # per-tenant uncoordinated execution
    coalesced_bytes: int           # bytes netted away before copying

    @property
    def saved_s(self) -> float:
        return max(self.independent_s - self.makespan_s, 0.0)

    def tenant_finish_s(self, tenant: str) -> float:
        """When the tenant's last move completes (0.0 if it had none)."""
        return max((m.finish_s for m in self.moves if m.tenant == tenant),
                   default=0.0)

    def moved_bytes(self, tenant: Optional[str] = None) -> int:
        return sum(m.done_bytes for m in self.moves
                   if tenant is None or m.tenant == tenant)


@dataclasses.dataclass
class _Submission:
    tenant: str
    delta: PlacementDelta
    move_fn: Optional[Callable[[str, str, str, int], int]]
    priority: float
    on_done: Optional[Callable[[List[Tuple[BlockMove, int]]], None]]
    stats: Optional[MigrationStats]
    order: int                     # submission sequence (stable ties)
    chunk_bytes: Optional[int] = None  # split long copies (opt-in)


class MoveScheduler:
    """Collects tenants' deltas per round and executes them as one
    ordered, link-aware batch through the shared executor."""

    def __init__(self, executor: MigrationExecutor,
                 ledger: Optional[ResidencyLedger] = None,
                 tracer=None):
        self.executor = executor
        self.ledger = ledger
        self.tracer = tracer           # optional repro.obs.TraceRecorder
        self.audit = None              # optional obs.PredictionLedger
        self.calibrator = None         # optional obs.CostModelCalibrator
        self.rounds: List[MoveRound] = []
        self.preemptions = 0           # mid-round higher-priority splices
        self._pending: List[_Submission] = []
        self._rounds_audited = 0
        self._order_seq = 0

    # ------------------------------------------------------------------ #
    @property
    def pending_moves(self) -> int:
        return sum(len(s.delta.moves) for s in self._pending)

    @property
    def has_pending(self) -> bool:
        """Any submission queued for the next flush (even move-less
        ones, whose ``on_done`` must still fire)."""
        return bool(self._pending)

    def submit(self, tenant: str, delta: PlacementDelta,
               move_fn: Optional[Callable] = None,
               priority: Optional[float] = None,
               on_done: Optional[Callable] = None,
               stats: Optional[MigrationStats] = None,
               chunk_bytes: Optional[int] = None) -> None:
        """Queue one tenant's delta for the next ``flush``.

        ``priority`` defaults to the tenant's ledger weight (1.0 when
        neither is known); ``move_fn`` is the tenant's physical client
        hook (None = accounting only); ``on_done`` receives the
        realized ``[(BlockMove, done_bytes)]`` list after execution.
        ``chunk_bytes`` opts this tenant's long copies into sub-block
        splitting — extra preemption points mid-copy — and asserts its
        ``move_fn`` accepts partial byte counts for one object.

        Submitting from inside a ``move_fn`` while a round executes is
        legal: a strictly-higher-priority delta preempts the round
        (see ``flush``), anything else waits for the next one.
        """
        if priority is None:
            info = self.ledger.tenant_info(tenant) \
                if self.ledger is not None else None
            priority = info.weight if info is not None else 1.0
        self._pending.append(_Submission(
            tenant, delta, move_fn, float(priority), on_done, stats,
            self._order_seq,
            int(chunk_bytes) if chunk_bytes else None))
        self._order_seq += 1

    # ------------------------------------------------------------------ #
    @staticmethod
    def _coalesce(delta: PlacementDelta) -> Tuple[List[BlockMove], int]:
        """Merge same-direction moves and net opposing ones within one
        submission; returns (moves, bytes netted away)."""
        directed: Dict[Tuple[str, str, str], int] = {}
        for m in delta.moves:
            if m.nbytes <= 0 or m.src == m.dst:
                continue
            key = (m.obj, m.src, m.dst)
            directed[key] = directed.get(key, 0) + m.nbytes
        out: List[BlockMove] = []
        netted = 0
        seen = set()
        for key in sorted(directed):
            if key in seen:
                continue
            obj, src, dst = key
            rkey = (obj, dst, src)
            seen.add(key)
            seen.add(rkey)
            fwd, rev = directed[key], directed.get(rkey, 0)
            netted += 2 * min(fwd, rev)
            if fwd > rev:
                out.append(BlockMove(obj, src, dst, fwd - rev))
            elif rev > fwd:
                out.append(BlockMove(obj, dst, src, rev - fwd))
        return out, netted

    def _is_demotion(self, m: BlockMove, rank: Dict[str, int]) -> bool:
        return rank.get(m.dst, 0) > rank.get(m.src, 0)

    def _build_sms(self, sub: _Submission) -> Tuple[List[ScheduledMove],
                                                    int]:
        """Coalesce one submission and price its scheduled moves,
        splitting long copies into ``chunk_bytes`` pieces when the
        tenant opted in (each piece is a preemption point)."""
        ex = self.executor
        moves, netted = self._coalesce(sub.delta)
        sms: List[ScheduledMove] = []
        for m in moves:
            pieces = [m]
            if sub.chunk_bytes and m.nbytes > sub.chunk_bytes:
                pieces = []
                left = m.nbytes
                while left > 0:
                    nb = min(left, sub.chunk_bytes)
                    pieces.append(BlockMove(m.obj, m.src, m.dst, nb))
                    left -= nb
            for p in pieces:
                sms.append(ScheduledMove(sub.tenant, p, sub.priority,
                                         ex.move_resources(p),
                                         ex.move_cost_s(p), orig_move=m))
        return sms, netted

    def _fluid(self, scheduled: List[ScheduledMove]) -> float:
        """Fluid list schedule: each move's traffic queues behind all
        earlier-scheduled traffic on every resource it occupies."""
        busy: Dict[object, float] = {}
        makespan = 0.0
        for sm in scheduled:
            res_time, overhead = self.executor.move_resource_times(sm.move)
            start = max((busy.get(r, 0.0) for r in res_time), default=0.0)
            finish = start + overhead
            for r, t in res_time.items():
                busy[r] = max(busy.get(r, 0.0), start) + t
                finish = max(finish, busy[r] + overhead)
            sm.start_s = start
            sm.finish_s = finish
            makespan = max(makespan, finish)
        return makespan

    def flush(self, epoch: int = 0) -> MoveRound:
        """Coalesce, order, schedule, and execute everything pending.

        Submissions landing *during* execution (from a client's
        ``move_fn``) with strictly higher priority than the move about
        to run preempt the round: their moves splice in ahead of
        everything remaining and the interrupted copy resumes after.
        Lower/equal-priority mid-round arrivals wait for the next
        flush.
        """
        ex = self.executor
        rank = ex.tier_rank()
        # snapshot: reentrant submits during execution land in
        # self._pending, where the preemption check watches for them
        pending, self._pending = self._pending, []
        scheduled: List[ScheduledMove] = []
        per_sub: List[Tuple[_Submission, List[ScheduledMove]]] = []
        coalesced = 0
        independent_s = 0.0
        for sub in pending:
            sms, netted = self._build_sms(sub)
            coalesced += netted
            # uncoordinated baseline: each tenant executes its own
            # (un-netted) delta as if alone, one tenant after another
            # on the shared executor — what independent replanners do
            independent_s += ex.cost_s(sub.delta)
            scheduled.extend(sms)
            per_sub.append((sub, sms))

        # priority first; capacity-freeing demotions before promotions
        # at equal priority; submission order is the stable tiebreak
        order_of = {id(sm): i for i, sm in enumerate(scheduled)}
        scheduled.sort(key=lambda sm: (
            -sm.priority,
            0 if self._is_demotion(sm.move, rank) else 1,
            order_of[id(sm)]))

        makespan = self._fluid(scheduled)

        # audit the fluid schedule's promised makespan against the wall
        # time the batch really took — only when the clients perform
        # physical transfers whose wall time matches the model's unit
        audited = (self.audit is not None and scheduled
                   and getattr(ex, "physical_moves", False))
        if audited:
            self._rounds_audited += 1
            audit_key = self._rounds_audited
            self.audit.predict("movesched.makespan", audit_key, makespan,
                               epoch=epoch, moves=len(scheduled))
            wall_t0 = time.perf_counter()

        # execute in scheduled order through each tenant's client,
        # yielding to higher-priority mid-round arrivals between moves
        done_by_sub: Dict[int, Dict[int, List]] = {}
        sub_of = {id(sm): sub for sub, sms in per_sub for sm in sms}
        queue: Deque[ScheduledMove] = deque(scheduled)
        executed: List[ScheduledMove] = []
        preempted = False
        while queue:
            sm = queue[0]
            urgent = [s for s in self._pending if s.priority > sm.priority]
            if urgent:
                preempted = True
                self.preemptions += 1
                new_sms: List[ScheduledMove] = []
                for s in sorted(urgent,
                                key=lambda s: (-s.priority, s.order)):
                    self._pending.remove(s)
                    sms, netted = self._build_sms(s)
                    coalesced += netted
                    independent_s += ex.cost_s(s.delta)
                    per_sub.append((s, sms))
                    for nsm in sms:
                        sub_of[id(nsm)] = s
                    new_sms.extend(sms)
                new_sms.sort(key=lambda x: (
                    -x.priority,
                    0 if self._is_demotion(x.move, rank) else 1))
                if self.tracer is not None:
                    self.tracer.event(
                        "movesched.preempt", cat="movesched", epoch=epoch,
                        tenant=sm.tenant, obj=sm.move.obj,
                        priority=sm.priority,
                        urgent_tenants=sorted({s.tenant for s in urgent}),
                        urgent_priority=max(s.priority for s in urgent),
                        urgent_moves=len(new_sms),
                        resumed_moves=len(queue))
                queue.extendleft(reversed(new_sms))
                continue
            queue.popleft()
            sub = sub_of[id(sm)]
            m = sm.move
            done = (sub.move_fn(m.obj, m.src, m.dst, m.nbytes)
                    if sub.move_fn is not None else m.nbytes)
            sm.done_bytes = max(int(done), 0)
            executed.append(sm)
            # chunked copies report once per original move to on_done,
            # with their pieces' realized bytes summed
            orig = sm.orig_move if sm.orig_move is not None else m
            agg = done_by_sub.setdefault(sub.order, {})
            rec = agg.get(id(orig))
            first_progress = rec is None or rec[1] == 0
            if rec is None:
                agg[id(orig)] = [orig, sm.done_bytes]
            else:
                rec[1] += sm.done_bytes
            stats = sub.stats
            if stats is not None and sm.done_bytes > 0:
                stats.migrated_bytes += sm.done_bytes
                # count each object's tier change once, not per chunk
                if first_progress:
                    if self._is_demotion(m, rank):
                        stats.demoted += 1
                    elif rank.get(m.dst, 0) < rank.get(m.src, 0):
                        stats.promoted += 1
        scheduled = executed
        if preempted:
            # re-time the schedule over the order that actually ran so
            # the round record and trace spans show the spliced batch
            makespan = self._fluid(scheduled)
        if audited:
            realized = time.perf_counter() - wall_t0
            touched = sorted({t for sm in scheduled
                              for t in (sm.move.src, sm.move.dst)})
            self.audit.realize("movesched.makespan", audit_key, realized,
                               resources=touched)
            if self.calibrator is not None and makespan > 0.0:
                self.calibrator.observe_time_ratio(realized / makespan,
                                                   tiers=touched)
                ex.recalibrate()

        for sub, _ in per_sub:
            if sub.on_done is not None:
                sub.on_done([(orig, done) for orig, done in
                             done_by_sub.get(sub.order, {}).values()])

        round_ = MoveRound(epoch, scheduled, makespan, independent_s,
                           coalesced)
        self.rounds.append(round_)
        # NOT cleared: lower/equal-priority mid-round arrivals stay
        # queued for the next flush (the snapshot emptied the rest)
        if self.tracer is not None:
            now = float(self.tracer.clock())
            self.tracer.event(
                "movesched.round", cat="movesched", epoch=epoch,
                moves=len(scheduled), makespan_s=makespan,
                independent_s=independent_s, saved_s=round_.saved_s,
                coalesced_bytes=coalesced)
            # per-move spans anchored at flush time, offset by their
            # fluid-schedule start/finish — the timeline a trace viewer
            # shows is the schedule the batch actually priced
            for sm in scheduled:
                m = sm.move
                self.tracer.complete(
                    "movesched.move", cat="movesched", tid=sm.tenant,
                    ts=now + sm.start_s,
                    dur=max(sm.finish_s - sm.start_s, 0.0),
                    epoch=epoch, tenant=sm.tenant, obj=m.obj,
                    src=m.src, dst=m.dst, nbytes=m.nbytes,
                    done_bytes=sm.done_bytes, priority=sm.priority,
                    resources=[str(r) for r in sm.resources])
        return round_

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        return {
            "rounds": float(len(self.rounds)),
            "scheduled_moves": float(sum(len(r.moves)
                                         for r in self.rounds)),
            "batched_makespan_s": float(sum(r.makespan_s
                                            for r in self.rounds)),
            "independent_s": float(sum(r.independent_s
                                       for r in self.rounds)),
            "saved_s": float(sum(r.saved_s for r in self.rounds)),
            "coalesced_bytes": float(sum(r.coalesced_bytes
                                         for r in self.rounds)),
            "preemptions": float(self.preemptions),
        }
