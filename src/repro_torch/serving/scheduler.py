"""PyTorch-port copy of ``repro.serving.scheduler``.

Continuous-batching request scheduler over the paged KV pool.

Pure bookkeeping — no tensors.  The engine owns the model math; the
scheduler owns *which* requests prefill, decode, or get preempted each
iteration, against the pool's block accounting:

  * FIFO admission from the wait queue, capped by (a) an admission
    budget derived from the cost model's capacity reasoning (LIO 3:
    batch scales with memory capacity), (b) the pool having enough
    free blocks for the request's prompt plus a growth margin, and
    (c) — with a ``TopologyGraph`` attached — a *link budget*: each
    running request's KV gather is a flow from its blocks' resident
    kinds to the fast kind, and ``TopologyGraph.contended_flows``
    fair-shares the PCIe/UPI links those flows cross; a candidate
    whose admission would drag any flow below
    ``link_efficiency_floor`` of its offered bandwidth stays queued
    (block capacity alone does not see shared-link saturation);
  * prefill/decode interleaving: at most ``max_prefill_per_iter`` new
    admissions per iteration, so admission bursts cannot starve the
    running batch (the latency/throughput split of Fig. 11);
  * preemption when the pool runs dry mid-decode: the *latest-admitted*
    running request is evicted (LIFO — it has the least sunk decode
    work), its blocks are freed, and it returns to the FRONT of the
    wait queue so it is re-admitted before fresh arrivals;
  * **ledger-driven preemption** (``preempt_over_budget``): when a
    ``TierBudgetArbiter`` shrinks this tenant's fast-tier budget in the
    shared ``ResidencyLedger``, the scheduler evicts the
    lowest-priority running sequences holding fast blocks until the
    tenant is back within budget — the grant moves to the other tenant
    immediately instead of leaking out block-by-block through tierer
    churn.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from .kv_pool import FAST_KIND, PagedKVPool


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One serving request; tokens accumulate across preemptions."""

    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    arrival_s: float = 0.0
    # relative importance for budget preemption: when the arbiter
    # shrinks the tenant's fast budget, the lowest-priority running
    # sequences are evicted first (ties: latest-admitted)
    priority: float = 0.0
    state: RequestState = RequestState.WAITING
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    admit_order: int = -1              # monotone admission stamp
    preemptions: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    @property
    def context_len(self) -> int:
        """Tokens that must be in the KV cache to continue decoding."""
        return self.prompt_len + len(self.out_tokens)

    def prefill_tokens(self) -> np.ndarray:
        """Token ids to prefill on (re-)admission: prompt + generated."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])


@dataclasses.dataclass
class AdmissionPlan:
    """Capacity-budget-derived scheduler sizing (LIO 3)."""

    max_batch: int
    total_blocks: int
    fast_blocks: int
    block_tokens: int

    @property
    def max_seq_blocks(self) -> int:
        return max(1, self.total_blocks // max(self.max_batch, 1))


def plan_admission(cfg, block_tokens: int, max_context: int,
                   device_budget_bytes: int, host_budget_bytes: int,
                   max_batch_cap: int = 64, state_bytes_per_seq: int = 0
                   ) -> AdmissionPlan:
    """Size the pool and the admission limit from a capacity budget.

    The KV budget is what remains of the device budget after bf16
    weights (the FlexGen inventory, core.objects.llm_serve_objects)
    plus the whole host budget; batch is capped so every admitted
    request can grow to ``max_context`` tokens without exhausting the
    pool — the paper's capacity -> batch -> throughput chain.
    """
    from .kv_pool import spec_from_config
    spec = spec_from_config(cfg, block_tokens)
    weight_bytes = 2 * cfg.param_count()
    # port only: a hybrid model's recurrent state slots, one per row and
    # one for the padded rows, live on the device beside the weights
    device_kv = max(device_budget_bytes - weight_bytes
                    - (max_batch_cap + 1) * state_bytes_per_seq, 0)
    total_kv = device_kv + host_budget_bytes
    total_blocks = max(int(total_kv // spec.nbytes), 1)
    fast_blocks = min(int(device_kv // spec.nbytes), total_blocks)
    blocks_per_seq = max(1, math.ceil(max_context / block_tokens))
    max_batch = max(1, min(max_batch_cap, total_blocks // blocks_per_seq))
    return AdmissionPlan(max_batch=max_batch, total_blocks=total_blocks,
                         fast_blocks=fast_blocks,
                         block_tokens=block_tokens)


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 8
    max_prefill_per_iter: int = 2
    # free blocks a request must leave after admission (growth margin,
    # in blocks) before it is let in — crude decode headroom control
    admission_margin_blocks: int = 1
    # contention-aware admission (repro.topology): a candidate is
    # admitted only while every gather flow keeps at least this
    # fraction of its offered bandwidth under fair link sharing
    link_efficiency_floor: float = 0.5
    # assumed iteration period for converting a request's KV gather
    # bytes into an offered bandwidth (GB/s = bytes / period / 1e9)
    gather_period_s: float = 0.05
    # interference class this tenant's KV gather traffic presents to
    # the class-aware contention model (read | write | prefetch)
    flow_class: str = "read"


class ContinuousBatchingScheduler:
    """Queue + running set + preemption over a PagedKVPool.

    ``topology`` (a repro.topology.TopologyGraph whose tier nodes are
    aliased to the pool's memory kinds) switches admission from pure
    block capacity to capacity + shared-link budgeting.
    """

    def __init__(self, pool: PagedKVPool,
                 cfg: Optional[SchedulerConfig] = None,
                 topology=None, tracer=None, predictor=None):
        self.pool = pool
        self.cfg = cfg or SchedulerConfig()
        self.topology = topology
        self.tracer = tracer          # optional repro.obs.TraceRecorder
        # optional repro.obs.ViolationPredictor: admission + preemption
        # gate on predicted SLO violation instead of the flat
        # link_efficiency_floor
        self.predictor = predictor
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self._admit_stamp = 0
        self.preemption_events = 0
        self.link_deferrals = 0       # admissions blocked by link budget
        self.budget_preemptions = 0   # evictions forced by ledger budget
        self.qos_deferrals = 0        # blocked by predicted violation
        self.slo_preemptions = 0      # evictions forced by predicted SLO
        # port only: called as on_release(req, preempted) whenever a
        # running request leaves the running set (the engine frees what
        # it holds beside the pool's blocks, such as a state slot)
        self.on_release = None

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def submit_all(self, reqs: Sequence[Request]) -> None:
        for r in sorted(reqs, key=lambda r: r.arrival_s):
            self.submit(r)

    @property
    def active(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------------ #
    def blocks_needed(self, req: Request) -> int:
        """Blocks for the request's current context + one decode token."""
        return self.pool.blocks_for_tokens(req.context_len + 1)

    # ------------------------------------------------------------------ #
    def _gather_flow(self, kind: str, n_blocks: int):
        """One KV-gather flow: ``n_blocks`` streamed from ``kind``'s
        node to the fast kind's node each iteration (None if the
        topology doesn't map the kinds or they share a node)."""
        from ..topology import Flow
        src = self.topology.node_of(kind)
        dst = self.topology.node_of(FAST_KIND)
        if src is None or dst is None or src == dst:
            return None
        offered = (n_blocks * self.pool.block_nbytes()
                   / self.cfg.gather_period_s / 1e9)
        if offered <= 0:
            return None
        return Flow(src, dst, offered, cls=self.cfg.flow_class,
                    tenant=self.pool.tenant)

    def _running_flows(self) -> List:
        """Per-request gather flows for the running set, grouped by the
        resident kind of each request's slow-tier blocks (read through
        the pool's ledger-backed residency)."""
        flows = []
        for req in self.running:
            per_kind: Dict[str, int] = {}
            for b in self.pool.seq_blocks(req.rid):
                if b.kind != FAST_KIND:
                    per_kind[b.kind] = per_kind.get(b.kind, 0) + 1
            for kind, n in per_kind.items():
                f = self._gather_flow(kind, n)
                if f is not None:
                    flows.append(f)
        return flows

    def _link_budget_allows(self, req: Request, running: List,
                            pending: List) -> bool:
        """Does admitting ``req`` keep its own gather flow above the
        efficiency floor without dragging any currently-healthy flow
        below it?  Only the candidate's *marginal* effect counts: a
        flow already below the floor (e.g. demotion-heavy residency on
        an unrelated link) must not head-of-line-block admissions that
        would not make it worse.  ``running`` is the admit-call's
        snapshot of ``_running_flows()`` (residency cannot change
        mid-admission); ``pending`` accumulates this call's admitted
        candidates."""
        cand = self._gather_flow(self.pool.default_kind,
                                 self.blocks_needed(req))
        if cand is None:
            return True
        floor = self.cfg.link_efficiency_floor
        base = running + pending
        healthy = [r.achieved_GBps >= floor * f.offered_GBps
                   for f, r in zip(base,
                                   self.topology.contended_flows(base))]
        flows = base + [cand]
        results = self.topology.contended_flows(flows,
                                                tracer=self.tracer)
        ok = results[-1].achieved_GBps >= floor * cand.offered_GBps \
            and all(r.achieved_GBps >= floor * f.offered_GBps
                    for (f, r), was in zip(zip(base, results), healthy)
                    if was)
        if ok:
            pending.append(cand)
        return ok

    def _qos_allows(self, req: Request, running: List,
                    pending: List) -> bool:
        """Violation-predictive admission: would admitting ``req`` keep
        every tenant with a registered SLO target (this one and the
        neighbors in the blame book) under its predicted-p99 threshold?
        Replaces the flat efficiency floor when a ``ViolationPredictor``
        is attached — the floor is blind to *who* the lost bandwidth
        hurts; the predictor prices the candidate against the victim's
        actual tail budget."""
        cand = self._gather_flow(self.pool.default_kind,
                                 self.blocks_needed(req))
        if cand is None:
            return True
        if not running and not pending:
            # empty-pool bootstrap: with nothing running, deferring the
            # sole workload protects no one — an unachievable own target
            # must not starve the engine (liveness over forecast)
            pending.append(cand)
            return True
        own = running + pending + [cand]
        ok = self.predictor.admission_ok(own, exclude=self.pool.tenant)
        if ok:
            pending.append(cand)
        elif self.tracer is not None:
            viol = self.predictor.violations(own,
                                             exclude=self.pool.tenant)
            self.tracer.event(
                "sched.qos_defer", cat="sched", rid=req.rid,
                offered_GBps=cand.offered_GBps,
                violations={t: {"predicted_s": p, "threshold_s": thr}
                            for t, (p, thr) in viol.items()})
        return ok

    def admit(self, now_s: float = 0.0) -> List[Request]:
        """Admit waiting requests FIFO under batch + block budgets.

        Preempted requests sit at the queue front (LIFO re-entry), so
        they win readmission over fresh arrivals.  Returns the newly
        admitted requests — the engine must prefill each one.
        """
        admitted: List[Request] = []
        pending_flows: List = []       # flows of this call's admissions
        running_flows: List = (self._running_flows()
                               if self.topology is not None else [])
        margin = self.cfg.admission_margin_blocks
        while (self.waiting
               and len(self.running) < self.cfg.max_batch
               and len(admitted) < self.cfg.max_prefill_per_iter):
            head = self.waiting[0]
            if head.arrival_s > now_s:
                break
            need = self.blocks_needed(head)
            if not self.pool.can_alloc(need + margin):
                break
            if self.topology is not None and self.predictor is not None:
                if not self._qos_allows(head, running_flows,
                                        pending_flows):
                    self.qos_deferrals += 1
                    break
            elif self.topology is not None and \
                    not self._link_budget_allows(head, running_flows,
                                                 pending_flows):
                self.link_deferrals += 1
                break
            self.waiting.popleft()
            head.state = RequestState.RUNNING
            head.admit_order = self._admit_stamp
            self._admit_stamp += 1
            self.running.append(head)
            admitted.append(head)
            if self.tracer is not None:
                self.tracer.event("sched.admit", cat="sched", ts=now_s,
                                  rid=head.rid, blocks=need,
                                  running=len(self.running),
                                  waiting=len(self.waiting),
                                  readmission=head.preemptions > 0)
        return admitted

    # ------------------------------------------------------------------ #
    def preempt_for_blocks(self, n_blocks: int,
                           protect: Optional[Request] = None
                           ) -> List[Request]:
        """Evict running requests (latest-admitted first) until
        ``n_blocks`` pool blocks are free.

        ``protect`` is exempt (the request that needs the blocks); if it
        is the only one left, it preempts itself — progress for older
        work beats holding a pool-starved tail request.  Evicted
        requests lose their pool blocks (re-prefill on readmission —
        preemption-by-recompute) and rejoin the queue FRONT.
        """
        victims: List[Request] = []
        order = sorted(self.running, key=lambda r: -r.admit_order)
        others = [r for r in order if r is not protect]
        last = [protect] if protect in order else []
        for victim in others + last:       # protect evicted only last
            if self.pool.free_block_count() >= n_blocks:
                break
            self._evict(victim, reason="capacity")
            victims.append(victim)
        return victims

    def preempt_over_budget(self) -> List[Request]:
        """Ledger-driven preemption: enforce an arbiter budget shrink
        *now* instead of waiting for tierer churn.

        While this tenant holds more fast-tier bytes than its ledger
        budget (``ledger.over_budget`` — e.g. a ``TierBudgetArbiter``
        handed the capacity to another tenant), evict the
        lowest-priority running sequence that still holds fast blocks
        (ties: latest-admitted, the least sunk decode work).  Eviction
        frees the sequence's pool blocks — the ledger retires its
        residency, reconciling the fast tier immediately — and the
        request re-enters the queue front for recompute once capacity
        (or budget) returns.  Sub-block excess is rounding, not
        squatting, and never triggers an eviction; a shrink with no
        running fast holder is left to the tierer (nothing a
        preemption could free).
        """
        pool = self.pool
        bn = max(pool.block_nbytes(), 1)
        victims: List[Request] = []
        while self.running:
            over = pool.ledger.over_budget(pool.tenant, FAST_KIND)
            if over < bn:
                break
            holders = [r for r in self.running
                       if any(b.kind == FAST_KIND
                              for b in pool.seq_blocks(r.rid))]
            if not holders:
                break
            victim = min(holders,
                         key=lambda r: (r.priority, -r.admit_order))
            self._evict(victim, reason="budget")
            self.budget_preemptions += 1
            victims.append(victim)
        return victims

    def preempt_predicted_violation(self) -> List[Request]:
        """Predictive QoS preemption: while this tenant's live gather
        flows push any tenant with a registered SLO target past its
        predicted-p99 threshold, evict the lowest-priority running
        sequence still holding slow-tier blocks (the ones generating
        cross-link traffic).  The flat-floor baseline only reacts after
        the victim's tail has already blown; this backs off while the
        violation is still a forecast."""
        if self.predictor is None:
            return []
        victims: List[Request] = []
        while self.running:
            own = self._running_flows()
            if not own:
                break
            viol = self.predictor.violations(own,
                                             exclude=self.pool.tenant)
            if not viol:
                break
            if set(viol) == {self.pool.tenant} and len(self.running) <= 1:
                # self-inflicted forecast with nothing left to shed
                # against: evicting the last sequence cannot improve its
                # own tail (the work still has to run) — it only
                # livelocks the engine through evict/readmit cycles
                break
            holders = [r for r in self.running
                       if any(b.kind != FAST_KIND
                              for b in self.pool.seq_blocks(r.rid))]
            if not holders:
                break
            victim = min(holders,
                         key=lambda r: (r.priority, -r.admit_order))
            self._evict(victim, reason="slo")
            self.slo_preemptions += 1
            victims.append(victim)
        return victims

    def _evict(self, req: Request, reason: str = "capacity") -> None:
        self.pool.free_seq(req.rid)
        self.running.remove(req)
        req.state = RequestState.PREEMPTED
        req.preemptions += 1
        self.preemption_events += 1
        if self.tracer is not None:
            self.tracer.event("sched.preempt", cat="sched", rid=req.rid,
                              reason=reason, priority=req.priority,
                              preemptions=req.preemptions)
        # LIFO re-entry: most recently evicted goes first
        self.waiting.appendleft(req)
        if self.on_release is not None:
            self.on_release(req, True)

    def finish(self, req: Request) -> None:
        self.pool.free_seq(req.rid)
        self.running.remove(req)
        req.state = RequestState.FINISHED
        self.finished.append(req)
        if self.tracer is not None:
            self.tracer.event("sched.finish", cat="sched", rid=req.rid,
                              new_tokens=len(req.out_tokens),
                              preemptions=req.preemptions)
        if self.on_release is not None:
            self.on_release(req, False)
