"""Continuous-batching request scheduler over the paged KV pool.

PyTorch-port copy of ``repro.serving.scheduler``, without the
topology link budget and the QoS predictor (those planes are not ported
yet).  Pure bookkeeping — no tensors.  The engine owns the model math; the
scheduler owns *which* requests prefill, decode, or get preempted each
iteration, against the pool's block accounting:

  * FIFO admission from the wait queue, capped by (a) an admission
    budget derived from the cost model's capacity reasoning (LIO 3:
    batch scales with memory capacity) and (b) the pool having enough
    free blocks for the request's prompt plus a growth margin;
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
from typing import Deque, List, Optional

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
                   max_batch_cap: int = 64) -> AdmissionPlan:
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
    device_kv = max(device_budget_bytes - weight_bytes, 0)
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


class ContinuousBatchingScheduler:
    """Queue + running set + preemption over a PagedKVPool."""

    def __init__(self, pool: PagedKVPool,
                 cfg: Optional[SchedulerConfig] = None, tracer=None):
        self.pool = pool
        self.cfg = cfg or SchedulerConfig()
        self.tracer = tracer          # trace recorder (obs plane), or None
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self._admit_stamp = 0
        self.preemption_events = 0
        self.budget_preemptions = 0   # evictions forced by ledger budget

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        req.state = RequestState.WAITING
        self.waiting.append(req)

    @property
    def active(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------------ #
    def blocks_needed(self, req: Request) -> int:
        """Blocks for the request's current context + one decode token."""
        return self.pool.blocks_for_tokens(req.context_len + 1)

    def admit(self, now_s: float = 0.0) -> List[Request]:
        """Admit waiting requests FIFO under batch + block budgets.

        Preempted requests sit at the queue front (LIFO re-entry), so
        they win readmission over fresh arrivals.  Returns the newly
        admitted requests — the engine must prefill each one.
        """
        admitted: List[Request] = []
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

    def finish(self, req: Request) -> None:
        self.pool.free_seq(req.rid)
        self.running.remove(req)
        req.state = RequestState.FINISHED
        self.finished.append(req)
        if self.tracer is not None:
            self.tracer.event("sched.finish", cat="sched", rid=req.rid,
                              new_tokens=len(req.out_tokens),
                              preemptions=req.preemptions)
