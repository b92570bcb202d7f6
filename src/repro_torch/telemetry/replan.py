"""PyTorch-port copy of ``repro.telemetry.replan`` (framework-free).

Adaptive object-level re-interleaving: profile -> re-plan -> re-place.

Closes the loop the paper leaves open: §V-B's object-level interleaving
is planned once from application semantics, and §VI shows kernel-level
migration integrates badly with it (PMO 3/4).  The controller here
re-plans *at the object level* from observed traffic instead:

  1. every ``replan_every`` epochs, rebuild the DataObject inventory
     from the AccessTrace window (measured read/write/random traffic,
     not the one-shot analytic estimate);
  2. re-run the placement policy (ObjectLevelInterleave by default) on
     those measured numbers;
  3. gate with core.costmodel: price the measured traffic under the
     current plan and the candidate plan, price the placement delta
     with the MigrationExecutor, and apply only if

        (old_step - new_step) * amortize_steps > migration_cost
        and old_step / new_step >= min_speedup      (hysteresis)

     so noise-level wins never trigger churn (the failure mode that
     makes AutoNUMA *hurt* in PMO 4);
  4. execute the delta through the executor's ``move_fn`` (e.g.
     PagedKVPool.migrate), which may partially deny moves on capacity —
     the *realized* residency (not the intended plan) becomes the new
     live plan, so the next costing pass prices reality.

Distance awareness: with a ``topology`` (repro.topology), the planner's
tier view is distance-adjusted from the compute ``origin`` — a CXL card
behind the far socket sorts *after* remote DRAM, spill order prefers
cheap same-socket placements, and the executor prices deltas over their
actual paths (moves sharing a bottleneck link serialize).

Phase cache: recurring phases (the detector labels them) skip
re-planning — ``maybe_replan(..., phase=sig)`` reuses the plan last
applied for that signature and waives the hysteresis margin (the plan
already proved itself), so a periodic workload pays the planning and
hesitation cost once per distinct phase, not once per recurrence.

Objects that appear mid-run (new sequences, freshly allocated state)
are costed as if resident on ``default_tier`` — that is where a
first-touch allocator actually put them.

Residency truth lives in a ``repro.pool.ResidencyLedger``: the live
"plan" is a *view* of what the ledger says is where.  With a shared
ledger (the serving engine's pool, a TieredStateStore) the replanner
prices deltas from the residency the physical client actually realized
— the client records its own moves — and the tenant's arbitrated
fast-tier budget caps how much fast capacity the policy may plan over.
Standalone (no physical client), the replanner registers its objects as
plan-origin and records realized shares itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, List, Mapping, Optional, Tuple

from ..core.costmodel import plan_step_cost
from ..core.migration import (HUGE_PAGE_BYTES, MigrationExecutor,
                              MigrationStats)
from ..core.policies import (_tier_order, ObjectLevelInterleave,
                             PlacementPlan, Policy)
from ..core.tiers import GiB, MemoryTier
from ..pool.ledger import ResidencyLedger
from .events import AccessTrace


@dataclasses.dataclass
class ReplanConfig:
    replan_every: int = 4          # epochs between replan attempts
    min_speedup: float = 1.05      # hysteresis on predicted step-time win
    amortize_steps: int = 16       # epochs a new plan must pay back over
    window_epochs: Optional[int] = 4   # trace window for measured traffic
    total_streams: int = 32
    compute_time_s: float = 0.0


@dataclasses.dataclass
class ReplanDecision:
    """One replan attempt, applied or not, with its costmodel verdict."""

    epoch: int
    applied: bool
    reason: str  # initial | win | cached_win | no_win | migration_cost
    #              | budget (arbiter shrank the fast budget: mandatory)
    #              | prefetch (proven plan pre-staged for a predicted
    #                phase before its first epoch)
    old_step_s: float = 0.0
    new_step_s: float = 0.0
    migration_s: float = 0.0
    moved_bytes: int = 0           # bytes actually moved when applied
    denied_bytes: int = 0          # intended-but-denied bytes (capacity)
    cached: bool = False           # candidate came from the phase cache
    deferred: bool = False         # delta handed to a MoveScheduler;
    #                                moved_bytes lands at its flush

    @property
    def predicted_speedup(self) -> float:
        return self.old_step_s / max(self.new_step_s, 1e-12)


class AdaptiveReplanner:
    """Periodic measured-traffic re-planner over a tier set."""

    def __init__(self, trace: AccessTrace,
                 tiers: Mapping[str, MemoryTier], fast: str,
                 policy: Optional[Policy] = None,
                 cfg: Optional[ReplanConfig] = None,
                 executor: Optional[MigrationExecutor] = None,
                 default_tier: Optional[str] = None,
                 initial_plan: Optional[PlacementPlan] = None,
                 topology=None, origin: Optional[str] = None,
                 ledger: Optional[ResidencyLedger] = None,
                 tenant: str = "replan",
                 move_scheduler=None, tracer=None, audit=None,
                 calibrator=None):
        self.trace = trace
        self.tracer = tracer           # optional repro.obs.TraceRecorder
        self.audit = audit             # optional obs.PredictionLedger
        self.calibrator = calibrator   # optional obs.CostModelCalibrator
        self.topology = topology
        self.origin = origin
        self._base_tiers = dict(tiers)
        # distance-adjusted view: path latency/bandwidth folded into the
        # tier descriptors, so every ordering and costing below honors
        # the hop topology (ROADMAP: NUMA-distance-aware replan)
        self.tiers = (dict(topology.effective_tiers(tiers, origin))
                      if topology is not None else dict(tiers))
        self.fast = fast
        self.tier_order = _tier_order(self.tiers)
        slow = [t for t in self.tier_order
                if t != fast and self.tiers[t].kind != "nvme"]
        self.policy = policy or ObjectLevelInterleave(
            fast, slow, bandwidth_weighted=True)
        self.cfg = cfg or ReplanConfig()
        self.executor = executor or MigrationExecutor(self.tiers,
                                                      topology=topology)
        self.default_tier = default_tier or self.tier_order[-1]
        # residency ledger: shared (pool/store tenant) or private
        self.ledger = ledger if ledger is not None \
            else ResidencyLedger(self.tiers)
        self.tenant = tenant
        self.ledger.register_tenant(tenant, trace=trace)
        self.plan = initial_plan
        self.stats = MigrationStats()
        self.decisions: List[ReplanDecision] = []
        # phase signature -> (plan, proven, budget): `proven` means the
        # plan once cleared the full hysteresis gate, so recurrences
        # may waive the margin; an initially-adopted plan has not.
        # `budget` is the tenant's fast-tier grant the plan was
        # computed under — a cached plan is only valid while the grant
        # still matches (an arbiter re-split makes it stale: smaller
        # means squatting, larger means stranding the new capacity)
        self._phase_plans: Dict[Hashable,
                                Tuple[PlacementPlan, bool, int]] = {}
        self.plan_cache_hits = 0
        self.prefetches = 0
        # optional cross-tenant coordinator (repro.pool.MoveScheduler):
        # applied deltas are submitted instead of executed, so moves
        # from every tenant sharing a bottleneck link get ordered and
        # batched together at the scheduler's flush
        self.move_scheduler = move_scheduler
        # one deferred apply may be in flight per flush round: until
        # the scheduler's callback adopts the realized moves, the
        # ledger still shows the pre-move residency, and a second
        # replan would re-derive and double-submit the same delta
        self._deferred_pending = False
        self.recalibrate()

    def recalibrate(self) -> None:
        """Refresh the planning tier view from the calibrator.

        Called once at construction and again by the owner whenever the
        calibrator's corrections move (probe fit, online EWMA update),
        so costing, tier ordering, and the executor's pricing all track
        measured numbers.  No-op without a calibrator."""
        if self.calibrator is None:
            return
        corrected, g = self.calibrator.calibrated_view(
            self._base_tiers, self.topology)
        self.tiers = (dict(g.effective_tiers(corrected, self.origin))
                      if g is not None else dict(corrected))
        self.tier_order = _tier_order(self.tiers)
        self.executor.recalibrate()

    # ------------------------------------------------------------------ #
    def _trace_decision(self, d: ReplanDecision) -> None:
        if self.tracer is None:
            return
        self.tracer.event(
            "replan.decision", cat="replan", tid=self.tenant,
            epoch=d.epoch, tenant=self.tenant, applied=d.applied,
            reason=d.reason, old_step_s=d.old_step_s,
            new_step_s=d.new_step_s, migration_s=d.migration_s,
            moved_bytes=d.moved_bytes, denied_bytes=d.denied_bytes,
            cached=d.cached, deferred=d.deferred)

    @property
    def replans_applied(self) -> int:
        return sum(1 for d in self.decisions if d.applied)

    @property
    def moved_bytes(self) -> int:
        return self.stats.migrated_bytes

    def _ensure_registered(self, nbytes: Mapping[str, int]) -> None:
        """Make the ledger cover every placeable object.

        New objects register at the live plan's shares if it names them
        (the initial_plan seed) else on ``default_tier`` — first touch.
        Plan-origin objects whose footprint drifted are re-scaled;
        client-origin residency is never touched (the client records)."""
        base = self.plan.shares if self.plan is not None else {}
        for name, total in nbytes.items():
            total = int(total)
            if total <= 0:
                continue
            if not self.ledger.has(self.tenant, name):
                sh = base.get(name, [(self.default_tier, 1.0)])
                placement = self._exact_placement(sh, total)
                self.ledger.register(self.tenant, name, placement,
                                     origin="plan")
            elif self.ledger.origin_of(self.tenant, name) == "plan":
                self.ledger.resize(self.tenant, name, total,
                                   grow_tier=self.default_tier)

    def _exact_placement(self, shares, total: int) -> Dict[str, int]:
        """Fraction shares -> bytes summing exactly to ``total``;
        rounding slack lands on the default (slow) tier so it can never
        inflate a budgeted fast tier."""
        placement: Dict[str, int] = {}
        for t, f in shares:
            if f > 0:
                placement[t] = placement.get(t, 0) + int(f * total)
        slack = total - sum(placement.values())
        if slack:
            placement[self.default_tier] = placement.get(
                self.default_tier, 0) + slack
        return placement

    def _current_shares(self, names: Iterable[str]
                        ) -> Dict[str, List]:
        """Residency truth from the ledger, per placeable object."""
        live = self.ledger.shares(self.tenant)
        return {name: list(live.get(name, [(self.default_tier, 1.0)]))
                for name in names}

    def _planning_tiers(self) -> Dict[str, MemoryTier]:
        """The policy's capacity view: the tenant's arbitrated fast-tier
        budget (when one is set in the ledger) caps what the plan may
        assume it owns — multi-tenant fairness enters the policy here."""
        budget = self.ledger.budget(self.tenant, self.fast)
        if budget is None:
            return self.tiers
        fast = self.tiers[self.fast]
        capped = min(fast.capacity_GiB, budget / GiB)
        return {**self.tiers,
                self.fast: dataclasses.replace(fast, capacity_GiB=capped)}

    def _budget_key(self) -> int:
        """The fast-tier grant plans are conditioned on (-1 = none)."""
        b = self.ledger.budget(self.tenant, self.fast)
        return -1 if b is None else int(b)

    def _cached_plan(self, phase: Optional[Hashable]
                     ) -> Tuple[Optional[PlacementPlan], bool]:
        """The proven-plan cache lookup, invalidated when the tenant's
        current grant drifted from the one the plan was computed under
        (beyond huge-page rounding)."""
        if phase is None:
            return None, False
        cached, proven, budget = self._phase_plans.get(
            phase, (None, False, -1))
        if cached is None:
            return None, False
        if abs(self._budget_key() - budget) > HUGE_PAGE_BYTES:
            return None, False
        return cached, proven

    # ------------------------------------------------------------------ #
    def maybe_replan(self, epoch: int, nbytes: Mapping[str, int],
                     pin_fast: Iterable[str] = (),
                     force: bool = False,
                     phase: Optional[Hashable] = None
                     ) -> Optional[ReplanDecision]:
        """Attempt one replan at `epoch`; returns the decision or None
        (not due yet / no observed traffic).  ``phase`` is an optional
        recurrence signature (e.g. the PhaseDetector label): plans that
        won under a signature are cached and reused without re-running
        the policy or the hysteresis margin."""
        cfg = self.cfg
        if self._deferred_pending:
            return None       # last apply still queued in the move
            #                   scheduler: residency is not adopted yet
        if not force and (cfg.replan_every <= 0
                          or epoch % cfg.replan_every != 0):
            return None
        objs = self.trace.to_data_objects(
            nbytes, window=cfg.window_epochs, pin_fast=pin_fast)
        if not any(o.bytes_per_step > 0 for o in objs):
            return None
        self._ensure_registered(nbytes)
        # budget compliance is not a performance optimization: when the
        # arbiter shrank this tenant's fast budget below its current
        # holding, a fresh plan against the capped capacity view is
        # mandatory — a phase-cached plan predates the shrink and would
        # "apply" a no-op delta while squatting on another tenant's
        # grant.  Excess below one huge page is rounding, not
        # squatting: byte-level flapping must not churn plans forever.
        over_budget = self.ledger.over_budget(
            self.tenant, self.fast) > HUGE_PAGE_BYTES
        cached, proven = (self._cached_plan(phase)
                          if not over_budget else (None, False))
        if cached is not None and any(n not in cached.shares
                                      for n in nbytes):
            cached = None      # inventory drifted: the cached plan is
            #                    for a different object population
        if cached is not None:
            new_plan = cached
            self.plan_cache_hits += 1
        else:
            new_plan = self.policy.plan(objs, self._planning_tiers())

        if self.plan is None:
            # first adoption is allocation, not migration: plan-origin
            # objects take the plan's shares for free (first touch
            # follows the plan); client-recorded residency stays put
            for name, total in nbytes.items():
                if self.ledger.origin_of(self.tenant, name) != "plan":
                    continue
                sh = new_plan.shares.get(name)
                if sh:
                    self.ledger.set_residency(
                        self.tenant, name,
                        self._exact_placement(sh, int(total)))
            self.plan = PlacementPlan(self._current_shares(nbytes),
                                      new_plan.policy,
                                      new_plan.tier_bytes)
            if phase is not None:
                self._phase_plans[phase] = (new_plan, False,
                                            self._budget_key())
            d = ReplanDecision(epoch, True, "initial",
                               cached=cached is not None)
            self.decisions.append(d)
            self._trace_decision(d)
            return d

        old_shares = self._current_shares(nbytes)
        old_plan = PlacementPlan(old_shares, self.plan.policy, {})
        old_cost = plan_step_cost(objs, old_plan, self.tiers,
                                  cfg.total_streams,
                                  cfg.compute_time_s).step_s
        new_cost = plan_step_cost(objs, new_plan, self.tiers,
                                  cfg.total_streams,
                                  cfg.compute_time_s).step_s
        # audit join: the previous costing pass predicted the step cost
        # of whatever placement it adopted; `old_cost` is that same
        # placement priced on the traffic actually measured since — the
        # realized outcome of the prediction
        if self.audit is not None and self.audit.has_pending(
                "replan.step_cost", self.tenant):
            self.audit.realize("replan.step_cost", self.tenant, old_cost)
        delta = self.executor.delta(old_shares, new_plan.shares, nbytes)
        mig_s = self.executor.cost_s(delta)
        d = ReplanDecision(epoch, False, "no_win", old_cost, new_cost,
                           mig_s, delta.total_bytes,
                           cached=cached is not None)
        # a cached plan that already cleared the hysteresis bar for this
        # phase re-applies on any strict win; initially-adopted (never
        # win-tested) plans keep the full margin so noise-level wins
        # cannot churn (the PMO-4 failure mode)
        min_speedup = (1.0 if cached is not None and proven
                       else cfg.min_speedup)
        if over_budget:
            d.reason = "budget"
            self._apply(d, delta, nbytes, new_plan, phase,
                        cache_proven=False)
        elif delta.total_bytes <= 0:
            pass          # candidate == current placement: float-noise
            #               cost differences must not count as applies
        elif old_cost < new_cost * min_speedup:
            pass                          # hysteresis: win too small
        elif (old_cost - new_cost) * cfg.amortize_steps <= mig_s:
            d.reason = "migration_cost"
        else:
            d.reason = "cached_win" if cached is not None else "win"
            self._apply(d, delta, nbytes, new_plan, phase,
                        cache_proven=True)
        # file the forward prediction: the step cost of the placement
        # this decision leaves live (keyed by tenant — one pending
        # prediction per tenant, joined at the next costing pass)
        if self.audit is not None:
            self.audit.predict("replan.step_cost", self.tenant,
                               new_cost if d.applied else old_cost,
                               epoch=epoch, applied=d.applied)
        self.decisions.append(d)
        self._trace_decision(d)
        return d

    def prefetch_phase(self, epoch: int, nbytes: Mapping[str, int],
                       phase: Hashable) -> Optional[ReplanDecision]:
        """Pre-stage the placement for a *predicted* upcoming phase.

        When a phase predictor says signature ``phase`` starts next
        epoch, the proven plan cached for it is applied now — during
        the current phase's slack — so the recurring burst's first
        epoch runs on its placement instead of paying the migration (or
        worse, running cold).  Deliberately skips the hysteresis and
        amortization gates: the plan earned adoption when its phase was
        live, and costing a pre-staged promotion against the current
        (pre-shift) traffic would always reject it.

        Only **promotion-dominant** deltas are pre-staged: a predicted
        phase that mostly *releases* the fast tier can wait for its
        first real epoch at no throughput cost, while demoting early
        would run the live phase's tail on the next phase's placement.

        Returns None (nothing staged) when no proven plan is cached for
        the signature, the object inventory drifted, the placement
        already matches, or the delta is demotion-dominant.
        """
        if self._deferred_pending:
            return None              # an apply is already in flight
        cached, proven = self._cached_plan(phase)
        if cached is None or not proven or self.plan is None:
            return None
        if any(n not in cached.shares for n in nbytes):
            return None              # inventory drifted
        self._ensure_registered(nbytes)
        old_shares = self._current_shares(nbytes)
        delta = self.executor.delta(old_shares, cached.shares, nbytes)
        if delta.total_bytes <= 0:
            return None              # already in place
        if delta.bytes_into(self.fast) <= delta.bytes_out_of(self.fast):
            return None              # demotion-dominant: react instead
        mig_s = self.executor.cost_s(delta)
        d = ReplanDecision(epoch, False, "prefetch", migration_s=mig_s,
                           cached=True)
        self.plan_cache_hits += 1
        self.prefetches += 1
        self._apply(d, delta, nbytes, cached, phase, cache_proven=True)
        self.decisions.append(d)
        self._trace_decision(d)
        return d

    def _apply(self, d: ReplanDecision, delta, nbytes, new_plan,
               phase: Optional[Hashable], cache_proven: bool) -> None:
        """Execute a delta (or defer it to the cross-tenant move
        scheduler) and adopt the realized residency."""
        if self.move_scheduler is not None:
            d.applied = True
            d.deferred = True
            d.moved_bytes = 0        # real bytes land at the flush
            self._deferred_pending = True
            weight = self.ledger.tenant_info(self.tenant).weight
            self.move_scheduler.submit(
                self.tenant, delta,
                move_fn=self.executor.move_fn, priority=weight,
                stats=self.stats,
                on_done=lambda moves_done, _d=d: self._adopt(
                    _d, moves_done, nbytes, new_plan, phase,
                    cache_proven))
            return
        self.executor.execute(delta, self.stats)
        self._adopt(d, self.executor.last_moves, nbytes, new_plan,
                    phase, cache_proven)

    def _adopt(self, d: ReplanDecision, moves_done, nbytes, new_plan,
               phase: Optional[Hashable], cache_proven: bool) -> None:
        """Post-execute bookkeeping for the realized moves."""
        self._deferred_pending = False
        done = sum(b for _, b in moves_done)
        # feedback on denied moves: the ledger adopts the residency
        # that was actually realized, not the one the policy intended.
        # Physical clients (pool, state store) recorded their own moves
        # inside move_fn; the replanner records only for the
        # plan-origin objects it owns itself.
        for m, b in moves_done:
            if b > 0 and self.ledger.origin_of(
                    self.tenant, m.obj) == "plan":
                self.ledger.record_move(self.tenant, m.obj,
                                        m.src, m.dst, b)
        self.plan = PlacementPlan(self._current_shares(nbytes),
                                  new_plan.policy, new_plan.tier_bytes)
        d.applied = True
        d.moved_bytes = done
        intended = sum(m.nbytes for m, _ in moves_done)
        d.denied_bytes = max(intended - done, 0)
        if self.tracer is not None:
            self.tracer.event(
                "replan.adopt", cat="replan", tid=self.tenant,
                epoch=d.epoch, tenant=self.tenant, reason=d.reason,
                moved_bytes=d.moved_bytes, denied_bytes=d.denied_bytes,
                moves=len(moves_done), deferred=d.deferred)
        if phase is not None and cache_proven:
            # cache the *intended* plan: it is the phase's target
            # placement; denials are per-occurrence capacity facts
            self._phase_plans[phase] = (new_plan, True,
                                        self._budget_key())

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        applied = [d for d in self.decisions if d.applied]
        return {
            "replans_considered": float(len(self.decisions)),
            "replans_applied": float(len(applied)),
            "moved_bytes": float(self.stats.migrated_bytes),
            "denied_bytes": float(sum(d.denied_bytes for d in applied)),
            "migration_s": float(sum(d.migration_s for d in applied)),
            "plan_cache_hits": float(self.plan_cache_hits),
            "prefetches": float(self.prefetches),
        }
