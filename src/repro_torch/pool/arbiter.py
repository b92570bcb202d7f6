"""PyTorch-port copy of ``repro.pool.arbiter`` (framework-free).

TierBudgetArbiter: fair-share splitting of the fast tier across tenants.

The paper's central system question — how a fixed fast-tier (DRAM)
budget plus CXL expansion should be shared — becomes, with multiple
workloads on one pool, an arbitration problem: "Dissecting CXL Memory
Performance at Scale" shows contention for the shared fast tier
dominates per-object placement effects.  The arbiter reads each
tenant's *measured* demand from its AccessTrace namespace in the
``ResidencyLedger`` and splits the fast-tier capacity under a pluggable
objective:

  * ``fair_share``   — max-min fairness: equal entitlements, capped by
    demand, with unused capacity water-filled to still-hungry tenants
    (no tenant can raise its grant without lowering a poorer one's);
  * ``throughput``   — aggregate-throughput: fast bytes flow to the
    tenants with the highest traffic intensity (bytes/step per resident
    byte — the marginal step-time saved per fast byte is proportional
    to it), filling each tenant's hot set in intensity order;
  * ``priority``     — weighted fair share: entitlements proportional
    to each tenant's ``Tenant.weight``.

Budgets land in the ledger (``set_budget``), where every placement path
— pool promotions, replanner deltas, state-store re-places — consults
them through ``can_place``.

**Predictive arbitration** (``predictive=True``): measured demand reacts
one epoch *after* a phase shift — a recurring decode burst runs its
first epoch under the previous lull's budget (the burst-entry lag the
multi-tenant bench exposes).  The predictive arbiter runs a
``PhaseDetector`` over each tenant's trace namespace and keeps a small
**phase -> demand table** keyed by recurrence signature: each rebalance
it (a) EMA-learns the demand measured under the *current* signature and
(b) grants from the demand remembered for the signatures *predicted*
for the next two epochs (element-wise max — budget arrives one epoch
early and is released the epoch a phase actually ends).  Unknown
signatures fall back to the reactive measured demand, and entries whose
signature stops recurring are TTL-evicted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Mapping, Optional

from ..cluster.namespace import Namespace
from .ledger import ResidencyLedger

OBJECTIVES = ("fair_share", "throughput", "priority")


@dataclasses.dataclass
class TenantDemand:
    """One tenant's measured appetite for the fast tier."""

    tenant: str
    resident_bytes: int        # total footprint in the ledger
    hot_bytes: int             # bytes with observed traffic (fast-worthy)
    bytes_per_step: float      # traffic rate over the demand window
    weight: float = 1.0
    source: str = "measured"   # measured | predicted

    @property
    def intensity(self) -> float:
        """Traffic per resident byte — the marginal utility of giving
        this tenant one more fast byte."""
        return self.bytes_per_step / max(self.hot_bytes, 1)


@dataclasses.dataclass
class PhaseDemand:
    """Remembered demand for one recurrence signature."""

    hot_bytes: float
    bytes_per_step: float
    last_seen_epoch: int
    hits: int = 1


class PhaseDemandTable:
    """signature -> EMA-smoothed demand, with TTL + size-bounded eviction.

    The table is deliberately small: it remembers *recurring* phases
    (burst/lull/steady), not every epoch — ``max_entries`` bounds it and
    ``ttl_epochs`` retires signatures that stopped recurring so a dead
    phase cannot keep pre-claiming fast capacity.
    """

    def __init__(self, ttl_epochs: int = 256, max_entries: int = 32,
                 alpha: float = 0.5):
        self.ttl_epochs = int(ttl_epochs)
        self.max_entries = int(max_entries)
        self.alpha = float(alpha)
        self.entries: Dict[Hashable, PhaseDemand] = {}
        self.evictions = 0

    def observe(self, sig: Hashable, hot_bytes: float,
                bytes_per_step: float, epoch: int) -> None:
        e = self.entries.get(sig)
        if e is None:
            self.entries[sig] = PhaseDemand(float(hot_bytes),
                                            float(bytes_per_step), epoch)
        else:
            a = self.alpha
            e.hot_bytes += a * (hot_bytes - e.hot_bytes)
            e.bytes_per_step += a * (bytes_per_step - e.bytes_per_step)
            e.last_seen_epoch = epoch
            e.hits += 1

    def lookup(self, sig: Hashable, epoch: int) -> Optional[PhaseDemand]:
        e = self.entries.get(sig)
        if e is None or epoch - e.last_seen_epoch > self.ttl_epochs:
            return None
        return e

    def evict_stale(self, epoch: int) -> None:
        stale = {s for s, e in self.entries.items()
                 if epoch - e.last_seen_epoch > self.ttl_epochs}
        live = [s for s in self.entries if s not in stale]
        if len(live) > self.max_entries:
            live.sort(key=lambda s: self.entries[s].last_seen_epoch)
            stale.update(live[: len(live) - self.max_entries])
        for s in stale:
            del self.entries[s]
            self.evictions += 1


@dataclasses.dataclass
class ArbiterDecision:
    """One rebalance: measured demands and the budgets that resulted."""

    epoch: int
    objective: str
    budgets: Dict[str, int]
    demands: List[TenantDemand]

    def budget_of(self, tenant: str) -> int:
        return self.budgets.get(tenant, 0)


class TierBudgetArbiter:
    """Splits one tier's capacity across the ledger's tenants."""

    def __init__(self, ledger: ResidencyLedger, fast_tier: str,
                 capacity_bytes: Optional[int] = None,
                 objective: str = "fair_share",
                 window_epochs: Optional[int] = 4,
                 floor_bytes: int = 0,
                 hot_threshold: float = 0.05,
                 predictive: bool = False,
                 signature_ttl_epochs: int = 256,
                 tracer=None, audit=None,
                 blame=None, blame_debit: float = 0.5,
                 replica_capacity: Optional[Mapping[str, int]] = None):
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"choose from {OBJECTIVES}")
        self.ledger = ledger
        self.fast_tier = fast_tier
        if capacity_bytes is None:
            capacity_bytes = ledger.capacity_bytes.get(fast_tier)
        if capacity_bytes is None:
            raise ValueError(
                f"no capacity for tier {fast_tier!r}: pass "
                f"capacity_bytes or set it on the ledger")
        self.capacity_bytes = int(capacity_bytes)
        self.objective = objective
        self.window_epochs = window_epochs
        # every tenant keeps at least this much fast headroom even when
        # its trace shows no demand (cold-start protection)
        self.floor_bytes = int(floor_bytes)
        # an object is fast-worthy only while it is access-intensive:
        # per-epoch traffic at least this fraction of its footprint
        # (the paper's §V-B selection criterion, applied per tenant) —
        # a drained serving engine's cold KV stops counting as demand
        self.hot_threshold = float(hot_threshold)
        self.decisions: List[ArbiterDecision] = []
        # predictive mode: per-tenant phase detectors + demand tables
        self.predictive = bool(predictive)
        self.signature_ttl_epochs = int(signature_ttl_epochs)
        self._detectors: Dict[str, object] = {}
        self._tables: Dict[str, PhaseDemandTable] = {}
        self.predicted_grants = 0     # demands served from the table
        self.tracer = tracer          # optional repro.obs.TraceRecorder
        self.audit = audit            # optional obs.PredictionLedger
        # QoS blame coupling (optional obs.BlameLedger): a tenant the
        # blame plane names as a noisy neighbor gets up to
        # ``blame_debit`` of its above-floor grant debited, re-water-
        # filled to the unblamed still-hungry tenants — tail excursions
        # it caused cost it fast capacity, not just reputation
        self.blame = blame
        self.blame_debit = float(blame_debit)
        self.blame_debited_bytes = 0
        # multi-host plane: each replica's *physical* fast-tier capacity
        # (keyed by replica name).  The split water-fills across replica
        # groups first — a tenant on host A can never be granted host
        # B's DRAM — then per-tenant within each group's grant.  With
        # every tenant in the "default" replica and no capacities given
        # this degenerates exactly to the single-pool split.
        self.replica_capacity: Dict[str, int] = \
            {r: int(c) for r, c in (replica_capacity or {}).items()}
        # last next-phase signature filed with the audit, per tenant —
        # joined (hit/miss) when the next rebalance sees the actual one
        self._predicted_sigs: Dict[str, Hashable] = {}

    # ------------------------------------------------------------------ #
    # demand measurement                                                 #
    # ------------------------------------------------------------------ #
    def demand(self, tenant: str,
               window: Optional[int] = None) -> TenantDemand:
        """Read one tenant's demand from its trace namespace: hot bytes
        are the footprints of objects with traffic in the window; with
        no trace attached the whole residency counts as hot."""
        ns = Namespace.of(tenant).tenant_key()
        name = str(ns)
        info = self.ledger.tenants[ns]
        nbytes = self.ledger.nbytes_by_obj(ns)
        resident = sum(nbytes.values())
        trace = info.trace
        if trace is None:
            return TenantDemand(name, resident, resident, float(resident),
                                info.weight)
        traffic = trace.object_traffic(
            self.window_epochs if window is None else window)
        hot = 0
        rate = 0.0
        for obj, t in traffic.items():
            if t.total_bytes <= 0:
                continue
            per_epoch = t.total_bytes / max(t.epochs, 1)
            rate += per_epoch
            size = nbytes.get(obj, 0)
            if size > 0 and per_epoch >= self.hot_threshold * size:
                hot += size
        return TenantDemand(name, resident, min(hot, resident), rate,
                            info.weight)

    def demands(self, epoch: int = 0) -> List[TenantDemand]:
        # sorted Namespace order groups each replica's tenants together;
        # downstream state (detectors, tables, audit, budgets) keys on
        # the short display string
        names = [str(ns) for ns in sorted(self.ledger.tenants)]
        if not self.predictive:
            return [self.demand(t) for t in names]
        return [self._predicted_demand(t, epoch) for t in names]

    # ------------------------------------------------------------------ #
    # prediction                                                         #
    # ------------------------------------------------------------------ #
    def detector(self, tenant: str):
        """The tenant's PhaseDetector (created lazily over its trace;
        None when the tenant has no trace namespace to detect on)."""
        det = self._detectors.get(tenant)
        if det is None:
            trace = self.ledger.trace(tenant)
            if trace is None:
                return None
            from ..telemetry.phases import PhaseDetector
            det = PhaseDetector(
                trace, signature_ttl_epochs=self.signature_ttl_epochs)
            self._detectors[tenant] = det
        return det

    def expected_signature(self, tenant: str, ahead: int = 1):
        """The tenant's predicted recurrence signature ``ahead`` epochs
        past the last completed one (None without a trace/history)."""
        det = self.detector(tenant)
        return det.expected_signature(ahead) if det is not None else None

    def table(self, tenant: str) -> PhaseDemandTable:
        t = self._tables.get(tenant)
        if t is None:
            t = PhaseDemandTable(ttl_epochs=self.signature_ttl_epochs)
            self._tables[tenant] = t
        return t

    def _predicted_demand(self, tenant: str, epoch: int) -> TenantDemand:
        """Demand for the *upcoming* epochs: learn the measured demand
        under the current signature, then grant from the table entries
        of the signatures predicted one and two epochs ahead (max — the
        two-epoch horizon is what lets a pre-staged promotion run the
        epoch *before* a burst).  Reactive fallback throughout."""
        det = self.detector(tenant)
        if det is None:
            return self.demand(tenant)
        det.update()
        sig = det.signature
        # phase-prediction audit: the previous rebalance predicted the
        # signature now live — join it as a hit (1.0) or miss (0.0)
        if self.audit is not None:
            prev_sig = self._predicted_sigs.pop(tenant, None)
            if prev_sig is not None and self.audit.has_pending(
                    "arbiter.phase", tenant):
                self.audit.realize("arbiter.phase", tenant,
                                   1.0 if sig == prev_sig else 0.0)
        # attribute the measurement to the signature's own run so a
        # long window cannot smear the previous phase into this one
        window = self.window_epochs
        if window is not None and det.epochs_in_signature > 0:
            window = min(window, det.epochs_in_signature)
        measured = self.demand(tenant, window=window)
        # demand audit: the grant predicted last rebalance meets the
        # demand the ledger/trace actually observed since
        if self.audit is not None and self.audit.has_pending(
                "arbiter.demand", tenant):
            self.audit.realize("arbiter.demand", tenant,
                               float(measured.hot_bytes))
        table = self.table(tenant)
        if sig is not None:
            table.observe(sig, measured.hot_bytes,
                          measured.bytes_per_step, epoch)
        table.evict_stale(epoch)
        hits = []
        for ahead in (1, 2):
            nxt = det.expected_signature(ahead)
            if ahead == 1 and self.audit is not None and nxt is not None:
                # file the next-phase prediction (value 1.0 = "will
                # match"); joined hit/miss above next rebalance, so the
                # model's accuracy ratio is its live hit rate
                self.audit.predict("arbiter.phase", tenant, 1.0,
                                   epoch=epoch, signature=str(nxt))
                self._predicted_sigs[tenant] = nxt
            if nxt is None:
                continue
            hit = table.lookup(nxt, epoch)
            if hit is not None:
                hits.append(hit)
        if not hits:
            return measured
        hot = max(h.hot_bytes for h in hits)
        rate = max(h.bytes_per_step for h in hits)
        if hot == measured.hot_bytes and rate == measured.bytes_per_step:
            return measured
        self.predicted_grants += 1
        granted = min(int(hot), measured.resident_bytes)
        if self.audit is not None:
            self.audit.predict("arbiter.demand", tenant, float(granted),
                               epoch=epoch)
        return TenantDemand(tenant, measured.resident_bytes, granted,
                            rate, measured.weight, source="predicted")

    # ------------------------------------------------------------------ #
    # split objectives                                                   #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _water_fill(asks: Mapping[str, int], weights: Mapping[str, float],
                    capacity: int) -> Dict[str, int]:
        """Weighted max-min: grant each claimant up to its ask,
        entitlements proportional to weight, redistributing capacity
        freed by satisfied claimants until none is left."""
        grant = {t: 0 for t in asks}
        live = {t for t, a in asks.items() if a > 0}
        left = capacity
        while live and left > 0:
            wsum = sum(weights[t] for t in live)
            step = {t: int(left * weights[t] / wsum) for t in live}
            # integer slack goes to the heaviest claimant
            slack = left - sum(step.values())
            if slack:
                step[max(live, key=lambda t: weights[t])] += slack
            progressed = False
            for t in sorted(live):
                take = min(step[t], asks[t] - grant[t])
                if take > 0:
                    grant[t] += take
                    left -= take
                    progressed = True
                if grant[t] >= asks[t]:
                    live.discard(t)
            if not progressed:
                break
        return grant

    def _split_group(self, demands: List[TenantDemand],
                     asks: Mapping[str, int],
                     capacity: int) -> Dict[str, int]:
        """Objective-specific per-tenant split within one capacity pool."""
        if self.objective == "fair_share":
            w = {d.tenant: 1.0 for d in demands}
            return self._water_fill({d.tenant: asks[d.tenant]
                                     for d in demands}, w, capacity)
        if self.objective == "priority":
            w = {d.tenant: max(d.weight, 1e-9) for d in demands}
            return self._water_fill({d.tenant: asks[d.tenant]
                                     for d in demands}, w, capacity)
        # throughput: fill hot sets in traffic-intensity order
        grant = {d.tenant: 0 for d in demands}
        left = capacity
        for d in sorted(demands, key=lambda d: -d.intensity):
            take = min(asks[d.tenant], left)
            grant[d.tenant] = take
            left -= take
        return grant

    def split(self, demands: List[TenantDemand]) -> Dict[str, int]:
        cap = self.capacity_bytes
        floors = {d.tenant: min(self.floor_bytes, d.resident_bytes)
                  for d in demands}
        cap_after_floor = max(cap - sum(floors.values()), 0)
        asks = {d.tenant: max(d.hot_bytes - floors[d.tenant], 0)
                for d in demands}
        # group tenants by replica: a replica's tenants share that
        # host's physical fast tier, so the split is hierarchical —
        # water-fill capacity across replica groups first (each capped
        # by its physical capacity), then the objective split within
        # each group's grant
        groups: Dict[str, List[TenantDemand]] = {}
        for d in demands:
            groups.setdefault(Namespace.of(d.tenant).replica,
                              []).append(d)
        if len(groups) <= 1 and not self.replica_capacity:
            # single pool (every tenant in one replica, no physical
            # per-host caps): identical to the pre-cluster split
            grant = self._split_group(demands, asks, cap_after_floor)
        else:
            group_ask: Dict[str, int] = {}
            group_cap: Dict[str, int] = {}
            for r, ds in groups.items():
                rc = self.replica_capacity.get(r)
                rc_after_floor = cap_after_floor if rc is None else \
                    max(int(rc) - sum(floors[d.tenant] for d in ds), 0)
                group_cap[r] = rc_after_floor
                group_ask[r] = min(sum(asks[d.tenant] for d in ds),
                                   rc_after_floor)
            group_grant = self._water_fill(
                group_ask, {r: 1.0 for r in groups}, cap_after_floor)
            grant = {}
            for r, ds in sorted(groups.items()):
                grant.update(self._split_group(
                    ds, asks, min(group_grant[r], group_cap[r])))
        # capacity beyond measured demand stays free: handing it out by
        # footprint would just re-enable hoarding by idle tenants — the
        # next rebalance grants it the moment demand shows up
        if self.blame is not None and self.blame_debit > 0.0:
            grant = self._apply_blame_debit(grant, asks)
        return {t: floors[t] + g for t, g in grant.items()}

    def _apply_blame_debit(self, grant: Dict[str, int],
                           asks: Mapping[str, int]) -> Dict[str, int]:
        """Debit high-blame tenants' above-floor grants by their noisy-
        neighbor score, re-water-filling the freed capacity to unblamed
        tenants whose asks were not yet satisfied."""
        grant = dict(grant)
        freed = 0
        scores = {t: self.blame.noisy_neighbor_score(t) for t in grant}
        for t, g in grant.items():
            cut = int(g * min(self.blame_debit * scores[t], 1.0))
            if cut > 0:
                grant[t] = g - cut
                freed += cut
        if freed > 0:
            self.blame_debited_bytes += freed
            residual = {t: max(asks.get(t, 0) - grant[t], 0)
                        for t in grant if scores[t] <= 0.0}
            if residual:
                refill = self._water_fill(
                    residual, {t: 1.0 for t in residual}, freed)
                for t, extra in refill.items():
                    grant[t] += extra
        return grant

    # ------------------------------------------------------------------ #
    def rebalance(self, epoch: int = 0) -> ArbiterDecision:
        """Measure (or predict) demand, split, and push budgets into
        the ledger."""
        demands = self.demands(epoch)
        budgets = self.split(demands)
        for tenant, b in budgets.items():
            self.ledger.set_budget(tenant, self.fast_tier, b)
        d = ArbiterDecision(epoch, self.objective, budgets, demands)
        self.decisions.append(d)
        if self.tracer is not None:
            by_tenant = {dm.tenant: dm for dm in demands}
            for tenant, b in sorted(budgets.items()):
                dm = by_tenant.get(tenant)
                self.tracer.event(
                    "arbiter.grant", cat="arbiter", tid=tenant,
                    epoch=epoch, tenant=tenant, budget_bytes=b,
                    objective=self.objective,
                    hot_bytes=dm.hot_bytes if dm else 0,
                    resident_bytes=dm.resident_bytes if dm else 0,
                    bytes_per_step=dm.bytes_per_step if dm else 0.0,
                    source=dm.source if dm else "measured",
                    blame_score=(self.blame.noisy_neighbor_score(tenant)
                                 if self.blame is not None else 0.0))
        return d
