"""ResidencyLedger: the single source of truth for bytes-per-tier-per-tenant.

"Dissecting CXL Memory Performance at Scale" (arXiv:2409.14317) and
"CXL-Interference" (arXiv:2411.18308) both show that what dominates
performance at scale is contention for the *shared* fast tier and the
shared links — not any one object's placement in isolation.  Arbitrating
that contention requires one consistent view of who holds what, where.
This repo previously kept three disconnected views (TieredArray block
kinds, PagedKVPool block residency, the replanner's realized shares);
the ledger unifies them:

  * every placeable object belongs to a **tenant** namespace (a serving
    engine, an offload trainer, a benchmark workload) and records its
    bytes per tier here — clients call ``record_alloc`` / ``record_free``
    / ``record_move`` as the physical placement changes;
  * per-tenant **budgets** (set by the ``TierBudgetArbiter``) and
    per-tier **capacities** gate placement: ``can_place`` is the one
    admission check promotions everywhere consult;
  * per-tenant **AccessTrace namespaces** attach here, so the arbiter
    and per-tenant replanners read demand from the same place they read
    residency;
  * priced moves ride the shared ``core.migration.MigrationExecutor``
    (topology-aware when one is attached), so every layer prices a byte
    move identically.

Tenant keys are hierarchical ``repro.cluster.Namespace`` values
(``replica/tenant``): the multi-host plane registers each replica's
pool under its own replica component, and glob patterns
(``bytes_on(tier, "replica0/*")``, ``aggregate("*/*")``) roll per-replica
views up to the fleet exactly.  Bare strings keep working — they
normalize to ``default/<tenant>`` through the deprecation shim.

Ownership rule for recording: whoever *physically* moves bytes records
the move (``PagedKVPool.migrate``, ``TieredStateStore.move_fn``).
Objects registered by a planner (``origin="plan"``) have no physical
client, so the planner itself updates their residency from realized
shares.  ``origin`` tracks which regime an object is under; a planner
never overwrites client-owned residency.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple, Union

from ..cluster.namespace import Namespace, is_pattern
from ..core.migration import BlockMove, MigrationExecutor, PlacementDelta
from ..core.tiers import MemoryTier

Share = Tuple[str, float]
# every public entry point accepts either form
TenantKey = Union[str, Namespace]

# effectively-unlimited headroom when neither budget nor capacity binds
UNBOUNDED = 1 << 62


class LedgerError(ValueError):
    """Inconsistent ledger operation (unknown tenant/object, bad bytes)."""


@dataclasses.dataclass
class Tenant:
    """One namespace sharing the pool: weight feeds priority-weighted
    arbitration; ``trace`` is the tenant's AccessTrace namespace."""

    name: str
    weight: float = 1.0
    trace: Optional[object] = None     # telemetry.AccessTrace
    ns: Optional[Namespace] = None     # the structured key


@dataclasses.dataclass
class LedgerCounters:
    allocs: int = 0
    frees: int = 0
    moves: int = 0
    migrated_bytes: int = 0
    denied_moves: int = 0


class ResidencyLedger:
    """Bytes-per-tier-per-tenant accounting with budget/capacity gates."""

    def __init__(self, tiers: Optional[Mapping[str, MemoryTier]] = None,
                 capacity_bytes: Optional[Mapping[str, int]] = None,
                 executor: Optional[MigrationExecutor] = None,
                 topology=None):
        self.tiers = dict(tiers) if tiers else {}
        # optional hard per-tier capacity across ALL tenants; a tier
        # absent here is uncapped (the physical client enforces its own
        # limit, e.g. a pool's block count)
        self.capacity_bytes: Dict[str, int] = dict(capacity_bytes or {})
        self.executor = executor or MigrationExecutor(self.tiers,
                                                      topology=topology)
        self.tenants: Dict[Namespace, Tenant] = {}
        # (tenant namespace, obj) -> {tier: bytes}
        self._res: Dict[Tuple[Namespace, str], Dict[str, int]] = {}
        # (tenant namespace, obj) -> "client" | "plan"
        self._origin: Dict[Tuple[Namespace, str], str] = {}
        # tenant namespace -> {tier: budget bytes} (arbiter-assigned)
        self._budget: Dict[Namespace, Dict[str, int]] = {}
        # tenant namespace -> {tier: bytes}: the sums of ``_res`` that
        # ``bytes_on`` answers from, kept by every write to ``_res`` (a
        # gate per move would otherwise sum over every object: tens of
        # thousands of expert blocks at full MoE width)
        self._tier_bytes: Dict[Namespace, Dict[str, int]] = {}
        self.counters = LedgerCounters()

    def _tally(self, ns: Namespace, before: Mapping[str, int],
               after: Mapping[str, int]) -> None:
        """Account one object's bytes-per-tier change in its tenant's
        per-tier sums."""
        tot = self._tier_bytes.setdefault(ns, {})
        for tier, b in before.items():
            tot[tier] = tot.get(tier, 0) - b
        for tier, b in after.items():
            tot[tier] = tot.get(tier, 0) + b

    # ------------------------------------------------------------------ #
    # tenants                                                            #
    # ------------------------------------------------------------------ #
    def register_tenant(self, name: TenantKey, weight: float = 1.0,
                        trace=None) -> Tenant:
        ns = Namespace.of(name).tenant_key()
        if ns in self.tenants:
            t = self.tenants[ns]
            if trace is not None:
                t.trace = trace
            return t
        t = Tenant(str(ns), weight, trace, ns=ns)
        self.tenants[ns] = t
        return t

    def attach_trace(self, tenant: TenantKey, trace) -> None:
        self.register_tenant(tenant).trace = trace

    def trace(self, tenant: TenantKey):
        t = self.tenants.get(Namespace.of(tenant).tenant_key())
        return t.trace if t is not None else None

    def tenant_info(self, tenant: TenantKey) -> Optional[Tenant]:
        """The Tenant record under any key form (None when absent)."""
        return self.tenants.get(Namespace.of(tenant).tenant_key())

    def _check_tenant(self, ns: Namespace) -> None:
        if ns not in self.tenants:
            raise LedgerError(f"unknown tenant {str(ns)!r}; "
                              f"register_tenant first")

    def tenants_matching(self, pattern: str) -> List[Namespace]:
        """Tenant namespaces matching a glob pattern, in sorted order
        (``"replica0/*"`` — one replica; ``"*/*"`` — the fleet)."""
        return sorted(ns for ns in self.tenants if ns.matches(pattern))

    def replicas(self) -> List[str]:
        """Replica components present among registered tenants."""
        return sorted({ns.replica for ns in self.tenants})

    # ------------------------------------------------------------------ #
    # object registration / accounting                                   #
    # ------------------------------------------------------------------ #
    def has(self, tenant: TenantKey, obj: str) -> bool:
        return (Namespace.of(tenant).tenant_key(), obj) in self._res

    def register(self, tenant: TenantKey, obj: str,
                 placement: Mapping[str, int],
                 origin: str = "client") -> None:
        """Register an object with its initial bytes-per-tier placement.

        Registration is allocation, not migration — no move is priced or
        gated (first touch put the bytes wherever the allocator chose).
        """
        ns = Namespace.of(tenant).tenant_key()
        self._check_tenant(ns)
        key = (ns, obj)
        if key in self._res:
            raise LedgerError(f"{ns.with_obj(obj)} already registered")
        self._res[key] = {t: int(b) for t, b in placement.items()
                          if int(b) > 0}
        self._tally(ns, {}, self._res[key])
        self._origin[key] = origin
        self.counters.allocs += 1

    def retire(self, tenant: TenantKey, obj: str) -> int:
        """Drop an object entirely; returns the bytes released."""
        key = (Namespace.of(tenant).tenant_key(), obj)
        res = self._res.pop(key, None)
        self._origin.pop(key, None)
        if res is None:
            return 0
        self._tally(key[0], res, {})
        self.counters.frees += 1
        return sum(res.values())

    def origin_of(self, tenant: TenantKey, obj: str) -> Optional[str]:
        return self._origin.get((Namespace.of(tenant).tenant_key(), obj))

    def record_alloc(self, tenant: TenantKey, obj: str, tier: str,
                     nbytes: int) -> None:
        """Grow an object on ``tier`` (client allocated more there)."""
        ns = Namespace.of(tenant).tenant_key()
        self._check_tenant(ns)
        if nbytes <= 0:
            return
        key = (ns, obj)
        if key not in self._res:
            self._res[key] = {}
            self._origin[key] = "client"
            self.counters.allocs += 1
        res = self._res[key]
        res[tier] = res.get(tier, 0) + int(nbytes)
        self._tally(ns, {}, {tier: int(nbytes)})

    def record_free(self, tenant: TenantKey, obj: str, tier: str,
                    nbytes: int) -> None:
        """Shrink an object on ``tier`` (client released bytes there)."""
        ns = Namespace.of(tenant).tenant_key()
        key = (ns, obj)
        res = self._res.get(key)
        if res is None:
            return
        have = res.get(tier, 0)
        take = min(int(nbytes), have)
        if take >= have:
            res.pop(tier, None)
        else:
            res[tier] = have - take
        self._tally(ns, {tier: take}, {})
        if not res:
            self.retire(ns, obj)

    def record_move(self, tenant: TenantKey, obj: str, src: str, dst: str,
                    nbytes: int) -> int:
        """Account a move that already physically happened.

        Clamped to the bytes the object actually has on ``src`` (the
        ledger never goes negative); returns the bytes recorded.
        """
        key = (Namespace.of(tenant).tenant_key(), obj)
        res = self._res.get(key)
        if res is None or nbytes <= 0 or src == dst:
            return 0
        moved = min(int(nbytes), res.get(src, 0))
        if moved <= 0:
            return 0
        res[src] -= moved
        if res[src] <= 0:
            res.pop(src, None)
        res[dst] = res.get(dst, 0) + moved
        self._tally(key[0], {src: moved}, {dst: moved})
        self.counters.moves += 1
        self.counters.migrated_bytes += moved
        return moved

    def set_residency(self, tenant: TenantKey, obj: str,
                      placement: Mapping[str, int]) -> None:
        """Overwrite an object's bytes-per-tier (planner realizing a
        replan for a plan-origin object; clients use record_*)."""
        ns = Namespace.of(tenant).tenant_key()
        self._check_tenant(ns)
        key = (ns, obj)
        if key not in self._res:
            self.register(ns, obj, placement, origin="plan")
            return
        before = self._res[key]
        self._res[key] = {t: int(b) for t, b in placement.items()
                          if int(b) > 0}
        self._tally(ns, before, self._res[key])

    def resize(self, tenant: TenantKey, obj: str, new_total: int,
               grow_tier: Optional[str] = None) -> None:
        """Adjust an object's footprint to ``new_total`` bytes
        (plan-origin objects whose inventory drifted).  Growth lands on
        ``grow_tier`` (where a first-touch allocator puts fresh bytes —
        never silently inflating a budgeted fast tier); shrink removes
        proportionally across the current tiers."""
        key = (Namespace.of(tenant).tenant_key(), obj)
        res = self._res.get(key)
        if res is None:
            return
        old_total = sum(res.values())
        if old_total <= 0 or new_total == old_total:
            return
        if new_total > old_total:
            tier = grow_tier if grow_tier is not None \
                else max(res, key=res.get)
            res[tier] = res.get(tier, 0) + (new_total - old_total)
            self._tally(key[0], {}, {tier: new_total - old_total})
            return
        scaled = {t: int(b * new_total / old_total) for t, b in res.items()}
        slack = new_total - sum(scaled.values())
        if scaled and slack:
            # deterministic: remainder to the largest current holder
            scaled[max(scaled, key=scaled.get)] += slack
        self._res[key] = {t: b for t, b in scaled.items() if b > 0}
        self._tally(key[0], res, self._res[key])

    # ------------------------------------------------------------------ #
    # queries                                                            #
    # ------------------------------------------------------------------ #
    def bytes_on(self, tier: str, tenant: Optional[TenantKey] = None) -> int:
        """Bytes resident on ``tier`` — one tenant, a glob pattern
        (``"replica0/*"``), or all tenants when omitted."""
        if tenant is None:
            return sum(tot.get(tier, 0)
                       for tot in self._tier_bytes.values())
        if isinstance(tenant, str) and is_pattern(tenant):
            return sum(tot.get(tier, 0)
                       for tn, tot in self._tier_bytes.items()
                       if tn.matches(tenant))
        ns = Namespace.of(tenant).tenant_key()
        return self._tier_bytes.get(ns, {}).get(tier, 0)

    def aggregate(self, pattern: str = "*/*") -> Dict[str, int]:
        """Bytes-per-tier rolled up over every tenant matching a glob
        pattern — the fleet view (``"*/*"``), one replica
        (``"replica0/*"``), or one logical tenant across replicas
        (``"*/serving"``)."""
        out: Dict[str, int] = {}
        for (tn, _), res in self._res.items():
            if not tn.matches(pattern):
                continue
            for tier, b in res.items():
                out[tier] = out.get(tier, 0) + b
        return out

    def tenant_bytes(self, tenant: TenantKey) -> int:
        if isinstance(tenant, str) and is_pattern(tenant):
            return sum(sum(res.values())
                       for (tn, _), res in self._res.items()
                       if tn.matches(tenant))
        ns = Namespace.of(tenant).tenant_key()
        return sum(sum(res.values()) for (tn, _), res in self._res.items()
                   if tn == ns)

    def object_bytes(self, tenant: TenantKey, obj: str,
                     tier: Optional[str] = None) -> int:
        res = self._res.get((Namespace.of(tenant).tenant_key(), obj), {})
        return res.get(tier, 0) if tier is not None else sum(res.values())

    def objects(self, tenant: TenantKey) -> List[str]:
        ns = Namespace.of(tenant).tenant_key()
        return [o for (tn, o) in self._res if tn == ns]

    def nbytes_by_obj(self, tenant: TenantKey) -> Dict[str, int]:
        ns = Namespace.of(tenant).tenant_key()
        return {o: sum(res.values()) for (tn, o), res in self._res.items()
                if tn == ns}

    def placement(self, tenant: TenantKey, obj: str) -> Dict[str, int]:
        return dict(self._res.get(
            (Namespace.of(tenant).tenant_key(), obj), {}))

    def shares(self, tenant: TenantKey) -> Dict[str, List[Share]]:
        """Fractional per-object shares — the ``PlacementPlan.shares``
        view planners and executors consume."""
        ns = Namespace.of(tenant).tenant_key()
        out: Dict[str, List[Share]] = {}
        for (tn, obj), res in self._res.items():
            if tn != ns:
                continue
            total = sum(res.values())
            if total <= 0:
                continue
            out[obj] = [(t, b / total) for t, b in sorted(res.items())]
        return out

    def tier_occupancy(self, tier: str) -> Dict[str, int]:
        """Per-tenant bytes on one tier (the arbiter's realized view).

        Keys are the short display form (``"a"``, ``"replica0/serving"``).
        """
        out: Dict[str, int] = {str(t): 0 for t in self.tenants}
        for (tn, _), res in self._res.items():
            key = str(tn)
            out[key] = out.get(key, 0) + res.get(tier, 0)
        return out

    # ------------------------------------------------------------------ #
    # budgets & admission                                                #
    # ------------------------------------------------------------------ #
    def set_budget(self, tenant: TenantKey, tier: str, nbytes: int) -> None:
        ns = Namespace.of(tenant).tenant_key()
        self._check_tenant(ns)
        self._budget.setdefault(ns, {})[tier] = max(int(nbytes), 0)

    def budget(self, tenant: TenantKey, tier: str) -> Optional[int]:
        return self._budget.get(
            Namespace.of(tenant).tenant_key(), {}).get(tier)

    def headroom(self, tenant: TenantKey, tier: str) -> int:
        """Bytes ``tenant`` may still place on ``tier`` before its
        budget or the tier's capacity binds (can be negative after an
        arbiter shrinks a budget below current usage)."""
        ns = Namespace.of(tenant).tenant_key()
        room = UNBOUNDED
        b = self.budget(ns, tier)
        if b is not None:
            room = min(room, b - self.bytes_on(tier, ns))
        cap = self.capacity_bytes.get(tier)
        if cap is not None:
            room = min(room, cap - self.bytes_on(tier))
        return room

    def can_place(self, tenant: TenantKey, tier: str, nbytes: int) -> bool:
        return self.headroom(tenant, tier) >= nbytes

    def over_budget(self, tenant: TenantKey, tier: str) -> int:
        """Bytes above the tenant's budget on ``tier`` (0 if within)."""
        ns = Namespace.of(tenant).tenant_key()
        b = self.budget(ns, tier)
        if b is None:
            return 0
        return max(self.bytes_on(tier, ns) - b, 0)

    def over_budget_tenants(self, tier: str) -> Dict[str, int]:
        """Every tenant currently above its budget on ``tier`` — the
        view budget-compliance enforcers (scheduler preemption, state
        demotion) poll after an arbiter shrink."""
        out: Dict[str, int] = {}
        for t in self.tenants:
            over = self.over_budget(t, tier)
            if over > 0:
                out[str(t)] = over
        return out

    # ------------------------------------------------------------------ #
    # priced, gated moves                                                #
    # ------------------------------------------------------------------ #
    def move(self, tenant: TenantKey, obj: str, src: str, dst: str,
             nbytes: int, move_fn=None) -> Tuple[int, float]:
        """Move bytes of one object between tiers through the shared
        executor: gate on ``can_place``, price over the topology, apply
        through ``move_fn`` (physical) or account directly, and record.

        Returns (bytes moved, priced seconds).
        """
        ns = Namespace.of(tenant).tenant_key()
        self._check_tenant(ns)
        want = min(int(nbytes), self.object_bytes(ns, obj, src))
        grant = min(want, max(self.headroom(ns, dst), 0))
        if grant <= 0:
            self.counters.denied_moves += 1
            return 0, 0.0
        mv = BlockMove(obj, src, dst, grant)
        cost = self.executor.cost_s(PlacementDelta([mv]))
        # a block-granular physical client may round the grant up to
        # one whole block; report what it actually moved (its
        # record_move calls are the residency truth), never a clamp
        done = grant if move_fn is None else max(int(move_fn(
            obj, src, dst, grant)), 0)
        if done <= 0:
            self.counters.denied_moves += 1
            return 0, 0.0
        if move_fn is None:
            # no physical client: the ledger itself is the record
            self.record_move(ns, obj, src, dst, done)
        return done, cost

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        tiers = sorted({t for res in self._res.values() for t in res})
        out: Dict[str, float] = {
            "tenants": float(len(self.tenants)),
            "objects": float(len(self._res)),
            "moves": float(self.counters.moves),
            "migrated_bytes": float(self.counters.migrated_bytes),
            "denied_moves": float(self.counters.denied_moves),
        }
        for t in tiers:
            out[f"bytes_on.{t}"] = float(self.bytes_on(t))
        return out

    def publish(self, registry, prefix: str = "ledger") -> int:
        """Publish the summary plus per-tenant residency and budgets
        into a repro.obs.MetricsRegistry as gauges; returns the number
        of gauges set.  Gauge names use the short tenant form, so
        cluster tenants publish under ``<prefix>.<replica>/<tenant>.*``
        while single-host names are unchanged."""
        n = registry.set_gauges(self.summary(), prefix=prefix)
        tiers = sorted({t for res in self._res.values() for t in res})
        for ns in sorted(self.tenants):
            tenant = str(ns)
            for tier in tiers:
                registry.gauge(
                    f"{prefix}.{tenant}.bytes_on.{tier}").set(
                        float(self.bytes_on(tier, ns)))
                n += 1
            for tier, b in sorted(self._budget.get(ns, {}).items()):
                registry.gauge(
                    f"{prefix}.{tenant}.budget.{tier}").set(float(b))
                n += 1
        return n
