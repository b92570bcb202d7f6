"""PyTorch-port copy of ``repro.obs.qos`` (framework-free).

Interference-class QoS plane: blame attribution + violation prediction.

The SLO monitor can count a tail excursion; this module says *which
link* and *which neighbor* caused it, and predicts the next one before
admission lets it happen:

- :class:`BlameLedger` — every tenant's control plane publishes its
  current gather/write flows here (class- and tenant-tagged
  ``topology.Flow``s).  When an :class:`~repro.obs.slo.SLOMonitor`
  violation fires, ``on_violation`` joins the victim's *bottleneck
  link* (the highest class-weighted utilization hop on its paths at
  violation time) with the co-located tenants' offered load on that
  link, records the excursion, and names the **antagonist** — the
  neighbor applying the most interference-weighted pressure to the
  victim's traffic.  Exports ``qos.blame.<tenant>.<link>.<class>``
  gauges, a per-tenant ``noisy_neighbor_score``, and a structured
  ``blame_report()``.

- :class:`ViolationPredictor` — estimates each tenant's tail latency
  under a candidate flow set from the class-aware contention model
  (``TopologyGraph.contended_flows`` with the asymmetric
  :class:`~repro.topology.InterferenceMatrix`): a tenant's predicted
  p99 is its uncontended baseline scaled by the offered-weighted
  slowdown of its flows.  Admission and preemption gate on predicted
  violation instead of a flat link-efficiency floor, and every
  forecast is audited end-to-end through the
  :class:`~repro.obs.audit.PredictionLedger` as the ``qos.violation``
  model.

Everything is zero-dependency, bounded-memory, and clock-injected,
like the rest of ``repro.obs``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from ..cluster.namespace import Namespace

__all__ = ["BlameLedger", "Excursion", "ViolationPredictor",
           "QOS_VIOLATION_MODEL", "QOS_VIOLATION_TOLERANCE"]


def _norm(tenant: Any) -> str:
    """Canonical short-form tenant key (``"a"``, ``"replica0/serving"``).

    The blame book and predictor key every structure by this form, so a
    caller passing ``Namespace("replica0", "serving")`` and one passing
    the equivalent string blame/score the same tenant."""
    return str(Namespace.of(tenant).tenant_key())

# the audit model name every qos.violation forecast files under, and
# the accuracy tolerance it is judged at (tail latency under queueing
# is noisier than byte-counting move times)
QOS_VIOLATION_MODEL = "qos.violation"
QOS_VIOLATION_TOLERANCE = 0.35


@dataclasses.dataclass
class Excursion:
    """One SLO violation joined to its bottleneck link and neighbors."""

    now: float
    victim: str                     # tenant whose SLO fired
    metric: str                     # e.g. "decode_latency.p99"
    observed_s: float
    threshold_s: float
    link: Optional[Tuple[str, str]]  # bottleneck LinkKey (None: no path)
    link_kind: str = ""
    rho: float = 0.0                # victim's weighted utilization there
    antagonist: Optional[str] = None
    # co-located offered load on the bottleneck link at violation time,
    # keyed by (tenant, interference class), GB/s
    loads: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict)
    # interference-weighted pressure each neighbor applied to the
    # victim's traffic class on that link (the blame mass)
    pressure: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _FlowSnapshot:
    now: float
    flows: List[Any]


class BlameLedger:
    """Join SLO violations to bottleneck links and noisy neighbors.

    ``publish_flows`` keeps the latest class-tagged flow snapshot per
    tenant (each control plane publishes its own every epoch);
    ``on_violation`` — wired as an ``SLOMonitor`` violation hook —
    recomputes the contended state over the union of snapshots, finds
    the victim's worst class-weighted link, and splits the blame over
    the neighbors by their interference-weighted pressure there.
    """

    def __init__(self, topology, registry=None, tracer=None,
                 clock: Optional[Callable[[], float]] = None,
                 max_excursions: int = 512):
        self.topology = topology
        self.registry = registry
        self.tracer = tracer
        self.clock = clock if clock is not None else (lambda: 0.0)
        self._snapshots: Dict[str, _FlowSnapshot] = {}
        self.excursions: Deque[Excursion] = deque(
            maxlen=int(max_excursions))
        # accumulated blame mass per antagonist tenant, and how many
        # excursions each tenant was the victim of
        self._blame_mass: Dict[str, float] = {}
        self._victim_count: Dict[str, int] = {}
        self.total_excursions = 0

    # ------------------------------------------------------------------ #
    # flow book                                                          #
    # ------------------------------------------------------------------ #
    def publish_flows(self, tenant: str, flows: Sequence[Any],
                      now: Optional[float] = None) -> None:
        """Record ``tenant``'s current offered flows (replaces its
        previous snapshot).  Flows are re-tagged with the publishing
        tenant so attribution cannot be spoofed by a stale tag."""
        now = float(self.clock() if now is None else now)
        tenant = _norm(tenant)
        tagged = [dataclasses.replace(f, tenant=tenant) for f in flows]
        self._snapshots[tenant] = _FlowSnapshot(now, tagged)
        if self.registry is not None:
            for key, per in self.topology.link_loads(tagged).items():
                link = f"{key[0]}-{key[1]}"
                for (t, cls), gbps in per.items():
                    self.registry.gauge(
                        f"qos.offered.{t}.{link}.{cls}",
                        help="offered load per tenant/link/class "
                             "(GB/s)").set(gbps)

    def flows(self, exclude: Optional[str] = None) -> List[Any]:
        """The current flow union (optionally minus one tenant — a
        scheduler merging its *live* flows must drop its own possibly
        stale snapshot)."""
        out: List[Any] = []
        if exclude is not None:
            exclude = _norm(exclude)
        for tenant, snap in sorted(self._snapshots.items()):
            if tenant == exclude:
                continue
            out.extend(snap.flows)
        return out

    def tenants(self) -> List[str]:
        return sorted(self._snapshots)

    # ------------------------------------------------------------------ #
    # violation join                                                     #
    # ------------------------------------------------------------------ #
    def _victim_bottleneck(self, victim_flows: Sequence[Any],
                           all_flows: Sequence[Any]):
        """The victim's worst class-weighted link: (LinkKey, kind, rho).

        Recomputed from the flow book at violation time — the same
        pricing admission used, so blame and control agree."""
        g = self.topology
        m = g.interference
        loads = g.link_loads(all_flows)
        worst = (None, "", 0.0)
        for f in victim_flows:
            for link in g.path(f.src, f.dst):
                per = loads.get(link.key, {})
                wtotal = sum(m.weight(link.kind, f.cls, cls,
                                      link=link.key) * gbps
                             for (_t, cls), gbps in per.items())
                rho = wtotal / link.bw_GBps
                if rho > worst[2]:
                    worst = (link.key, link.kind, rho)
        return worst

    def on_violation(self, victim: str, metric: str, observed_s: float,
                     threshold_s: float,
                     now: Optional[float] = None) -> Optional[Excursion]:
        """Join one SLO violation to its bottleneck link + neighbors.

        Returns the recorded :class:`Excursion` (None when the victim
        has no published flows to attribute against)."""
        now = float(self.clock() if now is None else now)
        victim = _norm(victim)
        snap = self._snapshots.get(victim)
        if snap is None or not snap.flows:
            return None
        all_flows = self.flows()
        key, kind, rho = self._victim_bottleneck(snap.flows, all_flows)
        ex = Excursion(now=now, victim=victim, metric=metric,
                       observed_s=float(observed_s),
                       threshold_s=float(threshold_s),
                       link=key, link_kind=kind, rho=rho)
        if key is not None:
            per = self.topology.link_loads(all_flows).get(key, {})
            ex.loads = dict(per)
            m = self.topology.interference
            # pressure a neighbor applies to the victim's class mix on
            # this link: its offered load weighted by the interference
            # matrix against each victim flow class crossing the link
            victim_classes = sorted({f.cls for f in snap.flows})
            for (tenant, cls), gbps in per.items():
                if tenant == victim:
                    continue
                w = max(m.weight(kind, vc, cls, link=key)
                        for vc in victim_classes)
                ex.pressure[tenant] = ex.pressure.get(tenant, 0.0) \
                    + w * gbps
            if ex.pressure:
                ex.antagonist = max(ex.pressure, key=ex.pressure.get)
        self.excursions.append(ex)
        self.total_excursions += 1
        self._victim_count[victim] = self._victim_count.get(victim, 0) + 1
        total_pressure = sum(ex.pressure.values())
        for tenant, p in ex.pressure.items():
            share = p / total_pressure if total_pressure > 0 else 0.0
            self._blame_mass[tenant] = \
                self._blame_mass.get(tenant, 0.0) + share
        if self.registry is not None:
            link = f"{key[0]}-{key[1]}" if key else "none"
            self.registry.counter(
                "qos.excursions",
                help="SLO violations joined to a bottleneck link").inc()
            for (tenant, cls), gbps in ex.loads.items():
                if tenant == victim:
                    continue
                self.registry.gauge(
                    f"qos.blame.{tenant}.{link}.{cls}",
                    help="co-located offered load at violation time "
                         "(GB/s)").set(gbps)
            for tenant in self.tenants():
                self.registry.gauge(
                    f"qos.noisy_neighbor.{tenant}",
                    help="blame mass per excursion").set(
                        self.noisy_neighbor_score(tenant))
        if self.tracer is not None:
            self.tracer.event(
                "qos.blame", cat="qos", ts=now, victim=victim,
                metric=metric, observed_s=float(observed_s),
                threshold_s=float(threshold_s),
                link=f"{key[0]}-{key[1]}" if key else None,
                link_kind=kind, rho=rho, antagonist=ex.antagonist,
                pressure={t: round(p, 3)
                          for t, p in sorted(ex.pressure.items())})
        return ex

    # ------------------------------------------------------------------ #
    # scores + report                                                    #
    # ------------------------------------------------------------------ #
    def noisy_neighbor_score(self, tenant: str) -> float:
        """Fraction of recorded excursions this tenant was blamed for
        (blame-mass share summed over excursions / total excursions) —
        0.0 for a clean tenant, toward 1.0 for the sole antagonist of
        every tail excursion."""
        if self.total_excursions <= 0:
            return 0.0
        return min(self._blame_mass.get(_norm(tenant), 0.0)
                   / self.total_excursions, 1.0)

    def blame_report(self) -> Dict[str, Any]:
        """Structured report naming the antagonist per tail excursion."""
        counts: Dict[Tuple[str, str], int] = {}
        for ex in self.excursions:
            if ex.antagonist is not None and ex.link is not None:
                k = (ex.antagonist, f"{ex.link[0]}-{ex.link[1]}")
                counts[k] = counts.get(k, 0) + 1
        top = max(counts, key=counts.get) if counts else (None, None)
        return {
            "excursions": [
                {"now": ex.now, "victim": ex.victim, "metric": ex.metric,
                 "observed_s": ex.observed_s,
                 "threshold_s": ex.threshold_s,
                 "link": (f"{ex.link[0]}-{ex.link[1]}"
                          if ex.link else None),
                 "link_kind": ex.link_kind, "rho": ex.rho,
                 "antagonist": ex.antagonist,
                 "loads_GBps": {f"{t}/{c}": v
                                for (t, c), v in sorted(ex.loads.items())}}
                for ex in self.excursions],
            "total_excursions": self.total_excursions,
            "victims": dict(sorted(self._victim_count.items())),
            "noisy_neighbor_scores": {
                t: self.noisy_neighbor_score(t) for t in self.tenants()},
            "top_antagonist": top[0],
            "top_link": top[1],
        }

    def summary(self) -> Dict[str, float]:
        """Flat numeric summary (telemetry publication)."""
        out = {"qos.excursions": float(self.total_excursions)}
        for t in self.tenants():
            out[f"qos.noisy_neighbor.{t}"] = self.noisy_neighbor_score(t)
        return out


class ViolationPredictor:
    """Predict per-tenant tail latency from the class-aware flow model.

    The model: a tenant's tail latency scales with the offered-weighted
    *slowdown* of its flows under contention — per flow the worse of
    the loaded-latency stretch (queueing) and the bandwidth stretch
    (offered / achieved).  ``set_baseline`` anchors the scale: the
    tenant's uncontended tail latency at slowdown ``base_slowdown``
    (1.0 = unloaded), so

        predicted_p99 = baseline_p99 * slowdown(now) / base_slowdown.

    Admission asks ``violations()``: does any tenant with a registered
    target exceed its threshold under the candidate flow union?  Every
    ``file_prediction`` is joined by ``realize`` through the audit
    ledger under the ``qos.violation`` model.
    """

    def __init__(self, topology, blame: Optional[BlameLedger] = None,
                 audit=None, headroom: float = 1.0):
        self.topology = topology
        self.blame = blame
        self.audit = audit
        # admission safety factor: deny when predicted exceeds
        # headroom * threshold (headroom < 1 reserves margin)
        self.headroom = float(headroom)
        self.targets: Dict[str, float] = {}
        self.baselines: Dict[str, float] = {}
        self._base_slowdown: Dict[str, float] = {}
        if audit is not None and hasattr(audit, "set_model_tolerance"):
            audit.set_model_tolerance(QOS_VIOLATION_MODEL,
                                      QOS_VIOLATION_TOLERANCE)

    # ------------------------------------------------------------------ #
    def set_target(self, tenant: str, threshold_s: float) -> None:
        self.targets[_norm(tenant)] = float(threshold_s)

    def set_baseline(self, tenant: str, p99_s: float,
                     base_slowdown: float = 1.0) -> None:
        tenant = _norm(tenant)
        self.baselines[tenant] = float(p99_s)
        self._base_slowdown[tenant] = max(float(base_slowdown), 1e-9)

    def observe_p99(self, tenant: str, p99_s: float) -> None:
        """Online baseline learning: keep the best (lowest) observed
        tail as the tenant's uncontended anchor."""
        if not p99_s > 0.0:
            return
        tenant = _norm(tenant)
        cur = self.baselines.get(tenant)
        if cur is None or p99_s < cur:
            self.baselines[tenant] = float(p99_s)
            self._base_slowdown.setdefault(tenant, 1.0)

    # ------------------------------------------------------------------ #
    def _merged(self, extra_flows: Sequence[Any],
                exclude: Optional[str]) -> List[Any]:
        flows = list(extra_flows)
        if self.blame is not None:
            flows.extend(self.blame.flows(exclude=exclude))
        return flows

    def tenant_slowdowns(self, flows: Sequence[Any]) -> Dict[str, float]:
        """Offered-weighted mean per-flow slowdown per tenant under the
        class-aware contention model."""
        if not flows:
            return {}
        results = self.topology.contended_flows(flows)
        agg: Dict[str, List[float]] = {}
        for f, r in zip(flows, results):
            unloaded = sum(l.latency_ns
                           for l in self.topology.path(f.src, f.dst))
            lat_stretch = (r.latency_ns / unloaded
                           if unloaded > 0 else 1.0)
            bw_stretch = f.offered_GBps / max(r.achieved_GBps, 1e-12)
            s = max(lat_stretch, bw_stretch, 1.0)
            a = agg.setdefault(_norm(f.tenant), [0.0, 0.0])
            a[0] += s * f.offered_GBps
            a[1] += f.offered_GBps
        return {t: n / max(d, 1e-12) for t, (n, d) in agg.items()}

    def predict_p99s(self, extra_flows: Sequence[Any] = (),
                     exclude: Optional[str] = None) -> Dict[str, float]:
        """Predicted tail latency per tenant with a baseline, under
        ``extra_flows`` merged with the blame book (minus ``exclude``)."""
        flows = self._merged(extra_flows, exclude)
        slow = self.tenant_slowdowns(flows)
        out: Dict[str, float] = {}
        for tenant, base in self.baselines.items():
            s = slow.get(tenant)
            if s is None:
                continue               # tenant idle: baseline holds
            out[tenant] = base * s / self._base_slowdown.get(tenant, 1.0)
        return out

    def predict_p99(self, tenant: str, extra_flows: Sequence[Any] = (),
                    exclude: Optional[str] = None) -> Optional[float]:
        return self.predict_p99s(extra_flows, exclude).get(_norm(tenant))

    def violations(self, extra_flows: Sequence[Any] = (),
                   exclude: Optional[str] = None
                   ) -> Dict[str, Tuple[float, float]]:
        """Tenants whose predicted tail exceeds their target under the
        candidate flow union: {tenant: (predicted_s, threshold_s)}."""
        out: Dict[str, Tuple[float, float]] = {}
        for tenant, pred in self.predict_p99s(extra_flows,
                                              exclude).items():
            thr = self.targets.get(tenant)
            if thr is not None and pred > thr * self.headroom:
                out[tenant] = (pred, thr)
        return out

    def admission_ok(self, own_flows: Sequence[Any],
                     exclude: Optional[str] = None) -> bool:
        """Would this flow set (own running + pending + candidate, on
        top of the book's other tenants) keep every registered target
        satisfied?"""
        return not self.violations(own_flows, exclude)

    # ------------------------------------------------------------------ #
    # audit joins (model: qos.violation)                                 #
    # ------------------------------------------------------------------ #
    def file_prediction(self, key, tenant: str,
                        extra_flows: Sequence[Any] = (),
                        exclude: Optional[str] = None,
                        epoch: Optional[int] = None) -> Optional[float]:
        """File the tenant's predicted tail under ``key`` for a later
        ``realize`` join; returns the predicted value (None when the
        tenant has no baseline or no live flows)."""
        tenant = _norm(tenant)
        pred = self.predict_p99(tenant, extra_flows, exclude)
        if pred is not None and self.audit is not None:
            self.audit.predict(QOS_VIOLATION_MODEL, (tenant, key), pred,
                               epoch=epoch, tenant=tenant)
        return pred

    def realize(self, key, tenant: str, observed_s: float):
        """Join a filed prediction with the measured tail latency."""
        if self.audit is None:
            return None
        return self.audit.realize(QOS_VIOLATION_MODEL, (_norm(tenant), key),
                                  float(observed_s))
