"""PyTorch-port copy of ``repro.obs.calibrate``: the transfer probes
time the port's own copies; the rest is framework-free.

Self-calibrating cost model: fit the topology to measured reality.

Topology builders encode vendor-typical numbers; production hardware
drifts per vendor, per socket distance, even per DIMM population
(the paper's Fig. 2 latencies differ across all three systems).
"Dissecting CXL Memory Performance at Scale" (arxiv 2409.14317) closes
the gap with a measure->model->optimize loop; this module is that loop
for the repro's planners, in two stages:

1. **Startup probe fit** — :func:`probe_testbed` (analytic, for benches
   that know the "true" perturbed testbed) or
   :func:`measure_transfer_probes` (copies from the engine's device
   into each memory kind, timed with CUDA events on the card) yield
   per-tier end-to-end latency/bandwidth observations from the
   compute origin.
   :meth:`CostModelCalibrator.fit_probes` turns them into per-link
   corrections (additive latency, multiplicative bandwidth): tiers are
   processed nearest-first and each tier's residual lands on the final
   (tier-specific) link of its path, so corrections stay end-to-end
   exact per tier even when attribution onto a shared earlier hop is
   ambiguous.  Tiers without a graph path calibrate their descriptor
   directly.

2. **Online EWMA loop** — audit residuals from the
   :class:`~repro.obs.audit.PredictionLedger` (realized/predicted move
   -time ratios) feed :meth:`observe_time_ratio`, which nudges a
   bandwidth scale per tier (and a global one): ``s <- (1-a)*s +
   a*(s/r)`` converges to the true bandwidth ratio, so sustained
   mispredictions self-correct without a re-probe.  Scales are clamped
   to ``[min_scale, max_scale]`` so one wild wall-clock sample cannot
   wreck the model.

:meth:`calibrated_graph` / :meth:`calibrated_tiers` thread the
corrected parameters into ``TopologyGraph.effective_tiers``,
``plan_step_cost``, and ``MigrationExecutor`` — migration pricing,
replan verdicts, and fluid move schedules all run on measured numbers.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, Hashable, Iterable, List, Mapping, Optional, Tuple

import torch

from ..core.tiered_array import DeviceLike, empty_on, resolve_device
from ..core.tiers import MemoryTier

__all__ = ["TierProbe", "LinkCorrection", "CostModelCalibrator",
           "probe_testbed", "measure_transfer_probes", "probed_kind_bases"]


@dataclasses.dataclass(frozen=True)
class TierProbe:
    """One measured end-to-end observation of a tier from the origin.

    ``latency_ns`` may be None when the probe method cannot observe
    latency (bulk-transfer timing measures bandwidth only)."""

    tier: str
    bw_GBps: float
    latency_ns: Optional[float] = None


@dataclasses.dataclass
class LinkCorrection:
    """Fitted correction for one link (or one tier descriptor)."""

    latency_add_ns: float = 0.0
    bw_scale: float = 1.0


def probe_testbed(graph, tiers: Mapping[str, MemoryTier],
                  origin: Optional[str] = None, noise: float = 0.0,
                  samples: int = 1, seed: int = 0) -> List[TierProbe]:
    """Analytic probes against a (possibly perturbed) "true" testbed.

    Plays the role of an MLC/STREAM run on real hardware: reports each
    tier's effective unloaded latency and peak bandwidth as seen from
    ``origin``, with optional multiplicative measurement noise
    (uniform in ``±noise``) so downstream fits must average."""
    rng = random.Random(seed)
    eff = graph.effective_tiers(tiers, origin) if graph is not None \
        else dict(tiers)
    out: List[TierProbe] = []
    for name, tier in sorted(eff.items()):
        for _ in range(max(1, int(samples))):
            jl = 1.0 + noise * rng.uniform(-1.0, 1.0)
            jb = 1.0 + noise * rng.uniform(-1.0, 1.0)
            out.append(TierProbe(
                name,
                bw_GBps=tier.peak_bw_GBps * jb,
                latency_ns=(tier.unloaded_latency_ns
                            + tier.hop_latency_ns) * jl))
    return out


def measure_transfer_probes(kinds: Iterable[str] = ("pinned_host",
                                                    "unpinned_host"),
                            n_mb: int = 32, iters: int = 3,
                            device: DeviceLike = None) -> List[TierProbe]:
    """Copy bandwidth from ``device`` into each memory kind, in GB/s
    (bytes copied per second / 1e9).

    For each kind, an ``n_mb`` MiB destination buffer is allocated once
    and written by one warm-up copy, then ``iters`` copies of an
    ``n_mb`` MiB buffer on the device are timed together.  On CUDA the
    time is taken with CUDA events around the copies on the current
    stream (``device`` to ``device`` for the device kind, a DMA into
    page-locked or pageable host memory for the host kinds).  Under a
    CPU engine the kinds are logical CPU memory and the synchronous
    copies are timed with the host clock.  A kind that cannot be probed
    raises; none is skipped.
    """
    dev = resolve_device(device)
    nbytes = n_mb * 1024 * 1024
    src = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    out: List[TierProbe] = []
    for kind in kinds:
        dst = empty_on(kind, (nbytes,), torch.uint8, dev)
        dst.copy_(src)                              # warm-up
        n = max(1, iters)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(n):
                dst.copy_(src)
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                dst.copy_(src)
            dt = time.perf_counter() - t0
        if not dt > 0.0:
            raise RuntimeError(f"transfer probe of {kind!r} measured "
                               f"{dt} s for {n} copies")
        out.append(TierProbe(kind, bw_GBps=n * nbytes / dt / 1e9))
    return out


def probed_kind_bases(kinds: Iterable[str], device: DeviceLike = None
                      ) -> Dict[str, MemoryTier]:
    """MemoryTier descriptors of memory ``kinds`` of ``device``, built
    from transfer probes (``measure_transfer_probes``).

    A bulk copy observes bandwidth only, so every other field is
    derived from it:

      * ``peak_bw_GBps`` and ``stream_bw_GBps``: the probed copy rate.
        One copy stream reaches it, so ``saturation_streams`` is 1;
      * ``unloaded_latency_ns``: the time of one 64-byte line at that
        rate (64 / rate).  It is not a latency: it orders the tiers by
        the one thing the probe saw, fastest first.  The planner uses
        latency only for random access, and the traffic it plans
        streams;
      * ``capacity_GiB``: 0; the caller sets it;
      * ``kind``: ``hbm`` for the device, ``host`` for host memory.

    Under a CPU engine the kinds are logical CPU memory and the probes
    time CPU copies.
    """
    probes = measure_transfer_probes(kinds=tuple(kinds), device=device)
    return {p.tier: MemoryTier(p.tier, 64.0 / p.bw_GBps, p.bw_GBps,
                               p.bw_GBps, 0.0,
                               kind="hbm" if p.tier == "device" else "host")
            for p in probes}


class CostModelCalibrator:
    """Per-link/tier corrections fitted from probes + audit residuals."""

    def __init__(self, tiers: Mapping[str, MemoryTier], graph=None,
                 origin: Optional[str] = None, ewma_alpha: float = 0.3,
                 min_scale: float = 0.05, max_scale: float = 20.0):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if not 0.0 < min_scale <= 1.0 <= max_scale:
            raise ValueError("need min_scale <= 1.0 <= max_scale")
        self.base_tiers: Dict[str, MemoryTier] = dict(tiers)
        self.graph = graph
        self.origin = origin if origin is not None else \
            (graph.origin if graph is not None else None)
        self.alpha = float(ewma_alpha)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.link_corr: Dict[Tuple[str, str], LinkCorrection] = {}
        self.tier_corr: Dict[str, LinkCorrection] = {}
        self._link_owner: Dict[Tuple[str, str], str] = {}
        # online EWMA bandwidth scales; "*" is the unattributed bucket
        self.online_scale: Dict[Hashable, float] = {}
        # online interference-pair scales keyed
        # (link_kind, victim_cls, aggressor_cls)
        self.interference_scale: Dict[Tuple[str, str, str], float] = {}
        self.fitted = False
        self.probes_fit = 0
        self.observations = 0

    # ------------------------------------------------------------------ #
    # startup fit                                                        #
    # ------------------------------------------------------------------ #
    def fit_probes(self, probes: Iterable[TierProbe]) -> int:
        """Fit link/tier corrections from probe observations.

        Multiple probes of one tier are averaged first.  Tiers are
        processed nearest-first (path hop count) so shared upstream
        links are priced before the tiers behind them; each tier's
        remaining residual lands on the last link of its path — the
        link only that tier crosses — keeping every tier's *end-to-end*
        calibrated numbers exact.  When two tier names alias one node
        (e.g. pinned/unpinned host behind one PCIe link) the second
        tier's residual goes onto its descriptor instead of re-writing
        the shared link."""
        by_tier: Dict[str, List[TierProbe]] = {}
        for p in probes:
            if p.tier in self.base_tiers and p.bw_GBps > 0.0:
                by_tier.setdefault(p.tier, []).append(p)
        if not by_tier:
            return 0

        def hops(t: str) -> int:
            if self.graph is None:
                return 0
            return len(self.graph.tier_links(t, self.origin))

        for tier_name in sorted(by_tier, key=lambda t: (hops(t), t)):
            ps = by_tier[tier_name]
            bw = sum(p.bw_GBps for p in ps) / len(ps)
            lats = [p.latency_ns for p in ps if p.latency_ns is not None]
            lat = sum(lats) / len(lats) if lats else None
            self._fit_one(tier_name, bw, lat)
            self.probes_fit += len(ps)
        self.fitted = True
        return sum(len(v) for v in by_tier.values())

    def _fit_one(self, name: str, bw: float,
                 lat: Optional[float]) -> None:
        tier = self.base_tiers[name]
        path = (self.graph.tier_links(name, self.origin)
                if self.graph is not None else [])
        if not path:
            # local / unmapped tier: calibrate the descriptor itself
            corr = self.tier_corr.setdefault(name, LinkCorrection())
            corr.bw_scale = self._clamp(bw / tier.peak_bw_GBps)
            if lat is not None:
                corr.latency_add_ns = lat - (tier.unloaded_latency_ns
                                             + tier.hop_latency_ns)
            return
        last = path[-1]
        owner = self._link_owner.get(last.key)
        if owner is not None and owner != name:
            # shared terminal link (tier alias): residual on the tier,
            # priced against the already-corrected path
            corr = self.tier_corr.setdefault(name, LinkCorrection())
            corr.bw_scale = self._clamp(bw / tier.peak_bw_GBps)
            if lat is not None:
                exp = tier.unloaded_latency_ns + sum(
                    l.latency_ns + self._link(l.key).latency_add_ns
                    for l in path)
                corr.latency_add_ns = lat - exp
            return
        self._link_owner[last.key] = name
        lcorr = self.link_corr.setdefault(last.key, LinkCorrection())
        lcorr.bw_scale = self._clamp(bw / last.bw_GBps)
        if lat is not None:
            exp = tier.unloaded_latency_ns + sum(
                l.latency_ns + self._link(l.key).latency_add_ns
                for l in path[:-1])
            # additive on top of the base link latency, floored so the
            # corrected link never goes negative
            lcorr.latency_add_ns = max(lat - exp, 0.0) - last.latency_ns
        # un-cap the descriptor when the card measured faster than the
        # builder's peak — effective_tiers mins against tier.peak
        if bw > tier.peak_bw_GBps:
            tcorr = self.tier_corr.setdefault(name, LinkCorrection())
            tcorr.bw_scale = self._clamp(bw / tier.peak_bw_GBps)

    def set_tier_bandwidth(self, tier: str, bw_GBps: float) -> None:
        """Direct bandwidth override from one measured probe (keeps the
        tier's current calibrated latency)."""
        if tier not in self.base_tiers or bw_GBps <= 0.0:
            return
        self._fit_one(tier, float(bw_GBps), None)
        self.fitted = True
        self.probes_fit += 1

    def _link(self, key) -> LinkCorrection:
        return self.link_corr.get(key) or LinkCorrection()

    def _clamp(self, scale: float) -> float:
        return min(max(float(scale), self.min_scale), self.max_scale)

    # ------------------------------------------------------------------ #
    # online loop                                                        #
    # ------------------------------------------------------------------ #
    def observe_time_ratio(self, ratio: float,
                           tiers: Optional[Iterable[str]] = None,
                           alpha: Optional[float] = None) -> None:
        """Feed one realized/predicted time ratio from the audit plane.

        ``ratio > 1`` means the move ran slower than the calibrated
        model promised: the involved tiers' bandwidth scales shrink
        toward ``s/ratio`` (the fixed point where predictions match).
        With no tier attribution the global ``"*"`` scale absorbs it."""
        r = float(ratio)
        if not (r > 0.0) or r != r or r == float("inf"):
            return
        a = self.alpha if alpha is None else float(alpha)
        keys = [t for t in (tiers or []) if t in self.base_tiers] \
            or ["*"]
        for k in keys:
            s = self.online_scale.get(k, 1.0)
            self.online_scale[k] = self._clamp(
                (1.0 - a) * s + a * (s / r))
        self.observations += 1

    def _online(self, tier: str) -> float:
        return self._clamp(self.online_scale.get(tier, 1.0)
                           * self.online_scale.get("*", 1.0))

    def observe_interference(self, link_kind: str, victim_cls: str,
                             aggressor_cls: str, ratio: float,
                             alpha: Optional[float] = None) -> None:
        """Feed one realized/predicted slowdown ratio for a victim/
        aggressor class pair on a link kind.

        ``ratio > 1`` means contention hit harder than the interference
        matrix modeled: the pair's scale grows toward ``s * ratio`` so
        the class-aware ``contended_flows`` prices the pair hotter next
        time.  Scales are clamped like bandwidth scales."""
        r = float(ratio)
        if not (r > 0.0) or r != r or r == float("inf"):
            return
        a = self.alpha if alpha is None else float(alpha)
        key = (str(link_kind), str(victim_cls), str(aggressor_cls))
        s = self.interference_scale.get(key, 1.0)
        self.interference_scale[key] = self._clamp(
            (1.0 - a) * s + a * (s * r))
        self.observations += 1

    def calibrated_interference(self, base=None):
        """Interference matrix with the online pair scales applied on
        top of ``base`` (default: the graph's matrix, or the stock
        defaults)."""
        from ..topology.graph import InterferenceMatrix

        if base is None:
            base = (self.graph.interference if self.graph is not None
                    else InterferenceMatrix())
        if not self.interference_scale:
            return base
        return base.with_pair_scales(dict(self.interference_scale))

    # ------------------------------------------------------------------ #
    # calibrated views                                                   #
    # ------------------------------------------------------------------ #
    def calibrated_graph(self):
        """Corrected copy of the topology graph (None without one).

        Fitted per-link corrections apply first; each link owned by a
        probed tier additionally carries that tier's online EWMA scale
        (the link is the tier's path bottleneck after the fit, so the
        scale must land there to move the effective minimum), and the
        global ``"*"`` scale applies to every link."""
        if self.graph is None:
            return None
        overrides = {}
        g_scale = self._clamp(self.online_scale.get("*", 1.0))
        for key, link in self.graph.links.items():
            corr = self.link_corr.get(key)
            scale = (corr.bw_scale if corr else 1.0) * g_scale
            owner = self._link_owner.get(key)
            if owner is not None:
                scale *= self._clamp(self.online_scale.get(owner, 1.0))
            lat_add = corr.latency_add_ns if corr else 0.0
            if scale == 1.0 and lat_add == 0.0:
                continue
            overrides[key] = (
                max(link.latency_ns + lat_add, 0.0),
                max(link.bw_GBps * scale, 1e-9))
        g = self.graph.rebuilt(overrides)
        if self.interference_scale:
            g.interference = self.calibrated_interference()
        return g

    def _corrected_descriptor(self, name: str,
                              tier: MemoryTier) -> MemoryTier:
        corr = self.tier_corr.get(name)
        scale = self._clamp(corr.bw_scale) if corr else 1.0
        scale *= self._online(name)
        lat_add = corr.latency_add_ns if corr else 0.0
        if scale == 1.0 and lat_add == 0.0:
            return tier
        return dataclasses.replace(
            tier,
            unloaded_latency_ns=max(
                tier.unloaded_latency_ns + lat_add, 1.0),
            peak_bw_GBps=tier.peak_bw_GBps * scale,
            stream_bw_GBps=tier.stream_bw_GBps * scale)

    def calibrated_view(self, tiers: Optional[Mapping[str, MemoryTier]]
                        = None, topology=None
                        ) -> Tuple[Dict[str, MemoryTier], object]:
        """(corrected device-local descriptors, corrected graph) — the
        drop-in replacement for a consumer's ``(tiers, topology)`` pair
        so path-aware pricing (per-link serialization, contention) runs
        on measured numbers.  ``topology`` is the consumer's own graph,
        returned unchanged when the calibrator has none."""
        base = dict(tiers) if tiers is not None else self.base_tiers
        corrected = {n: self._corrected_descriptor(n, t)
                     for n, t in base.items()}
        g = self.calibrated_graph()
        return corrected, (g if g is not None else topology)

    def calibrated_tiers(self, tiers: Optional[Mapping[str, MemoryTier]]
                         = None, origin: Optional[str] = None
                         ) -> Dict[str, MemoryTier]:
        """Effective tier descriptors on measured numbers: probe-fitted
        link/tier corrections and online EWMA scales folded through the
        corrected graph as seen from ``origin``."""
        corrected, g = self.calibrated_view(tiers)
        if g is None:
            return corrected
        return g.effective_tiers(corrected, origin or self.origin)

    # ------------------------------------------------------------------ #
    # export                                                             #
    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "calibration.fitted": 1.0 if self.fitted else 0.0,
            "calibration.probes": float(self.probes_fit),
            "calibration.observations": float(self.observations),
        }
        for key, corr in sorted(self.link_corr.items()):
            tag = f"{key[0]}-{key[1]}"
            out[f"calibration.link.{tag}.bw_scale"] = corr.bw_scale
            out[f"calibration.link.{tag}.latency_add_ns"] = \
                corr.latency_add_ns
        for name, corr in sorted(self.tier_corr.items()):
            out[f"calibration.tier.{name}.bw_scale"] = corr.bw_scale
            out[f"calibration.tier.{name}.latency_add_ns"] = \
                corr.latency_add_ns
        for key, s in sorted(self.online_scale.items(),
                             key=lambda kv: str(kv[0])):
            out[f"calibration.online.{key}.bw_scale"] = s
        for (kind, vc, ac), s in sorted(self.interference_scale.items()):
            out[f"calibration.interference.{kind}.{vc}-{ac}.scale"] = s
        return out

    def publish(self, registry) -> None:
        if registry is not None:
            registry.set_gauges(self.summary())
