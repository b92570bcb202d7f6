"""Memory-tier descriptors and performance models.

PyTorch-port copy of ``repro.core.tiers`` (framework-free): the paper's
measured characteristics of LDRAM / RDRAM / CXL (three vendors, Table I +
Figs. 2-4).  The TPU tier set of the reference is left out: the port
takes its device tiers from measurements on its own card.

Two analytic models are provided, both directly mirroring the paper's
methodology:

* ``bandwidth(streams)`` — a saturating concurrency curve reproducing Fig. 3
  ("CXL saturates at ~4-8 threads, DRAM at 20-28").  On TPU the concurrency
  axis is outstanding DMA streams rather than CPU threads (DESIGN.md §2).

* ``loaded_latency(offered_bw)`` — latency as a function of offered load
  reproducing Fig. 4 (latency skyrockets near peak bandwidth because of
  queueing in the memory controller / CXL controller).  We use an
  M/M/1-shaped queueing term which matches the paper's curves well.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

GiB = 1024**3
GB = 1e9


@dataclasses.dataclass(frozen=True)
class MemoryTier:
    """A memory tier with the measured parameters the planner needs.

    Attributes mirror the paper's characterization axes:
      unloaded_latency_ns : pointer-chase latency at zero load (Fig. 2).
      peak_bw_GBps        : peak sequential bandwidth (Fig. 3 plateau).
      stream_bw_GBps      : bandwidth contributed by one access stream
                            ("thread" in the paper, DMA stream on TPU).
      saturation_streams  : streams at which bandwidth saturates (Fig. 3 knee).
      capacity_GiB        : capacity used by placement planners.
      hop_latency_ns      : extra latency if reached through another hop
                            (e.g. CXL attached to the *other* socket, or a
                            peer host on TPU).
    """

    name: str
    unloaded_latency_ns: float
    peak_bw_GBps: float
    stream_bw_GBps: float
    capacity_GiB: float
    hop_latency_ns: float = 0.0
    kind: str = "dram"  # dram | cxl | hbm | host | ici | nvme

    @property
    def saturation_streams(self) -> float:
        return self.peak_bw_GBps / self.stream_bw_GBps

    # ------------------------------------------------------------------ #
    # Fig. 3: bandwidth vs. concurrency (saturating curve)                #
    # ------------------------------------------------------------------ #
    def bandwidth(self, streams: float) -> float:
        """Aggregate bandwidth (GB/s) achieved with `streams` access streams.

        Smooth saturating model:  bw = peak * (1 - exp(-s / knee)).
        Calibrated so that the knee sits at the paper's measured saturation
        point; for CXL that is ~4 streams (Sec. I: "saturation occurring when
        the number of threads reaches just four").
        """
        if streams <= 0:
            return 0.0
        knee = max(self.saturation_streams / 2.0, 1e-6)
        return self.peak_bw_GBps * (1.0 - math.exp(-streams / knee))

    # ------------------------------------------------------------------ #
    # Fig. 4: loaded latency (queueing)                                   #
    # ------------------------------------------------------------------ #
    def loaded_latency(self, offered_bw_GBps: float) -> float:
        """Latency (ns) under an offered load (M/M/1-shaped queueing blowup).

        latency = base / (1 - rho)  capped at 20x base, with rho the
        utilization.  Reproduces the paper's observation that LDRAM/RDRAM
        near peak load reach CXL-like latency (543/600 ns vs CXL 400-550 ns).
        """
        base = self.unloaded_latency_ns + self.hop_latency_ns
        rho = min(max(offered_bw_GBps, 0.0) / self.peak_bw_GBps, 0.999)
        lat = base / (1.0 - rho)
        return min(lat, 20.0 * base)

    def access_time_s(self, nbytes: int, streams: float = 8.0,
                      random: bool = False) -> float:
        """Time to touch `nbytes` from this tier with given concurrency.

        Streaming access pays the bandwidth term; random access pays a
        latency-per-cacheline term amortized over `streams` parallel misses
        (MLC-style), which is how the paper distinguishes bandwidth-hungry
        from latency-sensitive objects.
        """
        if nbytes <= 0:
            return 0.0
        bw = self.bandwidth(streams) * GB
        stream_t = nbytes / bw
        if not random:
            return stream_t
        line = 64.0
        lat = (self.unloaded_latency_ns + self.hop_latency_ns) * 1e-9
        rand_t = (nbytes / line) * lat / max(streams, 1.0)
        return max(stream_t, rand_t)


# ---------------------------------------------------------------------- #
# Paper-measured tiers (Table I, Figs. 2-4).                              #
# Latencies: Fig. 2 sequential-access values; CXL deltas +153 ns (sys A)  #
# and +211 ns (sys B) over LDRAM.  Bandwidths: Table I / Fig. 3.          #
# ---------------------------------------------------------------------- #
def paper_system(name: str) -> Dict[str, MemoryTier]:
    """Tier sets for the paper's systems A, B, C."""
    if name == "A":  # 2x AMD EPYC 9354, CXL-A single ch DDR5-4800
        ldram = MemoryTier("LDRAM", 118, 460.8, 22.0, 768, kind="dram")
        rdram = MemoryTier("RDRAM", 205, 460.8, 22.0, 768, hop_latency_ns=0,
                           kind="dram")
        cxl = MemoryTier("CXL", 271, 38.4, 9.0, 128, kind="cxl")
    elif name == "B":  # 2x SPR 8470, CXL-B DDR5-8000
        ldram = MemoryTier("LDRAM", 112, 307.2, 11.0, 1024, kind="dram")
        rdram = MemoryTier("RDRAM", 190, 307.2, 11.0, 1024, kind="dram")
        cxl = MemoryTier("CXL", 323, 64.0, 10.5, 64, kind="cxl")
    elif name == "C":  # 2x Xeon Gold 6438V+, CXL-C dual ch DDR5-6200
        ldram = MemoryTier("LDRAM", 114, 307.2, 11.0, 512, kind="dram")
        rdram = MemoryTier("RDRAM", 195, 307.2, 11.0, 512, kind="dram")
        cxl = MemoryTier("CXL", 290, 96.8, 13.0, 128, kind="cxl")
    else:
        raise ValueError(f"unknown paper system {name!r}")
    nvme = MemoryTier("NVMe", 80_000, 7.0, 3.5, 128, kind="nvme")
    return {"LDRAM": ldram, "RDRAM": rdram, "CXL": cxl, "NVMe": nvme}


# ---------------------------------------------------------------------- #
# Sec. III bandwidth-packing: assign streams across tiers to maximize     #
# aggregate bandwidth ("6/23/23 threads to CXL/LDRAM/RDRAM -> 420 GB/s"). #
# ---------------------------------------------------------------------- #
def _delivered_bandwidth(tiers: Mapping[str, MemoryTier],
                         alloc: Mapping[str, int],
                         tier_links: Mapping[str, Sequence],
                         passes: int = 4) -> Dict[str, float]:
    """Per-tier bandwidth actually delivered to the compute origin.

    Each tier produces its concurrency-curve bandwidth, then every
    interconnect link on its path caps the *sum* of the flows crossing
    it: when tiers share a bottleneck hop (two DIMM sets behind one UPI
    link, CXL + DRAM behind one socket), their flows fair-share the
    link (proportional scale-down, iterated to a fixed point).
    """
    flow = {k: tiers[k].bandwidth(alloc[k]) for k in tiers}
    links = {}
    for k, ls in tier_links.items():
        for link in ls:
            links.setdefault(link.key, (link, []))[1].append(k)
    for _ in range(passes):
        changed = False
        for link, crossing in links.values():
            load = sum(flow[k] for k in crossing)
            if load > link.bw_GBps * (1 + 1e-9):
                s = link.bw_GBps / load
                for k in crossing:
                    flow[k] *= s
                changed = True
        if not changed:
            break
    return flow


def assign_streams(tiers: Mapping[str, MemoryTier], total_streams: int,
                   topology=None, origin: Optional[str] = None
                   ) -> Tuple[Dict[str, int], float]:
    """Greedy water-filling of access streams over tiers.

    Iteratively grants the next stream to the tier with the largest
    marginal bandwidth gain.  Returns ({tier: streams}, aggregate_GBps).
    Reproduces the paper's Sec. III thread-assignment observation.

    With a ``topology`` (repro.topology.TopologyGraph), the marginal
    gain is measured on the bandwidth *delivered through the path from
    the compute origin*: tiers whose paths share a bottleneck link
    fair-share it, so adding streams to a second tier behind an already
    saturated hop gains nothing and the water-filling routes those
    streams to tiers with independent paths instead (closing the
    ROADMAP stream-assignment item).
    """
    if topology is None:
        alloc = {k: 0 for k in tiers}
        for _ in range(total_streams):
            best_k, best_gain = None, 0.0
            for k, t in tiers.items():
                gain = t.bandwidth(alloc[k] + 1) - t.bandwidth(alloc[k])
                if gain > best_gain:
                    best_k, best_gain = k, gain
            if best_k is None:  # everything saturated
                break
            alloc[best_k] += 1
        agg = sum(tiers[k].bandwidth(n) for k, n in alloc.items())
        return alloc, agg

    eff = topology.effective_tiers(tiers, origin)
    tier_links = {k: topology.tier_links(k, origin) for k in tiers}
    alloc = {k: 0 for k in tiers}
    agg = 0.0
    for _ in range(total_streams):
        best_k, best_agg = None, agg
        for k in tiers:
            trial = dict(alloc)
            trial[k] += 1
            cand = sum(_delivered_bandwidth(eff, trial,
                                            tier_links).values())
            if cand > best_agg + 1e-9:
                best_k, best_agg = k, cand
        if best_k is None:      # every path saturated: no stream helps
            break
        alloc[best_k] += 1
        agg = best_agg
    return alloc, agg


def interleave_bandwidth(tiers: Mapping[str, MemoryTier],
                         weights: Optional[Mapping[str, float]] = None,
                         streams: float = 16.0) -> float:
    """Effective bandwidth of round-robin interleaving across `tiers`.

    With uniform page interleave, each tier serves a `weight` fraction of the
    traffic; the slowest tier *relative to its share* gates throughput
    (harmonic composition) — this is why the paper finds uniform interleave
    can *undermine* performance (Sec. V takeaway): a 38 GB/s CXL card serving
    1/3 of the traffic caps the aggregate at ~3x38 = 115 GB/s even next to a
    460 GB/s LDRAM.
    """
    names = list(tiers)
    if weights is None:
        weights = {k: 1.0 / len(names) for k in names}
    per_tier_streams = {k: streams * weights[k] for k in names}
    # aggregate limited by the tier that finishes its share last
    t_norm = max(
        weights[k] / max(tiers[k].bandwidth(per_tier_streams[k]), 1e-9)
        for k in names if weights[k] > 0
    )
    return 1.0 / t_norm
