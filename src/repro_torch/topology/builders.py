"""PyTorch-port copy of ``repro.topology.builders``: the paper's
testbeds, and one H100 with its host in place of the reference's TPU
pod.

Each builder returns a ``Testbed``: a graph plus *device-local* tier
descriptors.  Local-normalization matters: the paper's Fig. 2 numbers
(RDRAM 205 ns, CXL 271 ns on system A) are *as seen from socket 0* —
the DIMMs themselves are no slower than local ones, the interconnect
carries the difference.  So the builders put the local latency on the
tier and the measured delta on the link, and
``TopologyGraph.effective_tiers`` reproduces the paper's numbers from
the default origin:

    system A from socket0:  LDRAM 118+0,  RDRAM 118+87 = 205,
                            CXL 118+153 = 271        (Fig. 2)
    far-socket variant:     CXL 118+87+153 = 358     (extra UPI hop)

Cross-socket bandwidths (xGMI/UPI) are not in the paper's tables; the
values here are the vendor-typical aggregates and only matter
relationally (cross-socket < local, CXL card < everything).

``h100_node`` takes its rates from transfer probes of the card's
memory kinds (``obs.measure_transfer_probes``); the multi-host pod of
the reference (``ClusterTestbed``, ``multi_host_pod``) comes with the
cluster plane.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from ..core.tiers import MemoryTier, paper_system
from .graph import TopologyGraph

TOPOLOGY_CHOICES = ("vendor-a", "vendor-b", "vendor-c", "far-socket",
                    "h100-node")

# the memory kinds an h100-node testbed is built from, fastest first
H100_KINDS = ("device", "pinned_host", "unpinned_host")

# cross-socket interconnect bandwidth per system (GB/s): A is EPYC xGMI,
# B/C are SPR/EMR UPI 2.0 at 3-4 links
_XSOCKET_BW = {"A": 230.0, "B": 125.0, "C": 160.0}


@dataclasses.dataclass(frozen=True)
class Testbed:
    """A built topology plus its device-local tier inventory."""

    name: str
    graph: TopologyGraph
    tiers: Dict[str, MemoryTier]
    fast: str                 # the planner's fast tier
    capacity_tier: str        # the CXL-class capacity expander
    description: str = ""

    def effective_tiers(self, origin: str = None) -> Dict[str, MemoryTier]:
        return self.graph.effective_tiers(self.tiers, origin)

    def describe(self) -> List[str]:
        head = [f"testbed {self.name}: {self.description}"] \
            if self.description else []
        return head + self.graph.describe(self.tiers)


def two_socket_system(system: str = "A",
                      cxl_socket: int = 0) -> Testbed:
    """The paper's dual-socket testbeds (Table I), CXL behind either
    socket.  ``cxl_socket=1`` with compute on socket 0 is the Fig. 2
    far-socket configuration: the card pays the UPI hop on every
    access."""
    base = paper_system(system)
    ldram, rdram, cxl, nvme = (base["LDRAM"], base["RDRAM"], base["CXL"],
                               base["NVMe"])
    upi_lat = rdram.unloaded_latency_ns - ldram.unloaded_latency_ns
    cxl_link_lat = cxl.unloaded_latency_ns - ldram.unloaded_latency_ns
    # local-normalize: remote DRAM and the CXL card's DRAM side are
    # local-speed; the links above carry the measured deltas
    tiers = {
        "LDRAM": ldram,
        "RDRAM": dataclasses.replace(
            rdram, unloaded_latency_ns=ldram.unloaded_latency_ns),
        "CXL": dataclasses.replace(
            cxl, unloaded_latency_ns=ldram.unloaded_latency_ns),
        "NVMe": nvme,
    }
    name = (f"vendor-{system.lower()}" if cxl_socket == 0
            else f"vendor-{system.lower()}-far")
    g = TopologyGraph(name, origin="socket0")
    g.add_node("socket0", kind="socket")
    g.add_node("socket1", kind="socket")
    g.add_node("numa0", kind="numa", tier="LDRAM")
    g.add_node("numa1", kind="numa", tier="RDRAM")
    g.add_node("cxl0", kind="cxl", tier="CXL")
    g.add_node("nvme0", kind="nvme", tier="NVMe")
    g.add_link("socket0", "numa0", 0.0, ldram.peak_bw_GBps, kind="local")
    g.add_link("socket1", "numa1", 0.0, rdram.peak_bw_GBps, kind="local")
    g.add_link("socket0", "socket1", upi_lat, _XSOCKET_BW[system],
               kind="upi")
    # the card's measured peak already includes its PCIe/CXL link, so
    # the link is sized to the card: it adds latency and a contention
    # point, not an extra near-socket throttle
    g.add_link(f"socket{cxl_socket}", "cxl0", cxl_link_lat,
               cxl.peak_bw_GBps, kind="cxl")
    g.add_link("socket0", "nvme0", 0.0, nvme.peak_bw_GBps, kind="pcie")
    where = "far socket" if cxl_socket else "near socket"
    return Testbed(name, g, tiers, fast="LDRAM", capacity_tier="CXL",
                   description=f"paper system {system}, CXL on the "
                               f"{where}")


def h100_node(probes: Sequence) -> Testbed:
    """One H100 and its host: HBM local (tier ``device`` on node
    ``chip0``), page-locked host memory over PCIe (tier
    ``pinned_host`` on ``host0``, the CXL expander analogue) and
    pageable host memory (``unpinned_host``, aliased onto ``host0``:
    the same DIMMs behind the same PCIe link, as ``HOST_UNPINNED`` is
    in the reference's ``tpu_pod``).  One card has no peer chip over
    an interconnect, so there is no counterpart of the TPU pod's ICI
    peer.

    ``probes`` are ``TierProbe``s of the three kinds (``H100_KINDS``,
    e.g. ``obs.measure_transfer_probes(kinds=H100_KINDS)``), copy
    rates from the card.  A bulk copy observes bandwidth only, so the
    fields follow ``serving.engine.kind_bases``: each kind's rate is
    its peak and its one-stream bandwidth, and its latency as seen
    from the chip is the time of one 64-byte line at that rate.  The
    PCIe link carries the pinned rate and the latency the pinned kind
    adds over the device's; the host tiers keep the rest, so where the
    probes order the kinds as listed, ``effective_tiers`` from
    ``chip0`` gives back 64 / rate for every kind.  Capacities are 0: the serving engine sets them from its
    pool's block budgets (``kind_tiers``)."""
    bw = {p.tier: p.bw_GBps for p in probes}
    missing = [k for k in H100_KINDS if k not in bw]
    if missing:
        raise ValueError(f"h100-node needs probes of {', '.join(missing)}")
    lat = {k: 64.0 / bw[k] for k in H100_KINDS}
    pcie_lat = max(lat["pinned_host"] - lat["device"], 0.0)
    tiers = {k: MemoryTier(
        k, lat[k] if k == "device" else max(lat[k] - pcie_lat, 0.0),
        bw[k], bw[k], 0.0, kind="hbm" if k == "device" else "host")
        for k in H100_KINDS}
    g = TopologyGraph("h100-node", origin="chip0")
    g.add_node("chip0", kind="chip", tier="device")
    g.add_node("host0", kind="host", tier="pinned_host")
    g.alias_tier("pinned_host", "unpinned_host")
    g.add_link("chip0", "host0", pcie_lat, bw["pinned_host"], kind="pcie")
    return Testbed("h100-node", g, tiers, fast="device",
                   capacity_tier="pinned_host",
                   description="one H100: HBM + host memory over PCIe "
                               "(rates probed)")


def build_topology(name: str, device=None) -> Testbed:
    """Factory behind the ``--topology`` CLI flags.  ``h100-node``
    probes the memory kinds from ``device`` (CUDA unless ``"cpu"`` is
    asked for; on the CPU the kinds are logical CPU memory)."""
    key = name.strip().lower().replace("_", "-")
    if key in ("vendor-a", "vendor-b", "vendor-c"):
        return two_socket_system(key[-1].upper(), cxl_socket=0)
    if key == "far-socket":
        return two_socket_system("A", cxl_socket=1)
    if key == "h100-node":
        from ..obs.calibrate import measure_transfer_probes
        return h100_node(measure_transfer_probes(kinds=H100_KINDS,
                                                 device=device))
    if key == "tpu-pod":
        raise ValueError("topology 'tpu-pod' describes a TPU host; the "
                         "port's single-card testbed is 'h100-node'")
    raise ValueError(f"unknown topology {name!r} "
                     f"(choices: {', '.join(TOPOLOGY_CHOICES)})")
