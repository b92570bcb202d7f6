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
memory kinds (``obs.measure_transfer_probes``), and so do the hosts of
``multi_host_pod``, the cluster plane's fleet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

from ..core.tiers import MemoryTier, paper_system
from .graph import TopologyGraph

TOPOLOGY_CHOICES = ("vendor-a", "vendor-b", "vendor-c", "far-socket",
                    "h100-node")

# the memory kinds an h100-node testbed is built from, fastest first
H100_KINDS = ("device", "pinned_host", "unpinned_host")

# the multi-host pod's front-end node: sessions enter here, so a
# replica's routing distance is the path from this node to its host
ROUTER_NODE = "router"

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


@dataclasses.dataclass(frozen=True)
class ClusterTestbed:
    """A fleet of hosts: one global inter-host graph for routing and
    budget arbitration, plus a *local* per-replica ``Testbed`` each
    serving engine plans against.

    The split mirrors the multi-host plane's ownership rule: a replica
    prices its own promotions over its local graph; the router and the
    cluster arbiter price placement over the global one (distance from
    the front-end, per-host fast capacity).
    """

    name: str
    graph: TopologyGraph            # hosts + per-host tiers + links
    hosts: List[str]                # replica host nodes, host0..hostN-1
    replicas: Dict[str, Testbed]    # replica name -> local testbed
    tiers: Dict[str, MemoryTier]    # global-graph tier inventory
    fast_tier: Dict[str, str]       # host -> its fast tier name
    capacity_tier: Dict[str, str]   # host -> its CXL-class tier name
    description: str = ""

    def distance_ns(self, src: str, dst: str) -> float:
        """Unloaded path latency between two nodes of the global graph."""
        if src == dst:
            return 0.0
        return sum(l.latency_ns for l in self.graph.path(src, dst))

    def describe(self) -> List[str]:
        head = [f"cluster {self.name}: {self.description}"] \
            if self.description else []
        return head + self.graph.describe(self.tiers)


def _local_testbed(tiers: Mapping) -> Testbed:
    """One host of ``multi_host_pod(tiers=...)``: its fast tier on
    ``chip0`` and its capacity tier on ``host0`` behind the capacity
    link."""
    fast, cap = tiers["fast"], tiers["capacity"]
    lat, bw = tiers["capacity_link"]
    g = TopologyGraph("host-node", origin="chip0")
    g.add_node("chip0", kind="chip", tier=fast.name)
    g.add_node("host0", kind="host", tier=cap.name)
    g.add_link("chip0", "host0", lat, bw, kind="pcie")
    return Testbed("host-node", g, {fast.name: fast, cap.name: cap},
                   fast=fast.name, capacity_tier=cap.name,
                   description="one host: fast tier + capacity tier")


def multi_host_pod(n_hosts: int = 2, probes: Optional[Sequence] = None,
                   tiers: Optional[Mapping] = None) -> ClusterTestbed:
    """A pod of ``n_hosts`` hosts on a ring, the front-end
    :data:`ROUTER_NODE` attached at host0, so routing distance grows
    with ring hops: the asymmetry the session router prices against
    headroom.  Each host carries its own fast tier (``FAST<i>``) and
    CXL-class expander (``CXL<i>``) behind a per-host link: the
    capacities the cluster arbiter splits per replica.

    By default every host is one H100 node, ``h100_node(probes)``
    (``probes``: ``TierProbe``s of ``H100_KINDS``, measured on the
    current CUDA device when None): ``FAST<i>`` is its ``device`` tier,
    ``CXL<i>`` its ``pinned_host`` tier behind the PCIe link, and each
    replica's local testbed is its own ``h100_node``.  The cluster
    plane runs its replicas as logical replicas on one card, which have
    no interconnect between them: the inter-host and router links are
    priced as a hop over the card's PCIe link (one 64-byte line at its
    probed pinned rate).  That is a model, not a measurement.  Routing
    reads only each replica's distance over the largest, and every link
    on the router's paths has the same positive latency, so the price
    cannot change a routing decision: distance counts ring hops.

    ``tiers`` gives the per-host parts instead: ``{"fast": MemoryTier,
    "capacity": MemoryTier`` (local-normalized), ``"capacity_link":
    (latency_ns, GB/s), "host_link": (latency_ns, GB/s)}``; each
    replica's local testbed is then its fast tier and its capacity tier
    over the capacity link.  With the reference's TPU parts (the parity
    tests) the graph and its distances are the reference's.
    """
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    if tiers is None:
        if probes is None:
            from ..obs.calibrate import measure_transfer_probes
            probes = measure_transfer_probes(kinds=H100_KINDS)
        node = h100_node(probes)
        pcie = node.graph.links[("chip0", "host0")]
        parts = {"fast": node.tiers[node.fast],
                 "capacity": node.tiers[node.capacity_tier],
                 "capacity_link": (pcie.latency_ns, pcie.bw_GBps),
                 # one 64-byte line at the PCIe link's rate: never 0
                 "host_link": (64.0 / pcie.bw_GBps, pcie.bw_GBps)}

        def local() -> Testbed:
            return h100_node(probes)
        what = "H100 hosts, links priced as the card's PCIe hop"
    else:
        parts = tiers

        def local() -> Testbed:
            return _local_testbed(tiers)
        what = "hosts of the given tiers"
    fast_base, cap_base = parts["fast"], parts["capacity"]
    cap_lat, cap_bw = parts["capacity_link"]
    host_lat, host_bw = parts["host_link"]
    g = TopologyGraph(f"multi-host-{n_hosts}", origin=ROUTER_NODE)
    g.add_node(ROUTER_NODE, kind="host")
    pod_tiers: Dict[str, MemoryTier] = {}
    fast_tier: Dict[str, str] = {}
    capacity_tier: Dict[str, str] = {}
    hosts: List[str] = []
    replicas: Dict[str, Testbed] = {}
    for i in range(n_hosts):
        h, fast, cap = f"host{i}", f"FAST{i}", f"CXL{i}"
        hosts.append(h)
        pod_tiers[fast] = dataclasses.replace(fast_base, name=fast)
        pod_tiers[cap] = dataclasses.replace(cap_base, name=cap)
        fast_tier[h], capacity_tier[h] = fast, cap
        g.add_node(h, kind="host")
        g.add_node(f"fast{i}", kind="chip", tier=fast)
        g.add_node(f"cxl{i}", kind="cxl", tier=cap)
        g.add_link(h, f"fast{i}", 0.0, fast_base.peak_bw_GBps,
                   kind="local")
        g.add_link(h, f"cxl{i}", cap_lat, cap_bw, kind="cxl")
        # each replica plans its local promotions over its own graph
        # (a graph of its own: the replica aliases its tiers onto it)
        tb = local()
        replicas[h] = dataclasses.replace(
            tb, name=f"{tb.name}/{h}",
            description=f"{tb.description} (replica {h})")
    for i in range(n_hosts):
        j = (i + 1) % n_hosts
        if j != i and (n_hosts > 2 or i < j):
            g.add_link(f"host{i}", f"host{j}", host_lat, host_bw,
                       kind="ici")
    g.add_link(ROUTER_NODE, "host0", host_lat, host_bw, kind="ici")
    return ClusterTestbed(
        f"multi-host-{n_hosts}", g, hosts, replicas, pod_tiers,
        fast_tier, capacity_tier,
        description=f"{n_hosts}-host ring ({what}), per-host fast tier "
                    f"+ CXL-class expander, front-end at host0")


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
