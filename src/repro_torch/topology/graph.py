"""PyTorch-port copy of ``repro.topology.graph`` (framework-free).

Hardware topology graph: where memory actually sits in the machine.

The paper's characterization hinges on *position*, not just device
class: a CXL card behind the far socket pays an extra UPI hop (Fig. 2),
interleaving spreads traffic across NUMA nodes with unequal bandwidth,
and "Dissecting CXL Memory Performance at Scale" / CXL-Interference
show that shared-link contention dominates realized performance.  The
seed collapsed all of that into a scalar ``hop_latency_ns`` per tier;
this module makes the topology first-class:

  * ``TopologyGraph`` — nodes (sockets, NUMA/SNC nodes, CXL devices,
    TPU chips/hosts) and undirected links (UPI/xGMI, PCIe, CXL, ICI),
    each link carrying the *additional* latency of traversing it and
    its bandwidth;
  * shortest-path queries: ``hop_latency_ns`` (sum of link latencies),
    ``path_bw_GBps`` (bottleneck link bandwidth);
  * ``effective_tiers`` — distance-adjusted ``MemoryTier`` copies as
    seen from a compute origin: path latency folded into
    ``hop_latency_ns``, peak bandwidth capped by the path bottleneck
    (the knee of the Fig. 3 curve is preserved by scaling the per-
    stream bandwidth with the peak);
  * a shared-link contention model (``contended_flows``): concurrent
    flows fair-share each link's bandwidth and see M/M/1-style loaded
    latency on it, so two tiers reached through one UPI hop interfere
    even though their controllers are independent.

Tier descriptors handed to this graph must be *device-local*: a remote
DRAM node has the same DIMM latency as a local one — the interconnect
carries the difference.  ``builders`` constructs such normalized tier
sets for the paper's testbeds.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..core.tiers import MemoryTier

LinkKey = Tuple[str, str]


def _key(a: str, b: str) -> LinkKey:
    return (a, b) if a <= b else (b, a)


@dataclasses.dataclass(frozen=True)
class TopoNode:
    """One location in the machine (socket, NUMA node, device, chip)."""

    name: str
    kind: str = "socket"     # socket | numa | cxl | nvme | chip | host
    tier: Optional[str] = None    # memory tier resident at this node


@dataclasses.dataclass(frozen=True)
class TopoLink:
    """Undirected interconnect edge.

    ``latency_ns`` is the *extra* latency of crossing this link (the
    device-local latency lives in the MemoryTier), ``bw_GBps`` its
    usable bandwidth.
    """

    a: str
    b: str
    latency_ns: float
    bw_GBps: float
    kind: str = "link"       # upi | pcie | cxl | ici | local

    @property
    def key(self) -> LinkKey:
        return _key(self.a, self.b)

    def other(self, node: str) -> str:
        return self.b if node == self.a else self.a


# interference classes per CXL-Interference (arxiv 2411.18308): the
# slowdown co-located traffic inflicts depends on *what kind* of
# traffic it is, not just how much — writers hurt readers far more
# than readers hurt writers, and prefetch streams are the worst
# antagonists of all
INTERFERENCE_CLASSES = ("read", "write", "prefetch")

# (victim class, aggressor class) -> relative pressure one offered
# byte of the aggressor puts on the victim's queue, versus a byte of
# the victim's own class (diagonal == 1).  Values follow the ordering
# 2411.18308 measures on CXL/UPI hops: writer-on-reader ~1.6x,
# prefetcher-on-writer worst, reader-on-writer mildest.
DEFAULT_CLASS_WEIGHTS = {
    ("read", "write"): 1.6,
    ("read", "prefetch"): 1.25,
    ("write", "read"): 0.85,
    ("write", "prefetch"): 1.9,
    ("prefetch", "read"): 1.2,
    ("prefetch", "write"): 1.45,
}

# how strongly a link kind expresses the class asymmetry: CXL
# controllers amplify it (single shared buffer), socket interconnects
# show it as measured, on-package local links barely notice
DEFAULT_KIND_SCALE = {
    "cxl": 1.25, "upi": 1.0, "pcie": 0.9, "ici": 0.5,
    "local": 0.25, "link": 1.0,
}


@dataclasses.dataclass(frozen=True)
class InterferenceMatrix:
    """Per-link-kind asymmetric class-interference weights.

    ``weight(kind, victim, aggressor)`` is the pressure multiplier an
    aggressor-class byte applies to a victim-class flow's utilization
    on a link of ``kind``.  Same-class pairs are always 1.0, so a flow
    set of one class reproduces the symmetric fair-share model
    exactly.  ``pair_scale`` carries calibration: per
    ``(kind, victim, aggressor)`` multiplicative corrections fitted by
    the ``CostModelCalibrator`` from measured slowdown ratios.
    ``link_scale`` refines that to one *physical* link: keyed by
    ``(LinkKey, victim, aggressor)``, it takes precedence over the
    kind-level ``pair_scale`` when pricing that exact link — two CXL
    hops of the same kind can now carry different measured interference
    (the PR 8 follow-on).  Both survive ``TopologyGraph.rebuilt()``
    because the whole matrix is carried over.
    """

    class_weights: Mapping[Tuple[str, str], float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_CLASS_WEIGHTS))
    kind_scale: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_KIND_SCALE))
    pair_scale: Mapping[Tuple[str, str, str], float] = dataclasses.field(
        default_factory=dict)
    # (LinkKey, victim, aggressor) -> scale; overrides pair_scale on
    # that physical link
    link_scale: Mapping[Tuple[LinkKey, str, str], float] = \
        dataclasses.field(default_factory=dict)

    def weight(self, link_kind: str, victim: str, aggressor: str,
               link: Optional[LinkKey] = None) -> float:
        if victim == aggressor:
            w = 1.0
        else:
            base = self.class_weights.get((victim, aggressor), 1.0)
            scale = self.kind_scale.get(link_kind, 1.0)
            w = 1.0 + (base - 1.0) * scale
        s = None
        if link is not None:
            s = self.link_scale.get((_key(*link), victim, aggressor))
        if s is None:
            s = self.pair_scale.get((link_kind, victim, aggressor), 1.0)
        w *= s
        return max(w, 0.05)

    def with_pair_scales(self, scales: Mapping[Tuple[str, str, str], float]
                         ) -> "InterferenceMatrix":
        merged = dict(self.pair_scale)
        merged.update(scales)
        return dataclasses.replace(self, pair_scale=merged)

    def with_link_scales(self, link: Union[LinkKey, str],
                         scales: Mapping[Tuple[str, str], float]
                         ) -> "InterferenceMatrix":
        """Override interference scales on one physical link.

        ``link`` is a LinkKey tuple or an ``"a-b"`` string; ``scales``
        maps ``(victim, aggressor)`` class pairs to multipliers that
        replace the kind-level ``pair_scale`` on that link only.
        """
        if isinstance(link, str):
            a, _, b = link.partition("-")
            if not b:
                raise ValueError(f"link id {link!r} is not 'a-b' or a "
                                 f"(a, b) tuple")
            link = (a, b)
        lk = _key(*link)
        merged = dict(self.link_scale)
        for (victim, aggressor), s in scales.items():
            merged[(lk, victim, aggressor)] = float(s)
        return dataclasses.replace(self, link_scale=merged)


@dataclasses.dataclass(frozen=True)
class Flow:
    """One offered traffic stream between two nodes (for contention).

    ``cls`` is the interference class (read | write | prefetch) and
    ``tenant`` the namespace that owns the traffic — both default so
    legacy call sites price as symmetric anonymous readers."""

    src: str
    dst: str
    offered_GBps: float
    cls: str = "read"
    tenant: str = ""


@dataclasses.dataclass(frozen=True)
class FlowResult:
    """Realized performance of one flow under shared-link contention.

    ``raw_rho`` is the flow's worst *pre-clamp* class-weighted
    utilization along its path — values above ``max_rho`` mean the
    loaded-latency clamp engaged and the link is saturated."""

    achieved_GBps: float
    latency_ns: float
    bottleneck: Optional[LinkKey]
    raw_rho: float = 0.0
    clamped: bool = False


class TopologyGraph:
    """Nodes + links with shortest-path and contention queries."""

    def __init__(self, name: str = "topology",
                 origin: Optional[str] = None,
                 interference: Optional[InterferenceMatrix] = None):
        self.name = name
        self.nodes: Dict[str, TopoNode] = {}
        self.links: Dict[LinkKey, TopoLink] = {}
        self._adj: Dict[str, List[TopoLink]] = {}
        self.tier_nodes: Dict[str, str] = {}
        self.origin = origin          # default compute location
        # class-interference pricing for contended_flows; the default
        # matrix is identity on same-class pairs, so single-class flow
        # sets keep the symmetric fair-share behavior
        self.interference = interference or InterferenceMatrix()
        # per-link count of contended_flows calls whose loaded-latency
        # clamp engaged — overload that used to be silent
        self.link_saturations: Dict[LinkKey, int] = {}
        # memoized shortest paths — the cost model queries the same
        # (src, dst) pairs once per candidate plan (policy_search runs
        # thousands); invalidated whenever the graph grows
        self._path_cache: Dict[Tuple[str, str], List[TopoLink]] = {}

    # ------------------------------------------------------------------ #
    # construction                                                       #
    # ------------------------------------------------------------------ #
    def add_node(self, name: str, kind: str = "socket",
                 tier: Optional[str] = None) -> TopoNode:
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        node = TopoNode(name, kind, tier)
        self.nodes[name] = node
        self._adj[name] = []
        self._path_cache.clear()
        if tier is not None:
            if tier in self.tier_nodes:
                raise ValueError(f"tier {tier!r} already mapped to "
                                 f"{self.tier_nodes[tier]!r}")
            self.tier_nodes[tier] = name
        if self.origin is None:
            self.origin = name
        return node

    def add_link(self, a: str, b: str, latency_ns: float, bw_GBps: float,
                 kind: str = "link") -> TopoLink:
        for n in (a, b):
            if n not in self.nodes:
                raise ValueError(f"unknown node {n!r}")
        if bw_GBps <= 0:
            raise ValueError("link bandwidth must be positive")
        link = TopoLink(a, b, float(latency_ns), float(bw_GBps), kind)
        if link.key in self.links:
            raise ValueError(f"duplicate link {link.key}")
        self.links[link.key] = link
        self._adj[a].append(link)
        self._adj[b].append(link)
        self._path_cache.clear()
        return link

    def alias_tier(self, tier: str, alias: str) -> None:
        """Expose an existing tier's node under a second tier name.

        Lets a consumer with its own tier naming (e.g. the serving
        pool's ``device``/``pinned_host`` memory kinds) reuse a built
        topology without renaming its nodes."""
        if tier not in self.tier_nodes:
            raise KeyError(f"unknown tier {tier!r}")
        self.tier_nodes[alias] = self.tier_nodes[tier]

    def node_of(self, tier: str) -> Optional[str]:
        return self.tier_nodes.get(tier)

    def rebuilt(self, link_overrides: Optional[
            Mapping[LinkKey, Tuple[float, float]]] = None
            ) -> "TopologyGraph":
        """Copy of this graph with per-link ``(latency_ns, bw_GBps)``
        overrides applied.

        The calibration hook: ``CostModelCalibrator`` turns fitted link
        corrections into a corrected graph without mutating the one the
        rest of the control plane shares.  Tier mappings (including
        aliases) and the interference matrix carry over verbatim."""
        g = TopologyGraph(self.name, origin=self.origin,
                          interference=self.interference)
        for node in self.nodes.values():
            # tiers are copied wholesale below so aliased tier names
            # (two tiers on one node) survive the rebuild
            g.add_node(node.name, node.kind)
        for link in self.links.values():
            lat, bw = link.latency_ns, link.bw_GBps
            if link_overrides and link.key in link_overrides:
                lat, bw = link_overrides[link.key]
            g.add_link(link.a, link.b, lat, bw, link.kind)
        g.tier_nodes = dict(self.tier_nodes)
        return g

    # ------------------------------------------------------------------ #
    # shortest paths (Dijkstra on latency; hop count breaks ties)        #
    # ------------------------------------------------------------------ #
    def path(self, src: str, dst: str) -> List[TopoLink]:
        """Minimum-latency link sequence from ``src`` to ``dst``."""
        for n in (src, dst):
            if n not in self.nodes:
                raise KeyError(f"unknown node {n!r}")
        if src == dst:
            return []
        hit = self._path_cache.get((src, dst))
        if hit is not None:
            return list(hit)
        dist: Dict[str, Tuple[float, int]] = {src: (0.0, 0)}
        prev: Dict[str, TopoLink] = {}
        heap: List[Tuple[float, int, str]] = [(0.0, 0, src)]
        while heap:
            d, hops, node = heapq.heappop(heap)
            if (d, hops) > dist.get(node, (float("inf"), 0)):
                continue
            if node == dst:
                break
            for link in self._adj[node]:
                nxt = link.other(node)
                cand = (d + link.latency_ns, hops + 1)
                if cand < dist.get(nxt, (float("inf"), 1 << 30)):
                    dist[nxt] = cand
                    prev[nxt] = link
                    heapq.heappush(heap, (cand[0], cand[1], nxt))
        if dst not in prev and dst not in dist:
            raise ValueError(f"no path {src!r} -> {dst!r}")
        out: List[TopoLink] = []
        node = dst
        while node != src:
            link = prev[node]
            out.append(link)
            node = link.other(node)
        out.reverse()
        self._path_cache[(src, dst)] = out
        return list(out)

    def hop_latency_ns(self, src: str, dst: str) -> float:
        return sum(l.latency_ns for l in self.path(src, dst))

    def path_bw_GBps(self, src: str, dst: str) -> float:
        links = self.path(src, dst)
        if not links:
            return float("inf")
        return min(l.bw_GBps for l in links)

    def bottleneck(self, src: str, dst: str) -> Optional[TopoLink]:
        links = self.path(src, dst)
        if not links:
            return None
        return min(links, key=lambda l: l.bw_GBps)

    # ------------------------------------------------------------------ #
    # tier-level views                                                   #
    # ------------------------------------------------------------------ #
    def _origin(self, origin: Optional[str]) -> str:
        o = origin or self.origin
        if o is None:
            raise ValueError("no origin node set")
        return o

    def tier_links(self, tier: str, origin: Optional[str] = None
                   ) -> List[TopoLink]:
        """Links traversed reaching ``tier`` from the compute origin."""
        node = self.tier_nodes.get(tier)
        if node is None:
            return []
        return self.path(self._origin(origin), node)

    def tier_path(self, src_tier: str, dst_tier: str) -> List[TopoLink]:
        """Links a tier-to-tier copy traverses (empty if unmapped)."""
        a, b = self.tier_nodes.get(src_tier), self.tier_nodes.get(dst_tier)
        if a is None or b is None:
            return []
        return self.path(a, b)

    def tier_latency_ns(self, tier: str, origin: Optional[str] = None
                        ) -> float:
        return sum(l.latency_ns for l in self.tier_links(tier, origin))

    def tier_bw_GBps(self, tier: str, origin: Optional[str] = None
                     ) -> float:
        links = self.tier_links(tier, origin)
        if not links:
            return float("inf")
        return min(l.bw_GBps for l in links)

    def effective_tiers(self, tiers: Mapping[str, MemoryTier],
                        origin: Optional[str] = None
                        ) -> Dict[str, MemoryTier]:
        """Distance-adjusted tier descriptors as seen from ``origin``.

        Path latency replaces ``hop_latency_ns``; the path bottleneck
        caps peak bandwidth (per-stream bandwidth scales with it so the
        Fig. 3 saturation knee is preserved).  Tiers without a node in
        the graph pass through unchanged.
        """
        out: Dict[str, MemoryTier] = {}
        for name, tier in tiers.items():
            if name not in self.tier_nodes:
                out[name] = tier
                continue
            lat = self.tier_latency_ns(name, origin)
            bw = min(self.tier_bw_GBps(name, origin), tier.peak_bw_GBps)
            scale = bw / tier.peak_bw_GBps
            out[name] = dataclasses.replace(
                tier, hop_latency_ns=lat, peak_bw_GBps=bw,
                stream_bw_GBps=tier.stream_bw_GBps * scale)
        return out

    def tier_distance_order(self, tiers: Mapping[str, MemoryTier],
                            origin: Optional[str] = None) -> List[str]:
        """Tier names by effective distance (latency, then bandwidth)."""
        eff = self.effective_tiers(tiers, origin)
        return sorted(eff, key=lambda t: (
            eff[t].unloaded_latency_ns + eff[t].hop_latency_ns,
            -eff[t].peak_bw_GBps))

    def tier_weights(self, tiers: Mapping[str, MemoryTier],
                     origin: Optional[str] = None) -> Dict[str, float]:
        """Interleave weights ∝ effective (path-capped) peak bandwidth —
        the Linux weighted-interleave analogue, with weights measured
        from the topology instead of configured by hand.  NVMe-class
        tiers are excluded (they are spill, not interleave, targets)."""
        eff = self.effective_tiers(tiers, origin)
        w = {t: v.peak_bw_GBps for t, v in eff.items()
             if v.kind != "nvme"}
        total = sum(w.values())
        if total <= 0:
            raise ValueError("no interleavable bandwidth in tier set")
        return {t: v / total for t, v in w.items()}

    # ------------------------------------------------------------------ #
    # contention (M/M/1-style queueing on shared links)                  #
    # ------------------------------------------------------------------ #
    def link_loads(self, flows: Sequence[Flow]
                   ) -> Dict[LinkKey, Dict[Tuple[str, str], float]]:
        """Offered GB/s per link, keyed by ``(tenant, class)`` — the
        attribution view the QoS blame plane joins violations against."""
        out: Dict[LinkKey, Dict[Tuple[str, str], float]] = {}
        for f in flows:
            for l in self.path(f.src, f.dst):
                d = out.setdefault(l.key, {})
                k = (f.tenant, f.cls)
                d[k] = d.get(k, 0.0) + f.offered_GBps
        return out

    def contended_flows(self, flows: Sequence[Flow],
                        max_rho: float = 0.95,
                        tracer=None) -> List[FlowResult]:
        """Realized bandwidth/latency per flow when run *concurrently*.

        Each link shares its bandwidth over the offered loads crossing
        it and charges an M/M/1 loaded-latency factor ``1 / (1 - rho)``
        — the same queueing shape as ``MemoryTier.loaded_latency``
        (Fig. 4), applied per link.  Utilization is *class-weighted*
        per victim flow: a byte of co-located traffic counts as
        ``interference.weight(link.kind, victim.cls, aggressor.cls)``
        bytes of pressure, so a writer degrades a reader's queue more
        than another reader would (CXL-Interference, arxiv 2411.18308).
        All-same-class flow sets reduce to the symmetric fair share.

        When a flow's weighted utilization exceeds ``max_rho`` the
        latency clamp engages: the link is *saturated*, which is
        recorded in ``self.link_saturations``, emitted as a
        ``link.saturated`` trace event (once per link per call, when a
        ``tracer`` is given), and surfaced as the flow's pre-clamp
        ``raw_rho``/``clamped`` in its :class:`FlowResult`.
        """
        paths = [self.path(f.src, f.dst) for f in flows]
        offered: Dict[LinkKey, Dict[str, float]] = {}
        for f, links in zip(flows, paths):
            for l in links:
                d = offered.setdefault(l.key, {})
                d[f.cls] = d.get(f.cls, 0.0) + f.offered_GBps
        m = self.interference
        saturated: set = set()
        out: List[FlowResult] = []
        for f, links in zip(flows, paths):
            bw = f.offered_GBps
            lat = 0.0
            bneck: Optional[LinkKey] = None
            worst_rho = 0.0
            clamped = False
            for l in links:
                loads = offered[l.key]
                wtotal = sum(m.weight(l.kind, f.cls, c, link=l.key) * v
                             for c, v in loads.items())
                share = (l.bw_GBps * f.offered_GBps / wtotal
                         if wtotal > l.bw_GBps else f.offered_GBps)
                if share < bw:
                    bw = share
                    bneck = l.key
                raw_rho = wtotal / l.bw_GBps
                if raw_rho > worst_rho:
                    worst_rho = raw_rho
                rho = min(raw_rho, max_rho)
                if raw_rho > max_rho:
                    clamped = True
                    if l.key not in saturated:
                        saturated.add(l.key)
                        self.link_saturations[l.key] = \
                            self.link_saturations.get(l.key, 0) + 1
                        if tracer is not None:
                            tracer.event(
                                "link.saturated", cat="topology",
                                link=f"{l.key[0]}-{l.key[1]}",
                                kind=l.kind, raw_rho=raw_rho,
                                offered_GBps=sum(loads.values()),
                                bw_GBps=l.bw_GBps, victim_cls=f.cls)
                lat += l.latency_ns / (1.0 - rho)
            out.append(FlowResult(bw, lat, bneck, raw_rho=worst_rho,
                                  clamped=clamped))
        return out

    def describe(self, tiers: Optional[Mapping[str, MemoryTier]] = None,
                 origin: Optional[str] = None) -> List[str]:
        """Human-readable summary lines (CLI --topology banner)."""
        o = self._origin(origin)
        lines = [f"topology {self.name}: {len(self.nodes)} nodes, "
                 f"{len(self.links)} links, origin={o}"]
        for tier, node in sorted(self.tier_nodes.items()):
            lat = self.tier_latency_ns(tier, o)
            bw = self.tier_bw_GBps(tier, o)
            hops = len(self.tier_links(tier, o))
            extra = ""
            if tiers and tier in tiers:
                eff = self.effective_tiers({tier: tiers[tier]}, o)[tier]
                extra = (f"  eff_latency={eff.unloaded_latency_ns + eff.hop_latency_ns:.0f} ns"
                         f" eff_bw={eff.peak_bw_GBps:.1f} GB/s")
            bw_s = "local" if bw == float("inf") else f"{bw:.1f} GB/s"
            lines.append(f"  {tier:14s} @ {node:12s} hops={hops} "
                         f"+{lat:.0f} ns path_bw={bw_s}{extra}")
        return lines
