"""Hardware topology graph and distance-aware costing (counterpart of
``repro.topology``): a graph of sockets / NUMA nodes / CXL devices /
chips joined by UPI / PCIe / CXL links, with shortest-path hop-latency
and bottleneck-bandwidth queries, the class-aware shared-link
contention model, and builders for the paper's vendor testbeds, one
H100 node and the cluster plane's multi-host pod.  ``effective_tiers``
is the bridge into the analytic layer: distance-adjusted MemoryTier
copies that the cost model, migration executor and adaptive replanner
price against."""
from .builders import (build_topology, ClusterTestbed, H100_KINDS,
                       h100_node, multi_host_pod, ROUTER_NODE, Testbed,
                       TOPOLOGY_CHOICES, two_socket_system)
from .graph import (Flow, FlowResult, INTERFERENCE_CLASSES,
                    InterferenceMatrix, LinkKey, TopoLink, TopologyGraph,
                    TopoNode)

__all__ = [
    "ClusterTestbed", "Flow", "FlowResult", "H100_KINDS",
    "INTERFERENCE_CLASSES", "InterferenceMatrix", "LinkKey", "ROUTER_NODE",
    "TopologyGraph", "TopoLink", "TopoNode", "TOPOLOGY_CHOICES", "Testbed",
    "build_topology", "h100_node", "multi_host_pod", "two_socket_system",
]
