"""The port's topology plane against the JAX reference's, on the inputs
of ``tests/test_topology.py``: path queries and their latencies,
distance-adjusted tiers, contended flow rates under the interference
matrix, saturation counts and trace events, link loads, rebuilt graphs,
step costs priced over paths and the replanner's distance order.  Each
scenario runs once on each package; integers and decisions must be
equal, floats within 1e-9 relative.  Also: the port's ``h100-node``
testbed, which replaces the reference's ``tpu-pod``, and an engine
under ``topology="far-socket"`` with a narrow link, on both decode
paths."""
import dataclasses

import pytest

pytest.importorskip("torch")

from _torch_parity import (assert_engines_match, assert_same,  # noqa: E402
                           package, plain, raised, serve_both, tiny_model)

MODS = ("core", "telemetry", "topology", "obs")
REF, PORT = package("repro", *MODS), package("repro_torch", *MODS)
TOPOLOGIES = ("vendor-a", "vendor-b", "vendor-c", "far-socket")


def both(scenario, *args):
    return scenario(PORT, *args), scenario(REF, *args)


def check(scenario, *args):
    got, want = both(scenario, *args)
    assert_same(got, want)
    return plain(got)


def _links(links):
    return [(link.a, link.b, link.latency_ns, link.bw_GBps, link.kind)
            for link in links]


# ===================================================================== #
# graph path queries                                                    #
# ===================================================================== #
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_paths_and_latencies_match_reference(name):
    def scenario(ns):
        tb = ns.topology.build_topology(name)
        g = tb.graph
        nodes = sorted(g.nodes)
        out = {"tiers": tb.tiers, "fast": tb.fast,
               "capacity": tb.capacity_tier, "describe": tb.describe(),
               "effective": tb.effective_tiers(),
               "effective_socket1": tb.effective_tiers("socket1")}
        for a in nodes:
            for b in nodes:
                out[f"{a}->{b}"] = (_links(g.path(a, b)),
                                    g.hop_latency_ns(a, b),
                                    g.path_bw_GBps(a, b))
        for t in sorted(tb.tiers):
            out[t] = (_links(g.tier_links(t)), g.tier_latency_ns(t),
                      g.tier_bw_GBps(t), _links(g.tier_path("LDRAM", t)))
        out["order"] = g.tier_distance_order(tb.tiers)
        out["weights"] = g.tier_weights(
            {k: v for k, v in tb.tiers.items() if k != "NVMe"})
        return out
    check(scenario)


def test_far_socket_pays_the_extra_hop_like_reference():
    def scenario(ns):
        near = ns.topology.build_topology("vendor-a").effective_tiers()
        far = ns.topology.build_topology("far-socket").effective_tiers()
        return near, far
    near, far = check(scenario)
    assert far["CXL"]["hop_latency_ns"] == pytest.approx(87 + 153)
    assert far["LDRAM"] == near["LDRAM"]


def test_bad_topologies_and_graph_usage_raise_like_reference():
    def scenario(ns):
        g = ns.topology.TopologyGraph()
        g.add_node("a")
        out = [raised(ns.topology.build_topology, "vendor-z"),
               raised(g.add_node, "a"),
               raised(g.add_link, "a", "missing", 1.0, 1.0)]
        g.add_node("b")
        out.append(raised(g.path, "a", "b"))
        out.append(raised(g.alias_tier, "nope", "x"))
        return out
    got, want = both(scenario)
    # the port lists h100-node where the reference lists tpu-pod
    want[0] = want[0].replace("tpu-pod", "h100-node")
    assert_same(got, want)
    assert all(got)


# ===================================================================== #
# contention under the interference matrix                              #
# ===================================================================== #
FLOW_SETS = {
    "fair-share": [("socket0", "numa1", 200.0, "read", None),
                   ("socket0", "cxl0", 100.0, "read", None)],
    "disjoint": [("socket0", "numa0", 100.0, "read", None),
                 ("socket1", "numa1", 100.0, "read", None)],
    "readers": [("socket0", "numa1", 100.0, "read", "v"),
                ("socket0", "numa1", 100.0, "read", None)],
    "writer": [("socket0", "numa1", 100.0, "read", "v"),
               ("socket0", "numa1", 100.0, "write", None)],
    "saturated": [("socket0", "numa1", 150.0, "read", None),
                  ("socket0", "numa1", 150.0, "write", None)],
    "prefetch": [("socket0", "cxl0", 30.0, "prefetch", "b"),
                 ("socket0", "numa1", 60.0, "read", "a"),
                 ("socket0", "numa1", 40.0, "write", "a"),
                 ("socket0", "numa0", 10.0, "read", "c")],
}


@pytest.mark.parametrize("name", ["vendor-a", "far-socket"])
@pytest.mark.parametrize("flows", sorted(FLOW_SETS))
def test_contended_flow_rates_match_reference(name, flows):
    def scenario(ns):
        g = ns.topology.build_topology(name).graph
        tracer = ns.obs.TraceRecorder(clock=lambda: 0.0)
        fl = [ns.topology.Flow(a, b, bw, cls=c, tenant=t)
              for a, b, bw, c, t in FLOW_SETS[flows]]
        solo = [g.contended_flows([f])[0] for f in fl]
        res = g.contended_flows(fl, tracer=tracer)
        again = g.contended_flows(fl)
        return {"solo": solo, "res": res, "again": again,
                "loads": g.link_loads(fl),
                "saturations": dict(g.link_saturations),
                "trace": [(e.name, e.args) for e in tracer.events]}
    check(scenario)


def test_interference_matrix_weights_match_reference():
    def scenario(ns):
        m = ns.topology.InterferenceMatrix()
        kinds = ("cxl", "upi", "pcie", "ici", "local", "link")
        cls = ns.topology.INTERFERENCE_CLASSES
        out = {"classes": list(cls)}
        scaled = m.with_pair_scales({("upi", "read", "write"): 1.5,
                                     ("upi", "write", "read"): 1e-9})
        linked = m.with_link_scales(("socket0", "socket1"),
                                    {("read", "write"): 3.0})
        for k in kinds:
            for v in cls:
                for a in cls:
                    out[f"{k}/{v}/{a}"] = (
                        m.weight(k, v, a), scaled.weight(k, v, a),
                        linked.weight(k, v, a, link=("socket0",
                                                     "socket1")))
        return out
    check(scenario)


def test_rebuilt_graph_matches_reference():
    def scenario(ns):
        g = ns.topology.build_topology("far-socket").graph
        g.interference = ns.topology.InterferenceMatrix().with_pair_scales(
            {("upi", "read", "write"): 2.0})
        rg = g.rebuilt({("socket0", "socket1"): (87.0, 115.0)})
        return (rg.interference.weight("upi", "read", "write"),
                _links(rg.links.values()), rg.tier_nodes,
                rg.describe())
    check(scenario)


# ===================================================================== #
# distance-aware costing                                                #
# ===================================================================== #
def test_step_costs_over_paths_match_reference():
    def scenario(ns):
        G, C = ns.core.GiB, ns.core
        out = {}
        for name in TOPOLOGIES:
            tb = ns.topology.build_topology(name)
            objs = [C.DataObject("table", 64 * G,
                                 read_bytes_per_step=64 * G,
                                 random_fraction=0.6),
                    C.DataObject("field", 64 * G,
                                 read_bytes_per_step=128 * G)]
            plan = C.PlacementPlan(
                {"table": [("CXL", 1.0)],
                 "field": [("RDRAM", 0.88), ("CXL", 0.12)]}, "pinned", {})
            cost = C.plan_step_cost(objs, plan, tb.tiers,
                                    topology=tb.graph)
            out[name] = (cost, cost.step_s)
        return out
    got = check(scenario)
    assert got["far-socket"][1] > got["vendor-a"][1]


def test_distance_weighted_interleave_matches_reference():
    def scenario(ns):
        G, C = ns.core.GiB, ns.core
        tb = ns.topology.build_topology("vendor-a")
        tiers = {k: v for k, v in tb.tiers.items() if k != "NVMe"}
        tiers["LDRAM"] = dataclasses.replace(tiers["LDRAM"],
                                             capacity_GiB=64)
        objs = [C.DataObject("field", 192 * G,
                             read_bytes_per_step=2 * 192 * G)]
        uni = C.UniformInterleave(["LDRAM", "RDRAM", "CXL"])
        wtd = C.distance_weighted_policy(tb.graph, tiers)
        return {p.name: (p.plan(objs, tiers).shares,
                         C.plan_step_cost(objs, p.plan(objs, tiers), tiers,
                                          topology=tb.graph))
                for p in (uni, wtd)}
    check(scenario)


def _dual_cxl_machine(ns):
    """``conftest.dual_cxl_machine`` built with ``ns``'s classes."""
    g = ns.topology.TopologyGraph("dual-cxl", origin="socket0")
    g.add_node("socket0")
    g.add_node("socket1")
    g.add_node("numa0", kind="numa", tier="DRAM0")
    g.add_node("numa1", kind="numa", tier="DRAM1")
    g.add_node("cxl0", kind="cxl", tier="CXL0")
    g.add_node("cxl1", kind="cxl", tier="CXL1")
    g.add_link("socket0", "numa0", 0.0, 460.8, kind="local")
    g.add_link("socket1", "numa1", 0.0, 460.8, kind="local")
    g.add_link("socket0", "socket1", 87.0, 230.0, kind="upi")
    g.add_link("socket0", "cxl0", 153.0, 38.4, kind="cxl")
    g.add_link("socket1", "cxl1", 153.0, 38.4, kind="cxl")
    dram = ns.core.MemoryTier("DRAM0", 118, 460.8, 22.0, 256, kind="dram")
    cxl = ns.core.MemoryTier("CXL0", 118, 38.4, 9.0, 128, kind="cxl")
    return g, {"DRAM0": dram,
               "DRAM1": dataclasses.replace(dram, name="DRAM1"),
               "CXL0": cxl, "CXL1": dataclasses.replace(cxl, name="CXL1")}


def test_replanner_tier_order_follows_distance_like_reference():
    def scenario(ns):
        g, tiers = _dual_cxl_machine(ns)
        out = []
        for fast, origin in (("DRAM0", "socket0"), ("DRAM1", "socket1")):
            rp = ns.telemetry.AdaptiveReplanner(
                ns.telemetry.AccessTrace(), tiers, fast, topology=g,
                origin=origin)
            out.append((rp.tier_order, rp.default_tier, rp.tiers))
        return out
    got = check(scenario)
    assert got[0][0] == ["DRAM0", "DRAM1", "CXL0", "CXL1"]


def test_two_socket_builder_and_alias_match_reference():
    def scenario(ns):
        out = {}
        for sock in (0, 1):
            tb = ns.topology.two_socket_system("A", cxl_socket=sock)
            out[sock] = (_links(tb.graph.tier_links("CXL")), tb.name,
                         tb.description)
        g = ns.topology.build_topology("far-socket").graph
        g.alias_tier("LDRAM", "device")
        g.alias_tier("CXL", "pinned_host")
        out["alias"] = (g.node_of("device"), g.node_of("pinned_host"),
                        g.tier_latency_ns("pinned_host"),
                        g.tier_latency_ns("CXL"))
        return out
    check(scenario)


# ===================================================================== #
# h100-node (the port's single-card testbed)                            #
# ===================================================================== #
def _probes(dev=1400.0, pinned=54.0, pageable=8.0):
    from repro_torch.obs import TierProbe
    return [TierProbe("device", dev), TierProbe("pinned_host", pinned),
            TierProbe("unpinned_host", pageable)]


def test_h100_node_gives_back_the_probed_kinds():
    from repro_torch.topology import Flow, h100_node
    tb = h100_node(_probes())
    g = tb.graph
    assert (tb.fast, tb.capacity_tier) == ("device", "pinned_host")
    assert g.node_of("device") == "chip0"
    assert g.node_of("pinned_host") == g.node_of("unpinned_host") == "host0"
    (link,) = g.links.values()
    assert (link.kind, link.bw_GBps) == ("pcie", 54.0)
    assert link.latency_ns == pytest.approx(64 / 54 - 64 / 1400)
    # from the chip, every kind reads as kind_bases derives it from its
    # probe: 64 bytes at the probed rate
    for kind, t in tb.effective_tiers().items():
        rate = {"device": 1400.0, "pinned_host": 54.0,
                "unpinned_host": 8.0}[kind]
        assert t.peak_bw_GBps == rate
        assert t.unloaded_latency_ns + t.hop_latency_ns == \
            pytest.approx(64 / rate)
        assert t.capacity_GiB == 0.0
    # pinned and pageable host share the one PCIe link
    r = g.contended_flows([Flow("host0", "chip0", 50.0)] * 2)
    assert sum(x.achieved_GBps for x in r) == pytest.approx(54.0)


def test_h100_node_needs_every_kind_probed():
    from repro_torch.topology import h100_node
    with pytest.raises(ValueError, match="unpinned_host"):
        h100_node(_probes()[:2])


def test_build_topology_h100_node_probes_the_kinds_on_cpu():
    from repro_torch.topology import build_topology, H100_KINDS
    tb = build_topology("h100-node", device="cpu")
    assert sorted(tb.tiers) == sorted(H100_KINDS)
    assert all(t.peak_bw_GBps > 0 for t in tb.tiers.values())


def test_tpu_pod_topology_names_h100_node():
    from repro_torch.topology import build_topology, TOPOLOGY_CHOICES
    with pytest.raises(ValueError, match="h100-node"):
        build_topology("tpu-pod")
    assert "tpu-pod" not in TOPOLOGY_CHOICES
    assert "h100-node" in TOPOLOGY_CHOICES


# ===================================================================== #
# the engine under a topology, against the reference engine             #
# ===================================================================== #
SV = dict(block_tokens=8, max_batch=3, max_context=40, policy="tiering08",
          replan_every=2)


@pytest.fixture(scope="module")
def tiny():
    return tiny_model("llama3-8b", 2, (12, 7, 9, 20, 5))


@pytest.fixture
def engine_parity(tiny):
    def run(**kw):
        ref, ref_rep, eng, rep = serve_both(tiny, {**SV, **kw}, 10)
        assert_engines_match(ref, ref_rep, eng, rep)
        return ref, eng
    return run


def _narrow(ns, bw_GBps):
    """``build_topology`` of ``ns`` with the far-socket testbed's UPI and
    CXL links narrowed to ``bw_GBps``."""
    real = ns.topology.build_topology

    def build(name, **kw):
        tb = real(name, **kw)
        g = tb.graph.rebuilt({k: (link.latency_ns, bw_GBps)
                              for k, link in tb.graph.links.items()
                              if link.kind in ("upi", "cxl")})
        return dataclasses.replace(tb, graph=g)
    return build


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_topology_engine_matches_reference(engine_parity, fused,
                                           monkeypatch):
    """far-socket with its links narrowed: the scheduler's link budget
    defers admissions, and the adaptive replanner prices moves over the
    graph's paths; tokens, telemetry, replan decisions and the trace
    equal the reference's."""
    import repro.topology
    import repro_torch.serving.engine
    monkeypatch.setattr(repro.topology, "build_topology",
                        _narrow(REF, 7e-5))
    monkeypatch.setattr(repro_torch.serving.engine, "build_topology",
                        _narrow(PORT, 7e-5))
    ref, eng = engine_parity(topology="far-socket", adaptive=True,
                             fused_gather=fused)
    t = eng.telemetry_summary()
    assert t["link_deferrals"] > 0
    assert plain(eng.topo.tier_nodes)["device"] == "numa0"
    assert eng.replanner.executor.topology is eng.topo
