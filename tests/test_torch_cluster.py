"""The port's multi-host cluster plane against the JAX reference's, on
the CPU: the session router's policies over seeded sequences of
headroom, distance, load and pending reservations; the hierarchical
arbiter's split under ``replica_capacity``; ``multi_host_pod`` on the
reference's tiers (graph and distances), and on probes; replica meshes
and placement on one device; ``ClusterPlane`` serving the llama3-8b
smoke model on one step clock (routed counts, every session's tokens,
namespace conservation, the published gauges, the merged trace); and
``--replicas 2`` through both serve CLIs.

The reference's pod is built from its TPU tiers; the port's takes the
same per-host parts (``REF_PARTS``) where distances are compared.
Integers and decisions must be equal, floats within 1e-9 relative."""
import random
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from repro_torch.models import shardings as msh  # noqa: E402
from _torch_parity import (assert_same, package, PlaneSteps,  # noqa: E402
                           ref_pod_parts, StepClock, tiny_model)

MODS = ("cluster", "cluster.router", "cluster.sharding", "pool",
        "topology", "serving")
REF, PORT = package("repro", *MODS), package("repro_torch", *MODS)
MiB = 2**20
POLICIES = ("headroom-distance", "round-robin", "random", "least-loaded")
CPU = torch.device("cpu")


REF_PARTS = ref_pod_parts()


def _pod(ns, n):
    if ns is REF:
        return ns.topology.multi_host_pod(n)
    return ns.topology.multi_host_pod(n, tiers=REF_PARTS)


# ===================================================================== #
# SessionRouter                                                         #
# ===================================================================== #
def _route_scenario(ns, policy, seed):
    """A seeded sequence of routing decisions: 2-4 replicas at random
    distances, whose headroom and load change between decisions,
    sessions with and without a KV hint, pending reservations drained
    now and then."""
    rs = random.Random(seed)
    n = rs.randint(2, 4)
    state = {f"r{i}": {"head": rs.choice([0, 1, 3, 8]) * MiB,
                       "load": rs.randint(0, 4)} for i in range(n)}
    r = ns.cluster_router.SessionRouter(policy, seed=seed)
    for name in state:
        r.register(name, distance_ns=rs.choice([0.0, 50.0, 120.0, 300.0]),
                   headroom_fn=lambda n=name: state[n]["head"],
                   load_fn=lambda n=name: state[n]["load"])
    picks = []
    for i in range(24):
        kv = rs.choice([None, 0, MiB, 2 * MiB, 5 * MiB])
        req = ns.cluster_router.SessionRequest(
            f"s{i}", prompt_tokens=rs.randint(1, 64),
            new_tokens=rs.randint(1, 32), kv_bytes_hint=kv)
        pick = r.route(req)
        picks.append((pick, {v.name: v.pending_bytes
                             for v in r._views.values()}))
        state[pick]["load"] += 1
        if rs.random() < 0.3:
            victim = rs.choice(sorted(state))
            state[victim]["head"] = rs.choice([0, 2, 6, 10]) * MiB
        if rs.random() < 0.2:
            r.drain_pending()
    return picks, r.routed_counts(), r.replicas


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("policy", POLICIES)
def test_router_policies_match_reference(policy, seed):
    assert_same(_route_scenario(PORT, policy, seed),
                _route_scenario(REF, policy, seed))


def test_router_refusals_match_reference():
    def scenario(ns):
        out = []
        for make in (lambda: ns.cluster_router.SessionRouter("fastest"),
                     lambda: ns.cluster_router.SessionRouter().route(
                         ns.cluster_router.SessionRequest("s0"))):
            try:
                make()
                out.append("")
            except ns.serving.ConfigError as e:
                out.append(str(e))
        return out
    got, want = scenario(PORT), scenario(REF)
    assert got == want and all(want)


# ===================================================================== #
# hierarchical arbiter under replica_capacity                           #
# ===================================================================== #
@pytest.mark.parametrize("caps", [(2, 3), (5, 5), (1, 8), (9, 0)])
def test_arbiter_split_under_replica_capacity_matches_reference(caps):
    def scenario(ns):
        led = ns.pool.ResidencyLedger()
        for t in ("h0/serving", "h1/serving", "h1/batch"):
            led.register_tenant(t)
        led.register("h0/serving", "kv0", {"FAST": 4 * MiB, "CXL": MiB})
        led.register("h1/serving", "kv1", {"FAST": 2 * MiB})
        led.register("h1/batch", "kv2", {"FAST": 3 * MiB, "CXL": 5 * MiB})
        cap = {"h0": caps[0] * MiB, "h1": caps[1] * MiB}
        arb = ns.pool.TierBudgetArbiter(led, "FAST",
                                        capacity_bytes=sum(cap.values()),
                                        replica_capacity=cap)
        grant = arb.split(arb.demands())
        per = {}
        for tenant, g in grant.items():
            r = ns.cluster.Namespace.of(tenant).replica
            per[r] = per.get(r, 0) + g
        return grant, per, {h: led.bytes_on("FAST", f"{h}/*")
                            for h in ("h0", "h1")}, led.aggregate("*/*")
    got, want = scenario(PORT), scenario(REF)
    assert_same(got, want)
    for r, g in got[1].items():
        assert g <= caps[int(r[1])] * MiB


# ===================================================================== #
# multi_host_pod                                                        #
# ===================================================================== #
def _pod_view(tb):
    g = tb.graph
    return {"hosts": tb.hosts, "tiers": tb.tiers,
            "fast": tb.fast_tier, "capacity": tb.capacity_tier,
            "nodes": sorted((n, g.nodes[n].kind, g.nodes[n].tier)
                            for n in g.nodes),
            "links": sorted((l.a, l.b, l.latency_ns, l.bw_GBps, l.kind)
                            for l in g.links.values()),
            "tier_nodes": g.tier_nodes,
            "distances": {f"{a}->{b}": tb.distance_ns(a, b)
                          for a in ["router"] + tb.hosts
                          for b in ["router"] + tb.hosts},
            "effective": tb.graph.effective_tiers(tb.tiers),
            "describe": tb.graph.describe(tb.tiers)}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_multi_host_pod_on_reference_tiers_matches_reference(n):
    assert_same(_pod_view(_pod(PORT, n)), _pod_view(_pod(REF, n)))
    assert PORT.topology.ROUTER_NODE == REF.topology.ROUTER_NODE


def test_multi_host_pod_from_probes_keeps_the_reference_routing():
    """Built from probes, every host is an ``h100_node`` of its own and
    every link on the router's paths has one positive latency: each
    replica's distance over the largest is the reference's."""
    from repro_torch.obs import TierProbe
    probes = [TierProbe("device", 1450.0), TierProbe("pinned_host", 54.0),
              TierProbe("unpinned_host", 7.5)]
    for n in (1, 2, 3, 4):
        tb = PORT.topology.multi_host_pod(n, probes=probes)
        ref = REF.topology.multi_host_pod(n)
        assert [r.name for r in tb.replicas.values()] == \
            [f"h100-node/{h}" for h in tb.hosts]
        assert len({id(r.graph) for r in tb.replicas.values()}) == n
        dist = [tb.distance_ns("router", h) for h in tb.hosts]
        want = [ref.distance_ns("router", h) for h in ref.hosts]
        assert all(d > 0 for d in dist)
        np.testing.assert_allclose(np.array(dist) / max(dist),
                                   np.array(want) / max(want), rtol=1e-12)
        assert tb.tiers["FAST0"].peak_bw_GBps == 1450.0
        assert tb.tiers["CXL0"].peak_bw_GBps == 54.0
    with pytest.raises(ValueError, match="n_hosts must be >= 1"):
        PORT.topology.multi_host_pod(0, probes=probes)


# ===================================================================== #
# replica meshes and placement                                          #
# ===================================================================== #
def test_replica_meshes_share_or_partition_like_reference(monkeypatch):
    import jax
    for n in (1, 2, 3):
        ref = REF.cluster_sharding.replica_meshes(n)
        got = PORT.cluster_sharding.replica_meshes(n, devices=[CPU])
        assert [m.devices.shape for m in got] == \
            [m.devices.shape for m in ref]
        assert [m.axis_names for m in got] == [m.axis_names for m in ref]
        assert len(jax.devices()) == 1 and \
            all(m.device == CPU for m in got)
    # five cards, as a machine that has them (a mesh checks its devices)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 5)
    cards = [torch.device("cuda", i) for i in range(5)]
    for n, groups in ((2, [[0, 1], [2, 3]]), (5, [[i] for i in range(5)]),
                      (7, [[i % 5] for i in range(7)])):
        got = PORT.cluster_sharding.replica_meshes(n, devices=cards)
        assert [[d.index for d in m.devices.flat] for m in got] == groups
    with pytest.raises(ValueError, match="n_replicas must be >= 1"):
        PORT.cluster_sharding.replica_meshes(0, devices=[CPU])


def test_shard_lm_params_keeps_tensors_on_one_device_and_raises_on_split():
    """On a one-device mesh every leaf stays whole, whatever the mapping,
    and a leaf already there is the placed leaf's one shard (replicas
    sharing a device share its weights); a leaf elsewhere is moved onto
    the mesh's device.  On a mesh of two logical devices vocab and
    experts split into views of the leaves, and an engine with expert
    residency builds over the split store, one pool block per (layer,
    expert) at the whole expert's bytes, as the reference's pool keeps
    them.  What still raises: a mesh naming a device the machine
    lacks."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, Mesh
    from repro_torch.models import lm
    sh = PORT.cluster_sharding
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    one = sh.replica_meshes(2, devices=[CPU])[1]
    with sh.axis_mapping({"vocab": "model", "experts": "model"}) as m:
        assert sh.current_axis_mapping() is m
        assert m.spec("vocab", None) == ("model", None)
        placed = sh.shard_lm_params(params, one)
    assert sh.current_axis_mapping().mapping == {}
    assert placed["embed"].shards == [params["embed"]]
    assert not placed["embed"].is_split
    assert all(a.shards[0] is b for a, b in zip(
        placed["units"]["layers"][0]["moe"].values(),
        params["units"]["layers"][0]["moe"].values()))
    assert msh.compute_view(placed)["embed"] is params["embed"]
    # a leaf elsewhere is moved onto the mesh's device
    meta = make_mesh((1,), ("model",), devices=["meta"])
    moved = sh.shard_lm_params(params, meta)
    assert moved["embed"].shards[0].device.type == "meta"
    assert moved["embed"].shape == params["embed"].shape
    fn = lambda x: x + 1  # noqa: E731
    x = torch.arange(4.0)
    out = sh.replica_shard_map(fn, one, (None,), sh.PartitionSpec())(x)
    assert torch.equal(out.full(), x + 1)
    two = make_mesh((2,), ("model",), devices=[CPU, CPU])
    with sh.axis_mapping({"vocab": "model", "experts": "model"}):
        split = sh.shard_lm_params(params, two)
    emb = split["embed"]
    assert emb.shard_shapes() == [(cfg.vocab // 2, cfg.d_model)] * 2
    assert [t.data_ptr() for t in emb.shards] == [
        params["embed"][i * cfg.vocab // 2].data_ptr() for i in range(2)]
    with pytest.raises(ValueError, match="has 0 CUDA device"):
        Mesh(np.array([CPU, torch.device("cuda", 0)], dtype=object),
             ("model",))
    from repro_torch.serving.expert_pool import (expert_nbytes_from_config,
                                                moe_layers_from_config)
    assert split["units"]["layers"][0]["moe"]["w_up"].is_split
    eng = PORT.serving.ServingEngine(
        cfg, msh.compute_view(split), PORT.serving.ServingConfig(
            fused_gather=True, expert_policy="lru"), device="cpu")
    pool = eng.expert_pool
    assert len(pool.kinds) == moe_layers_from_config(cfg) * cfg.n_experts
    assert pool.expert_nbytes == expert_nbytes_from_config(cfg)
    assert pool.tenant == "serving.experts"


# ===================================================================== #
# ClusterPlane end to end (the llama3-8b smoke model, one step clock)    #
# ===================================================================== #
PROMPT_LENS = (12, 7, 9, 20, 5)
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def model():
    return tiny_model("llama3-8b", 2, PROMPT_LENS)


def _serve_plane(ns, model, policy):
    jcfg, jparams, cfg, params, prompts = model
    clock = StepClock()
    kw = {}
    if ns is PORT:
        kw = {"devices": ["cpu"], "testbed": _pod(ns, 2)}
        c, p = cfg, params
    else:
        c, p = jcfg, jparams
    plane = ns.cluster.ClusterPlane(
        c, p, serving=ns.serving.ServingConfig(
            block_tokens=8, max_batch=2, max_context=32,
            policy="tiering08"),
        n_replicas=2, router_policy=policy, clock=clock, seed=1, **kw)
    clock.engine = PlaneSteps(plane)
    sids = [plane.submit(pr, NEW_TOKENS, arrival_s=0.005 * i)
            for i, pr in enumerate(prompts)]
    rep = plane.run()
    tokens = {}
    for sid in sids:
        host, rid = sid.split(":")
        req = next(r for r in plane.replicas[host].engine.sched.finished
                   if r.rid == int(rid))
        tokens[sid] = list(req.out_tokens)
    trace = [(e.name, e.cat, e.ph, e.tid, e.args)
             for e in plane.merged_trace()]
    return {"sids": sids, "routed": rep.routed, "tokens": tokens,
            "summary": rep.summary,
            "replica_summaries": {h: r.summary
                                  for h, r in rep.per_replica.items()},
            "conservation": plane.namespace_conservation(),
            "conservation_slow": plane.namespace_conservation(
                "pinned_host"),
            "tenants": sorted(str(t) for t in plane.ledger.tenants),
            "gauges": plane.registry.snapshot(),
            "fast_bytes": plane.replica_fast_bytes,
            "trace": trace,
            "grant": plane.arbiter.split(plane.arbiter.demands())}


@pytest.mark.parametrize("policy", ["headroom-distance", "round-robin"])
def test_cluster_plane_matches_reference(model, policy):
    got = _serve_plane(PORT, model, policy)
    want = _serve_plane(REF, model, policy)
    assert_same(got, want)
    assert sum(got["routed"].values()) == len(PROMPT_LENS)
    assert all(got["routed"].values())
    cons = dict(got["conservation"])
    assert sum(v for h, v in cons.items() if h != "total") == cons["total"]
    assert got["tenants"] == ["host0/serving", "host1/serving"]
    assert all(len(t) == NEW_TOKENS for t in got["tokens"].values())
    for host in ("host0", "host1"):
        for g in ("fast_headroom_bytes", "active_sessions",
                  "routed_sessions", "distance_ns"):
            assert f"cluster.{host}.{g}" in got["gauges"]
    assert {t[3].split("/")[0] for t in got["trace"]} >= {"host0", "host1"}


def test_cluster_plane_shares_the_weights(model):
    _, _, cfg, params, _ = model
    plane = PORT.cluster.ClusterPlane(
        cfg, params, serving=PORT.serving.ServingConfig(
            block_tokens=8, max_batch=2, max_context=32),
        devices=["cpu"], testbed=_pod(PORT, 2))
    engines = [r.engine for r in plane.replicas.values()]
    assert all(e.params["embed"] is params["embed"] for e in engines)
    assert engines[0].pool is not engines[1].pool
    assert engines[0].ledger is engines[1].ledger is plane.ledger
    assert [str(r.ns) for r in plane.replicas.values()] == \
        ["host0/serving", "host1/serving"]
    with pytest.raises(ValueError, match="hosts for"):
        PORT.cluster.ClusterPlane(cfg, params, n_replicas=4,
                                  devices=["cpu"], testbed=_pod(PORT, 2))


# ===================================================================== #
# --replicas 2 through both CLIs                                        #
# ===================================================================== #
_TIMED = re.compile(r"(wall|throughput|worst_p95_latency)=[0-9.]+")


def _cluster_lines(text):
    """The cluster:, aggregate:, per-host routing and ledger: lines,
    wall time, tok/s and latency aside."""
    keep = [ln for ln in text.splitlines()
            if ln.startswith(("cluster:", "aggregate:", "ledger:"))
            or re.match(r"\s+host\d+: routed=", ln)]
    return [_TIMED.sub(r"\1=*", ln) for ln in keep]


def test_cli_replicas_prints_the_reference_lines(capsys, monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.cluster import plane as plane_mod
    from repro_torch.launch import serve
    argv = ["--arch", "llama3-8b", "--smoke", "--scheduler", "continuous",
            "--replicas", "2", "--router", "headroom-distance",
            "--num-requests", "4", "--new-tokens", "4", "--prompt-len", "12"]
    jserve.main(argv)
    want = _cluster_lines(capsys.readouterr().out)
    monkeypatch.setattr(
        plane_mod, "multi_host_pod",
        lambda n, probes=None: PORT.topology.multi_host_pod(
            n, tiers=REF_PARTS))
    serve.main(argv + ["--device", "cpu"])
    got = _cluster_lines(capsys.readouterr().out)
    assert len(want) == 5 and got == want
    for bad in (["--fused-gather"], ["--expert-policy", "lru"]):
        with pytest.raises(SystemExit):
            serve.main(argv + ["--device", "cpu"] + bad)
        assert "not yet supported with --replicas" in capsys.readouterr().err


def test_plane_over_a_larger_testbed_fails_like_reference(model):
    """The reference builds replicas for the first ``n_replicas`` hosts
    but runs every host of the testbed, so a testbed with more hosts
    fails in ``run`` (ROADMAP §3); the port keeps that behaviour."""
    jcfg, jparams, cfg, params, _ = model
    out = []
    for ns, c, p, kw in ((REF, jcfg, jparams, {}),
                         (PORT, cfg, params, {"devices": ["cpu"]})):
        plane = ns.cluster.ClusterPlane(
            c, p, serving=ns.serving.ServingConfig(
                block_tokens=8, max_batch=2, max_context=32),
            n_replicas=2, testbed=_pod(ns, 3), **kw)
        with pytest.raises(KeyError) as e:
            plane.run()
        out.append(str(e.value))
    assert out[0] == out[1] == "'host2'"
