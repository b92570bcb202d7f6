"""The port's core against the JAX reference's, on the inputs of the
reference's own tests: data objects, placement policies, the cost model
and ``interleave`` (``tests/test_{policies,costmodel,interleave}.py``),
and the framework-free copies the port keeps of ``core/tiers.py``,
``core/migration.py``, ``pool/ledger.py``, ``cluster/namespace.py`` and
the cut-down ``serving/scheduler.py``
(``tests/test_{core_tiers,migration,pool,cluster}.py``).

Each scenario runs once on each package and must give equal plans,
decisions and byte counts, and costs equal within 1e-12 relative."""
import dataclasses
import importlib
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import tree_to_torch  # noqa: E402

REL = 1e-12


def _pkg(root):
    mods = ("core", "core.objects", "core.policies", "core.costmodel",
            "core.interleave", "core.tiers", "core.migration",
            "pool.ledger", "cluster.namespace", "serving.kv_pool",
            "serving.scheduler")
    ns = types.SimpleNamespace(root=root)
    for m in mods:
        setattr(ns, m.replace(".", "_"),
                importlib.import_module(f"{root}.{m}"))
    return ns


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def _plan(plan):
    return (plan.policy, {k: list(v) for k, v in plan.shares.items()},
            dict(plan.tier_bytes))


def _cost(c):
    return {"per_tier_time": dict(c.per_tier_time),
            "latency_serial_s": c.latency_serial_s, "compute_s": c.compute_s,
            "phased_s": c.phased_s, "link_time": dict(c.link_time),
            "memory_s": c.memory_s, "step_s": c.step_s, "bound": c.bound}


def _tiers(ns, system="A", **caps):
    t = dict(ns.core_tiers.paper_system(system))
    for name, gib in caps.items():
        t[name] = dataclasses.replace(t[name], capacity_GiB=gib)
    return t


# ===================================================================== #
# objects                                                               #
# ===================================================================== #
def _objs(ns):
    DO, G = ns.core_objects.DataObject, ns.core_tiers.GiB
    return [DO("big_stream", 50 * G, read_bytes_per_step=100 * G),
            DO("big_random", 40 * G, read_bytes_per_step=80 * G,
               random_fraction=0.95),
            DO("small", 1 * G, read_bytes_per_step=10 * G),
            DO("cold", 30 * G, read_bytes_per_step=0)]


WORKLOADS = ("BT", "LU", "CG", "MG", "SP", "FT", "XSBench")


def _inventories(ns):
    o = ns.core_objects
    inv = {"objs": _objs(ns),
           "train": o.llm_train_objects(1_500_000_000, 8 * 1024, 1600, 48),
           "serve": o.llm_serve_objects(65_000_000_000,
                                        120 * ns.core_tiers.GiB,
                                        2 * ns.core_tiers.GiB)}
    inv.update({w: o.hpc_workload_objects(w) for w in WORKLOADS})
    return inv


def test_object_inventories_and_selection_match_reference():
    def scenario(ns):
        out = {}
        for name, objs in _inventories(ns).items():
            out[name] = (
                [dataclasses.asdict(x) for x in objs],
                [(x.bytes_per_step, x.intensity, x.latency_sensitive,
                  x.bandwidth_hungry) for x in objs],
                [x.name for x in
                 ns.core_objects.select_interleave_candidates(objs)],
                [x.name for x in ns.core_objects.select_interleave_candidates(
                    objs, 0.2, top_k=1)],
                ns.core_objects.total_footprint(objs))
        return out
    ref, port = both(scenario)
    assert port == ref
    assert port["objs"][2] == ["big_stream"]


# ===================================================================== #
# policies                                                              #
# ===================================================================== #
SPECS = ("preferred", "preferred:CXL", "first_touch", "uniform",
         "uniform:LDRAM+CXL", "weighted:LDRAM=3+CXL=1", "oli", "oli_bw")


@pytest.mark.parametrize("system,caps", [("A", {}), ("B", {}),
                                         ("C", {"LDRAM": 60}),
                                         ("A", {"LDRAM": 64, "CXL": 32})])
def test_policy_plans_match_reference(system, caps):
    def scenario(ns):
        tiers = _tiers(ns, system, **caps)
        out = {}
        for spec in SPECS:
            pol = ns.core_policies.make_policy(spec, tiers)
            for name, objs in _inventories(ns).items():
                out[(spec, name)] = _plan(pol.plan(objs, tiers))
        pols = (ns.core_policies.ObjectLevelInterleave(
                    "LDRAM", ["CXL"], footprint_threshold=0.2,
                    fast_reserve_fraction=0.3),
                ns.core_policies.UniformInterleave(["RDRAM", "CXL"]),
                ns.core_policies.TierPreferred("RDRAM"))
        for pol in pols:
            out[pol.name] = _plan(pol.plan(_objs(ns), tiers))
        out["order"] = ns.core_policies._tier_order(tiers)
        return out
    ref, port = both(scenario)
    assert port == ref


def test_policy_errors_match_reference():
    for ns in (REF, PORT):
        tiers = _tiers(ns)
        with pytest.raises(ValueError, match="unknown policy"):
            ns.core_policies.make_policy("nope", tiers)
        with pytest.raises(ValueError, match="positive weights"):
            ns.core_policies.WeightedInterleave({"LDRAM": 0.0})


# ===================================================================== #
# cost model                                                            #
# ===================================================================== #
def _assert_costs_equal(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        for field, want in ref[k].items():
            got = port[k][field]
            if isinstance(want, dict):
                assert got.keys() == want.keys()
                for t in want:
                    assert got[t] == pytest.approx(want[t], rel=REL), \
                        (k, field, t)
            elif isinstance(want, float):
                assert got == pytest.approx(want, rel=REL), (k, field)
            else:
                assert got == want, (k, field)


@pytest.mark.parametrize("ldram", [64, 128, 768])
def test_step_costs_match_reference(ldram):
    def scenario(ns):
        tiers = _tiers(ns, LDRAM=ldram)
        cm, pol = ns.core_costmodel, ns.core_policies
        policies = [pol.TierPreferred("LDRAM"),
                    pol.UniformInterleave(["LDRAM", "CXL"]),
                    pol.UniformInterleave(["RDRAM", "CXL"]),
                    pol.ObjectLevelInterleave("LDRAM", ["CXL"]),
                    pol.ObjectLevelInterleave("LDRAM", ["CXL"],
                                              bandwidth_weighted=True)]
        out = {}
        for name, objs in _inventories(ns).items():
            for p, c in cm.compare_policies(objs, policies, tiers).items():
                out[(name, p)] = _cost(c)
            plan = policies[0].plan(objs, tiers)
            for compute in (0.0, 100.0):
                for streams in (8, 32):
                    out[(name, compute, streams)] = _cost(cm.plan_step_cost(
                        objs, plan, tiers, total_streams=streams,
                        compute_time_s=compute))
        return out
    _assert_costs_equal(*reversed(both(scenario)))


@pytest.mark.parametrize("cap,grid", [(96, 4), (196, 4), (320, 5)])
def test_policy_search_matches_reference(cap, grid):
    def scenario(ns):
        o = ns.core_objects
        objs = o.llm_serve_objects(n_params=30_000_000_000,
                                   kv_bytes=80 * ns.core_tiers.GiB,
                                   act_bytes=2 * ns.core_tiers.GiB)
        res = ns.core_costmodel.policy_search(objs, _tiers(ns, LDRAM=cap),
                                              fast="LDRAM", grid=grid)
        return res.fractions, res.step_s, _plan(res.plan)
    (rf, rs, rp), (pf, ps, pp) = both(scenario)
    assert pf == rf and pp == rp
    assert ps == pytest.approx(rs, rel=REL)


def test_policy_search_infeasible_raises_like_reference():
    for ns in (REF, PORT):
        objs = ns.core_objects.llm_serve_objects(
            65_000_000_000, 120 * ns.core_tiers.GiB, 2 * ns.core_tiers.GiB)
        tiers = {k: dataclasses.replace(v, capacity_GiB=1)
                 for k, v in _tiers(ns).items()}
        with pytest.raises(RuntimeError, match="no feasible placement"):
            ns.core_costmodel.policy_search(objs, tiers, fast="LDRAM",
                                            grid=2)


# ===================================================================== #
# interleave                                                            #
# ===================================================================== #
def _tree(zeros, f32, bf16):
    return {"layers": [{"attn": (zeros((4, 8), dtype=f32),
                                 zeros((8,), dtype=bf16))},
                       {"mlp": [zeros((2, 2), dtype=f32)]}],
            "embed": zeros((16, 4), dtype=f32)}


def _objects(objs):
    return [dataclasses.asdict(o) for o in objs]


def test_objects_from_pytree_matches_reference():
    from repro.core.interleave import objects_from_pytree as jobjects
    from repro_torch.core.interleave import objects_from_pytree
    jt = _tree(jnp.zeros, jnp.float32, jnp.bfloat16)
    tt = _tree(torch.zeros, torch.float32, torch.bfloat16)

    def traffic(name, leaf):
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        return 2 * n, n, 0.25 if name.startswith("layers") else 0.0

    got = _objects(objects_from_pytree(tt))
    assert got == _objects(jobjects(jt))
    assert [o["name"] for o in got] == ["embed", "layers/0/attn/0",
                                        "layers/0/attn/1", "layers/1/mlp/0"]
    assert _objects(objects_from_pytree(tt, traffic, "opt_state")) == \
        _objects(jobjects(jt, traffic, "opt_state"))
    nt = (np.zeros((3, 3), np.float64), [np.zeros(5, np.int32)])
    assert _objects(objects_from_pytree(nt)) == _objects(jobjects(nt))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_objects_from_model_params_match_reference(arch):
    """Leaf names and order (e.g. ``units/layers/0/attn/wq``), sizes and
    OLI plans on the models' own parameter trees."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.core.interleave import objects_from_pytree as jobjects
    from repro.models import lm as jlm
    from repro_torch.core.interleave import objects_from_pytree
    jparams = jlm.init_params(jax.random.PRNGKey(0), jsmoke(arch))
    want = jobjects(jparams)
    got = objects_from_pytree(tree_to_torch(jparams))
    assert _objects(got) == _objects(want)
    assert "units/layers/0/attn/wq" in {o.name for o in got}
    tiers = {}
    for ns in (REF, PORT):
        t = _tiers(ns, LDRAM=want[0].nbytes * 3 / ns.core_tiers.GiB)
        tiers[ns.root] = (t, ns.core_policies.ObjectLevelInterleave(
            "LDRAM", ["CXL"]))
    rt, rpol = tiers["repro"]
    pt, ppol = tiers["repro_torch"]
    assert _plan(ppol.plan(got, pt)) == _plan(rpol.plan(want, rt))


def test_realize_plan_places_like_reference():
    """Each leaf's blocks land on the reference's memory kinds with the
    reference's row spans, and gather back to the leaf."""
    from repro.core.interleave import realize_plan as jrealize
    from repro_torch.core.interleave import realize_plan
    from repro_torch.core.policies import PlacementPlan
    rs = np.random.RandomState(0)
    leaves = {"a": rs.standard_normal((300, 4)).astype(np.float32),
              "b": {"c": rs.standard_normal((70,)).astype(np.float32)}}
    shares = {"a": [("HBM", 0.7), ("HOST", 0.3)],
              "b/c": [("LDRAM", 0.5), ("CXL", 0.25), ("RDRAM", 0.25)]}
    jt = jax.tree.map(jnp.asarray, leaves)
    tt = jax.tree.map(torch.from_numpy, leaves)
    want = jrealize(jt, REF.core_policies.PlacementPlan(shares, "p", {}),
                    block_rows=16)
    got = realize_plan(tt, PlacementPlan(shares, "p", {}), block_rows=16,
                       device="cpu")
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].kinds == want[name].kinds
        assert [b.shape[0] for b in got[name].blocks] == \
            [b.shape[0] for b in want[name].blocks]
        np.testing.assert_array_equal(got[name].gather().numpy(),
                                      np.asarray(want[name].gather()))


def test_recommend_streams_and_distance_weights_match_reference():
    from repro.core import interleave as jinter
    from repro.topology import build_topology
    from repro_torch.core import interleave as inter
    for system in ("A", "B", "C"):
        assert inter.recommend_streams(_tiers(PORT, system), 32) == \
            jinter.recommend_streams(_tiers(REF, system), 32)
    # the topology is duck-typed: the port reads the reference's graph
    tb = build_topology("far-socket")
    got = inter.distance_weights(tb.graph, tb.tiers)
    assert got == jinter.distance_weights(tb.graph, tb.tiers)
    sub = [t for t in got][:2]
    assert inter.distance_weighted_policy(tb.graph, tb.tiers,
                                          tier_set=sub).weights == \
        jinter.distance_weighted_policy(tb.graph, tb.tiers,
                                        tier_set=sub).weights


# ===================================================================== #
# the PR 11 copies: tiers, migration, ledger, namespace, scheduler       #
# ===================================================================== #
def test_tier_models_match_reference():
    def scenario(ns):
        t = ns.core_tiers
        out = {}
        for system in ("A", "B", "C"):
            tiers = t.paper_system(system)
            out[system] = {k: dataclasses.asdict(v) for k, v in tiers.items()}
            for name, tier in tiers.items():
                out[(system, name)] = (
                    [tier.bandwidth(s) for s in (0, 1, 4, 8, 28, 64)],
                    [tier.loaded_latency(tier.peak_bw_GBps * f)
                     for f in (0.0, 0.5, 0.9, 1.0, 2.0)],
                    [tier.access_time_s(1 << 30, s, r)
                     for s in (1.0, 8.0) for r in (False, True)])
            for streams in (4, 32, 52):
                out[(system, "assign", streams)] = t.assign_streams(
                    tiers, streams)
                out[(system, "interleave", streams)] = \
                    t.interleave_bandwidth(
                        {k: tiers[k] for k in ("LDRAM", "CXL")},
                        streams=streams)
        return out
    ref, port = both(scenario)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=REL) \
            if not isinstance(ref[k], dict) else port[k] == ref[k], k


MB64 = 64 * 1024**2


@pytest.mark.parametrize("policy", ["NoBalance", "AutoNUMA", "Tiering08",
                                    "TPP"])
@pytest.mark.parametrize("trace,fast_cap", [("stable", 40),
                                            ("scattered", 12),
                                            ("uniform", 40)])
def test_migration_sims_match_reference(policy, trace, fast_cap):
    def scenario(ns):
        m = ns.core_migration
        blocks = ([m.Block("a", i, MB64, "CXL") for i in range(48)]
                  + [m.Block("a", 1000 + i, MB64, "LDRAM")
                     for i in range(8)])
        ids = [(b.obj, b.idx) for b in blocks]
        tr = {"stable": lambda: m.trace_stable_hotset(ids, epochs=25,
                                                      hot_fraction=0.15),
              "scattered": lambda: m.trace_scattered_hotset(
                  ids, epochs=30, hot_fraction=0.4),
              "uniform": lambda: m.trace_uniform(ids, epochs=25)}[trace]()
        sim = m.MigrationSim(blocks, _tiers(ns), "LDRAM",
                             getattr(m, policy)(),
                             fast_capacity_bytes=fast_cap * MB64)
        res = sim.run(tr)
        return (dataclasses.asdict(res.stats), res.exec_time_s,
                res.fast_hit_fraction)
    (rs, rt, rh), (ps, pt, ph) = both(scenario)
    assert ps == rs
    assert pt == pytest.approx(rt, rel=REL)
    assert ph == pytest.approx(rh, rel=REL)


def test_migration_executor_matches_reference():
    def scenario(ns):
        m = ns.core_migration
        tiers = _tiers(ns, LDRAM=96)
        moved = []

        def move_fn(obj, src, dst, nbytes):
            moved.append((obj, src, dst, nbytes))
            return nbytes // 2 if obj == "b" else nbytes
        ex = m.MigrationExecutor(tiers, move_fn=move_fn)
        old = {"a": [("CXL", 1.0)], "b": [("LDRAM", 0.5), ("CXL", 0.5)],
               "c": [("RDRAM", 1.0)]}
        new = {"a": [("LDRAM", 0.75), ("CXL", 0.25)], "b": [("CXL", 1.0)],
               "c": [("RDRAM", 1.0)], "new": [("LDRAM", 1.0)]}
        nbytes = {"a": 8 << 30, "b": 3 << 30, "c": 1 << 30, "new": 1 << 20}
        d = ex.delta(old, new, nbytes)
        stats = ex.execute(d)
        blocks = m.make_blocks_from_plan(
            {"a": [("LDRAM", 0.5), ("CXL", 0.5)]}, {"a": 56 * MB64},
            block_bytes=MB64, interleaved_objs=["a"])
        return ([dataclasses.astuple(x) for x in d.moves], d.total_bytes,
                ex.cost_s(d), [ex.move_cost_s(x) for x in d.moves],
                ex.tier_rank(), dataclasses.asdict(stats), moved,
                [(m.obj, done) for m, done in ex.last_moves],
                m.MigrationExecutor.realized_shares(old, ex.last_moves,
                                                    nbytes),
                [(b.obj, b.idx, b.nbytes, b.tier, b.unmigratable)
                 for b in blocks])
    ref, port = both(scenario)
    assert port[0] == ref[0] and port[1] == ref[1]
    assert port[2] == pytest.approx(ref[2], rel=REL)
    assert port[3] == pytest.approx(ref[3], rel=REL)
    assert port[4:] == ref[4:]


def test_ledger_matches_reference():
    def scenario(ns):
        led_mod = ns.pool_ledger
        G = ns.core_tiers.GiB
        out = []
        led = led_mod.ResidencyLedger()
        led.register_tenant("a")
        led.register("a", "obj", {"LDRAM": 10, "CXL": 30})
        led.record_alloc("a", "obj", "CXL", 5)
        led.record_free("a", "obj", "CXL", 35)
        out.append((led.object_bytes("a", "obj"), led.bytes_on("LDRAM")))
        led.record_free("a", "obj", "LDRAM", 999)
        out.append((led.has("a", "obj"), vars(led.counters)))
        led.register("a", "x", {"CXL": 100})
        out.append([led.record_move("a", "x", "CXL", "LDRAM", 60)
                    for _ in range(2)])
        out.append((led.placement("a", "x"), led.shares("a")))
        led.register_tenant("b", weight=2.0)
        led.register("b", "x", {"LDRAM": 50, "CXL": 20})
        out.append((led.tier_occupancy("LDRAM"), led.tenant_bytes("b"),
                    led.aggregate(), led.nbytes_by_obj("b")))
        led.set_budget("a", "LDRAM", 50)
        out.append((led.headroom("a", "LDRAM"), led.can_place(
            "a", "LDRAM", 10), led.over_budget("a", "LDRAM")))
        led.set_budget("a", "LDRAM", 25)
        out.append((led.over_budget("a", "LDRAM"),
                    led.over_budget_tenants("LDRAM")))
        led.resize("a", "x", 200, grow_tier="CXL")
        led.resize("a", "x", 100)
        out.append(led.placement("a", "x"))
        priced = led_mod.ResidencyLedger(_tiers(ns),
                                         capacity_bytes={"LDRAM": 64 * G})
        priced.register_tenant("a")
        priced.register("a", "x", {"CXL": 10 * G})
        priced.register("a", "big", {"CXL": 60 * G})
        out.append([priced.move("a", o, "CXL", "LDRAM", n) for o, n in
                    (("x", 10 * G), ("big", 60 * G), ("big", G))])
        out.append((priced.summary(), vars(priced.counters)))
        with pytest.raises(led_mod.LedgerError):
            led.register("ghost", "x", {"LDRAM": 1})
        return out
    ref, port = both(scenario)
    assert port == ref


NS_STRINGS = ("a", "host0/serving", "host1/t/kv")
NS_PATTERNS = ("host1/*", "*/serving", "host?/serving/kv*", "host0/*",
               "serving", "*/*", "*")


def test_namespace_matches_reference():
    def scenario(ns):
        N = ns.cluster_namespace.Namespace
        out = [(str(N.parse(s)), N.parse(s).key,
                N.parse(str(N.parse(s))) == N.parse(s)) for s in NS_STRINGS]
        out.append([str(x) for x in (
            N(tenant="serving"),
            N(replica=ns.cluster_namespace.DEFAULT_REPLICA, tenant="a"),
            N(replica="host1", tenant="a"))])
        full = N(replica="host1", tenant="serving", obj="kv3")
        out.append([full.matches(p) for p in NS_PATTERNS])
        out.append([N(tenant="serving").matches(p) for p in NS_PATTERNS])
        keys = [N(replica="h1", tenant="b"), N(replica="h0", tenant="z"),
                N(replica="h0", tenant="a")]
        out.append([str(k) for k in sorted(keys)])
        h = N.parse("h0/t")
        out.append([str(h.with_obj("kv")), str(h.with_obj("kv").tenant_key),
                    str(h.in_replica("h9"))])
        out.append([ns.cluster_namespace.is_pattern(p) for p in
                    ("a", "a*", "h?/t", "[ab]")])
        for bad in (lambda: N(tenant="a/b"), lambda: N.parse("a/b/c/d"),
                    lambda: N(tenant="a").matches("a/b/c/d")):
            with pytest.raises(ValueError):
                bad()
        return out
    ref, port = both(scenario)
    assert port == ref


def test_scheduler_matches_reference():
    """Admission, growth, budget preemption and finishing on a
    metadata-only pool: the same request states, block tables and
    counters."""
    def scenario(ns):
        import numpy as np
        sch, kv = ns.serving_scheduler, ns.serving_kv_pool
        pool = kv.PagedKVPool(12, 4, fast_block_budget=6)
        s = sch.ContinuousBatchingScheduler(pool, sch.SchedulerConfig(
            max_batch=3, max_prefill_per_iter=2))
        reqs = [sch.Request(rid=i, prompt=np.zeros(n, np.int32),
                            max_new_tokens=5, arrival_s=0.1 * i,
                            priority=float(i % 2))
                for i, n in enumerate((9, 5, 13, 3))]
        for r in reqs:
            s.submit(r)
        log = []
        for step in range(6):
            adm = s.admit(now_s=0.1 * step)
            for r in adm:
                pool.alloc(r.rid, s.blocks_needed(r),
                           kind=kv.FAST_KIND if r.rid % 2 else None)
            log.append(([r.rid for r in adm],
                        [(r.rid, r.state.name) for r in reqs]))
            if step == 2:
                pool.fast_block_budget = 1
                log.append([v.rid for v in s.preempt_over_budget()])
            if step == 3:
                log.append([v.rid for v in s.preempt_for_blocks(
                    3, protect=s.running[0] if s.running else None)])
            if step == 4 and s.running:
                s.finish(s.running[0])
        log.append((s.budget_preemptions, dict(pool.table),
                    vars(pool.counters), pool.fast_used(),
                    [(r.rid, r.state.name, r.preemptions) for r in reqs]))
        log.append(sch.plan_admission(
            ns.root == "repro" and _jcfg() or _tcfg(), 16, 544, 40 << 30,
            80 << 30, max_batch_cap=64).__dict__)
        return log
    ref, port = both(scenario)
    assert port == ref


def _jcfg():
    from repro.configs import get_config
    return get_config("llama3-8b")


def _tcfg():
    from repro_torch.configs import get_config
    return get_config("llama3-8b")
