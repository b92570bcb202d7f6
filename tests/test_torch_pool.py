"""The port's arbiter, move scheduler and predictive control plane
against the JAX reference's, on the inputs of ``tests/test_pool.py``
(arbiter) and ``tests/test_predictive.py``: grants and their decisions,
phase-demand tables, pre-granted burst budgets, prefetched plans and
the budget-keyed plan cache, ledger-driven preemption, and move rounds
(order, fluid start/finish times, makespans, coalescing, preemption,
chunking, deferred callbacks).  Each scenario runs once on each
package; integers and decisions must be equal, floats within 1e-9
relative.  Also: the engine with ``adaptive=True, predictive=True`` on
both decode paths, against the reference engine."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import (assert_engines_match, assert_same,  # noqa: E402
                           package, plain, raised, serve_both, tiny_model,
                           tpu_bases)

MODS = ("core", "core.migration", "pool", "serving", "telemetry",
        "topology")
REF, PORT = package("repro", *MODS), package("repro_torch", *MODS)


def check(scenario, *args):
    got, want = scenario(PORT, *args), scenario(REF, *args)
    assert_same(got, want)
    return plain(got)


def _tiers(ns, ldram_gib=64):
    t = {k: v for k, v in ns.core.paper_system("A").items()
         if k in ("LDRAM", "CXL")}
    t["LDRAM"] = dataclasses.replace(t["LDRAM"], capacity_GiB=ldram_gib)
    return t


def _emit(ns, trace, burst):
    """One epoch of burst (hot, heavy) or lull (trickle) traffic."""
    G = ns.core.GiB
    if burst:
        trace.record("kv", read_bytes=120 * G, write_bytes=2 * G)
        trace.record("w", read_bytes=35 * G)
    else:
        trace.record("kv", read_bytes=1 * G)
        trace.record("w", read_bytes=2 * G)
    trace.advance_epoch()


# ===================================================================== #
# TierBudgetArbiter.split                                               #
# ===================================================================== #
SPLITS = {
    "fair_share": [("a", 10, 1.0, 1.0, None), ("b", 100, 1.0, 1.0, None)],
    "hungry": [("a", 100, 1.0, 1.0, None), ("b", 100, 1.0, 1.0, None)],
    "priority": [("a", 100, 1.0, 3.0, None), ("b", 100, 1.0, 1.0, None)],
    "throughput": [("hot", 40, 80.0, 1.0, None),
                   ("cold", 60, 6.0, 1.0, None)],
    "unclaimed": [("a", 4, 1.0, 1.0, 40), ("b", 8, 1.0, 1.0, 40)],
    "odd": [("a", 7, 3.0, 1.0, None), ("b", 11, 1.0, 2.0, None),
            ("c", 13, 2.0, 0.5, None)],
}


@pytest.mark.parametrize("objective", ["fair_share", "throughput",
                                       "priority"])
@pytest.mark.parametrize("demands", sorted(SPLITS))
def test_arbiter_split_matches_reference(objective, demands):
    """Grants, water-filled and rounded to whole bytes, as the
    reference rounds them."""
    def scenario(ns):
        G = ns.core.GiB
        led = ns.pool.ResidencyLedger(capacity_bytes={"LDRAM": 64 * G + 3})
        arb = ns.pool.TierBudgetArbiter(led, "LDRAM", objective=objective)
        ds = [ns.pool.TenantDemand(
            t, (res if res is not None else hot) * G + 1, hot * G + 1,
            rate * G, w) for t, hot, rate, w, res in SPLITS[demands]]
        return arb.split(ds)
    got = check(scenario)
    assert all(isinstance(v, int) for v in got.values())


def test_arbiter_measures_demand_and_rejects_like_reference():
    def scenario(ns):
        G = ns.core.GiB
        led = ns.pool.ResidencyLedger(capacity_bytes={"LDRAM": 64 * G})
        for name in ("serve", "train"):
            led.register_tenant(name, trace=ns.telemetry.AccessTrace())
            led.register(name, "obj", {"CXL": 40 * G})
        led.trace("serve").record("obj", read_bytes=40 * G)
        led.trace("serve").advance_epoch()
        led.trace("train").advance_epoch()
        arb = ns.pool.TierBudgetArbiter(led, "LDRAM", window_epochs=2)
        d = arb.rebalance(epoch=1)
        return (d, led.budget("serve", "LDRAM"), arb.demand("train"),
                raised(ns.pool.TierBudgetArbiter, ns.pool.ResidencyLedger(),
                       "LDRAM", capacity_bytes=G, objective="chaos"),
                raised(ns.pool.TierBudgetArbiter, ns.pool.ResidencyLedger(),
                       "LDRAM"))
    got = check(scenario)
    assert got[1] == 40 * 2**30


# ===================================================================== #
# predictive arbitration                                                #
# ===================================================================== #
def test_phase_demand_table_matches_reference():
    def scenario(ns):
        t = ns.pool.PhaseDemandTable(ttl_epochs=10, max_entries=2,
                                     alpha=0.5)
        out = []
        t.observe("a", 100, 10.0, epoch=1)
        t.observe("a", 200, 20.0, epoch=2)
        out.append(t.lookup("a", 3))
        t.observe("b", 50, 5.0, epoch=3)
        t.observe("c", 70, 7.0, epoch=4)
        t.evict_stale(4)
        out += [sorted(t.entries), t.lookup("b", 20)]
        t.evict_stale(20)
        out.append(dict(t.entries))
        return out
    got = check(scenario)
    assert got[0]["hot_bytes"] == 150


@pytest.mark.parametrize("predictive", [False, True])
def test_cycle_arbiter_grants_match_reference(predictive):
    def scenario(ns):
        G = ns.core.GiB
        tiers = _tiers(ns)
        led = ns.pool.ResidencyLedger(tiers,
                                      capacity_bytes={"LDRAM": 64 * G})
        tr = ns.telemetry.AccessTrace()
        led.register_tenant("serve", trace=tr)
        led.register("serve", "kv", {"CXL": 48 * G})
        led.register("serve", "w", {"CXL": 14 * G})
        arb = ns.pool.TierBudgetArbiter(led, "LDRAM",
                                        objective="fair_share",
                                        window_epochs=1,
                                        predictive=predictive)
        decisions, epoch = [], 0
        for _ in range(3):
            for i in range(8):
                epoch += 1
                decisions.append(arb.rebalance(epoch))
                _emit(ns, tr, burst=i < 2)
        return decisions, arb.predicted_grants
    got = check(scenario)
    assert (got[1] > 0) == predictive          # grants from predictions


def test_predictive_arbiter_falls_back_like_reference():
    def scenario(ns):
        G = ns.core.GiB
        led = ns.pool.ResidencyLedger(_tiers(ns),
                                      capacity_bytes={"LDRAM": 64 * G})
        led.register_tenant("quiet")
        led.register("quiet", "x", {"CXL": 8 * G})
        return ns.pool.TierBudgetArbiter(led, "LDRAM",
                                         predictive=True).rebalance(1)
    got = check(scenario)
    assert got["demands"][0]["source"] == "measured"


# ===================================================================== #
# plan prefetch and the budget-keyed plan cache                         #
# ===================================================================== #
def _burst_replanner(ns, move_scheduler=None):
    G = ns.core.GiB
    tiers = _tiers(ns)
    led = ns.pool.ResidencyLedger(tiers, capacity_bytes={"LDRAM": 64 * G})
    tr = ns.telemetry.AccessTrace()
    led.register_tenant("serve", trace=tr)
    led.register("serve", "kv", {"CXL": 48 * G}, origin="plan")
    led.register("serve", "w", {"CXL": 14 * G}, origin="plan")
    seed = ns.core.PlacementPlan({"kv": [("CXL", 1.0)],
                                  "w": [("CXL", 1.0)]}, "first_touch", {})
    rp = ns.telemetry.AdaptiveReplanner(
        tr, tiers, "LDRAM",
        policy=ns.core.ObjectLevelInterleave("LDRAM", ["CXL"],
                                             bandwidth_weighted=True),
        cfg=ns.telemetry.ReplanConfig(replan_every=1, window_epochs=1,
                                      amortize_steps=32),
        executor=ns.core.MigrationExecutor(tiers), initial_plan=seed,
        default_tier="CXL", ledger=led, tenant="serve",
        move_scheduler=move_scheduler)
    return rp, tr, led


def test_prefetch_and_plan_cache_match_reference():
    def scenario(ns):
        G = ns.core.GiB
        rp, tr, led = _burst_replanner(ns)
        nbytes = {"kv": 48 * G, "w": 14 * G}
        out = []
        _emit(ns, tr, True)
        out.append(rp.maybe_replan(1, nbytes, phase="burst"))
        out.append(led.bytes_on("LDRAM", "serve"))
        _emit(ns, tr, False)
        out.append(rp.maybe_replan(2, nbytes, phase="lull"))
        rp.ledger.set_residency("serve", "kv", {"CXL": 48 * G})
        rp.ledger.set_residency("serve", "w", {"CXL": 14 * G})
        rp.plan = ns.core.PlacementPlan(
            {"kv": [("CXL", 1.0)], "w": [("CXL", 1.0)]}, "lull", {})
        out.append(rp.prefetch_phase(3, nbytes, "burst"))
        out += [led.bytes_on("LDRAM", "serve"), rp.prefetches,
                rp.prefetch_phase(4, nbytes, "never-seen"),
                rp.prefetch_phase(4, nbytes, "burst")]
        lull = ns.core.PlacementPlan({"kv": [("CXL", 1.0)],
                                      "w": [("CXL", 1.0)]}, "lull", {})
        rp._phase_plans["lull"] = (lull, True, rp._budget_key())
        out.append(rp.prefetch_phase(4, nbytes, "lull"))
        led.set_budget("serve", "LDRAM", 32 * G)
        out.append(rp._cached_plan("burst"))
        _emit(ns, tr, True)
        out.append(rp.maybe_replan(5, nbytes, phase="burst"))
        out.append(rp._cached_plan("burst")[1])
        led.set_budget("serve", "LDRAM", 48 * G)
        out.append(rp._cached_plan("burst"))
        out += [rp.summary(), rp.decisions]
        return out
    got = check(scenario)
    assert got[3]["reason"] == "prefetch" and got[5] == 1


# ===================================================================== #
# ledger-driven preemption                                              #
# ===================================================================== #
def test_budget_preemption_matches_reference():
    def scenario(ns):
        S = ns.serving
        pool = S.PagedKVPool(12, 4, fast_block_budget=6)
        sched = S.ContinuousBatchingScheduler(pool)
        reqs = []
        for rid, prio in ((0, 2.0), (1, 0.0), (2, 1.0)):
            r = S.Request(rid=rid, prompt=np.zeros(6, np.int32),
                          max_new_tokens=4, priority=prio)
            sched.submit(r)
            reqs.append(r)
        admitted = sched.admit() + sched.admit()
        for r in reqs:
            pool.alloc(r.rid, 2, kind=S.FAST_KIND)
        out = [[r.rid for r in admitted], sched.preempt_over_budget()]
        pool.ledger.set_budget(pool.tenant, S.FAST_KIND,
                               2 * pool.block_nbytes())
        victims = sched.preempt_over_budget()
        out += [[v.rid for v in victims], [r.rid for r in sched.running],
                sched.budget_preemptions, pool.fast_used(),
                [r.rid for r in sched.waiting],
                [r.preemptions for r in victims]]
        # nothing fast left to free: the pass stops
        pool2 = S.PagedKVPool(8, 4, fast_block_budget=4)
        s2 = S.ContinuousBatchingScheduler(pool2)
        s2.submit(S.Request(rid=0, prompt=np.zeros(6, np.int32),
                            max_new_tokens=4))
        s2.admit()
        pool2.alloc(0, 2)
        pool2.ledger.set_budget(pool2.tenant, S.FAST_KIND, 0)
        out += [s2.preempt_over_budget(), [r.rid for r in s2.running]]
        return out
    got = check(scenario)
    assert got[2] == [1, 2]


# ===================================================================== #
# MoveScheduler                                                         #
# ===================================================================== #
def _far_socket(ns):
    tb = ns.topology.two_socket_system("A", cxl_socket=1)
    return {k: v for k, v in tb.tiers.items() if k != "NVMe"}, tb.graph


def _move(ns, obj, src, dst, gib):
    return ns.core_migration.BlockMove(obj, src, dst,
                                       int(gib * ns.core.GiB))


def _delta(ns, *moves):
    return ns.core_migration.PlacementDelta([_move(ns, *m) for m in moves])


def _round(r):
    return (r, r.makespan_s, r.independent_s, r.saved_s,
            {t: r.tenant_finish_s(t) for t in sorted({m.tenant
                                                       for m in r.moves})})


ROUNDS = {
    "shared-link": [("lo", None, [("opt", "CXL", "LDRAM", 8)]),
                    ("hi", None, [("kv", "CXL", "LDRAM", 8)])],
    "partial-overlap": [("hi", 2.0, [("kv", "CXL", "LDRAM", 16)]),
                        ("lo", 1.0, [("opt", "RDRAM", "LDRAM", 16)])],
    "coalesce": [("t", None, [("kv", "CXL", "LDRAM", 6),
                              ("kv", "CXL", "LDRAM", 2),
                              ("kv", "LDRAM", "CXL", 3)])],
    "demotions-first": [("a", None, [("x", "CXL", "LDRAM", 1)]),
                        ("b", None, [("y", "LDRAM", "CXL", 1)])],
    "mixed": [("a", 1.0, [("p", "CXL", "LDRAM", 3), ("q", "RDRAM",
                                                     "LDRAM", 0.5)]),
              ("b", 3.0, [("r", "LDRAM", "RDRAM", 2)]),
              ("hi", None, [("s", "CXL", "RDRAM", 1.25)])],
}


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_move_rounds_match_reference(case):
    def scenario(ns):
        tiers, graph = _far_socket(ns)
        led = ns.pool.ResidencyLedger(tiers)
        led.register_tenant("hi", weight=2.0)
        for t in ("lo", "t", "a", "b"):
            led.register_tenant(t, weight=1.0)
        ms = ns.pool.MoveScheduler(
            ns.core.MigrationExecutor(tiers, topology=graph), ledger=led)
        for tenant, prio, moves in ROUNDS[case]:
            ms.submit(tenant, _delta(ns, *moves), priority=prio)
        r = ms.flush(1)
        return _round(r), ms.summary(), ms.has_pending
    got = check(scenario)
    if case == "shared-link":
        assert [m["tenant"] for m in got[0][0]["moves"]] == ["hi", "lo"]


def test_movesched_preemption_and_chunking_match_reference():
    def scenario(ns):
        G = ns.core.GiB
        tiers, graph = _far_socket(ns)
        out = []
        # an urgent delta lands from inside a move_fn
        ms = ns.pool.MoveScheduler(
            ns.core.MigrationExecutor(tiers, topology=graph))
        order = []

        def hi_fn(obj, src, dst, nb):
            order.append(("hi", obj, nb))
            return nb

        def lo_fn(obj, src, dst, nb):
            order.append(("lo", obj, nb))
            if obj == "lo.b0":
                ms.submit("hi", _delta(ns, ("hi.kv", "CXL", "LDRAM", 1)),
                          move_fn=hi_fn, priority=5.0)
            return nb

        ms.submit("lo", _delta(ns, *[(f"lo.b{i}", "CXL", "LDRAM", 1)
                                     for i in range(3)]),
                  move_fn=lo_fn, priority=1.0)
        out += [_round(ms.flush(1)), list(order), ms.summary(),
                ms.has_pending]
        # an equal-priority arrival waits for the next flush
        ms2 = ns.pool.MoveScheduler(
            ns.core.MigrationExecutor(tiers, topology=graph))
        order2 = []

        def peer_fn(obj, src, dst, nb):
            order2.append(obj)
            if obj == "a.b0":
                ms2.submit("peer", _delta(ns, ("peer.x", "CXL", "LDRAM",
                                               1)), priority=1.0)
            return nb

        ms2.submit("a", _delta(ns, *[(f"a.b{i}", "CXL", "LDRAM", 1)
                                     for i in range(2)]),
                   move_fn=peer_fn, priority=1.0)
        out += [_round(ms2.flush(1)), ms2.has_pending, _round(ms2.flush(2)),
                list(order2)]
        # a chunked copy yields inside one block
        ms3 = ns.pool.MoveScheduler(
            ns.core.MigrationExecutor(tiers, topology=graph))
        order3, realized = [], []
        stats = ns.core_migration.MigrationStats()

        def hi3(obj, src, dst, nb):
            order3.append(("hi", nb))
            return nb

        def lo3(obj, src, dst, nb):
            order3.append(("lo", nb))
            if len(order3) == 1:
                ms3.submit("hi", _delta(ns, ("hi.kv", "CXL", "LDRAM", 1)),
                           move_fn=hi3, priority=9.0)
            return nb

        ms3.submit("lo", _delta(ns, ("lo.big", "CXL", "LDRAM", 4)),
                   move_fn=lo3, priority=1.0, chunk_bytes=2 * G,
                   on_done=lambda moves: realized.extend(moves),
                   stats=stats)
        out += [_round(ms3.flush(1)), order3, realized, stats,
                ms3.preemptions]
        return out
    got = check(scenario)
    assert [t for t, *_ in got[1]] == ["lo", "hi", "lo", "lo"]


def test_movesched_deferred_replanner_callbacks_match_reference():
    def scenario(ns):
        G = ns.core.GiB
        tiers = _tiers(ns)
        ms = ns.pool.MoveScheduler(ns.core.MigrationExecutor(tiers))
        rp, tr, led = _burst_replanner(ns, move_scheduler=ms)
        ms.ledger = led
        nbytes = {"kv": 48 * G, "w": 14 * G}
        _emit(ns, tr, True)
        d = rp.maybe_replan(1, nbytes, phase="burst")
        out = [dataclasses.replace(d), led.bytes_on("LDRAM", "serve"),
               rp.maybe_replan(1, nbytes, phase="burst"),
               rp.prefetch_phase(1, nbytes, "burst"), ms.pending_moves]
        r = ms.flush(1)
        out += [d, led.bytes_on("LDRAM", "serve"), r.moved_bytes("serve"),
                rp.plan.shares, _round(r)]
        return out
    got = check(scenario)
    assert got[0]["deferred"] and got[5]["moved_bytes"] > 0


# ===================================================================== #
# the predictive engine, against the reference engine                   #
# ===================================================================== #
@pytest.fixture(scope="module")
def tiny():
    return tiny_model("llama3-8b", 2, (12, 7, 9, 20, 5))


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_predictive_engine_matches_reference(tiny, fused, monkeypatch):
    """The arbiter rebalances the grant each replan epoch, replans key
    their plans by phase signature and defer to move-scheduler rounds;
    tokens, telemetry (arbiter and move-scheduler keys included), the
    replan decisions and the trace, with its replan chains, equal the
    reference's."""
    import repro_torch.serving.engine as engine_mod
    from repro_torch.obs import replan_chains
    monkeypatch.setattr(engine_mod, "kind_bases", tpu_bases)
    sv = dict(block_tokens=8, max_batch=3, max_context=40,
              policy="tiering08", replan_every=2, adaptive=True,
              predictive=True, fused_gather=fused)
    ref, ref_rep, eng, rep = serve_both(tiny, sv, 10)
    assert_engines_match(ref, ref_rep, eng, rep)
    t = rep.telemetry
    assert t["arbiter_rebalances"] > 0 and t["movesched.rounds"] > 0
    chains = replan_chains(eng.tracer.events)
    assert any(c["grants"] and c["decisions"] for c in chains.values())


# ===================================================================== #
# the ledger's per-tier sums (the port keeps them; the reference sums)  #
# ===================================================================== #
def test_ledger_bytes_on_after_every_kind_of_write_matches_reference():
    """Every write path of the ledger, then ``bytes_on`` for each tier
    by tenant, by pattern and over all tenants, and the headroom and
    budget views read from it."""
    def scenario(ns):
        led = ns.pool.ResidencyLedger(capacity_bytes={"A": 1000})
        for t in ("r0/x", "r0/y", "r1/x"):
            led.register_tenant(t)
        out = []

        def view():
            out.append({
                tier: [led.bytes_on(tier), led.bytes_on(tier, "r0/*"),
                       led.bytes_on(tier, "*/x")]
                + [led.bytes_on(tier, t) for t in ("r0/x", "r0/y", "r1/x")]
                for tier in ("A", "B", "C")})
            out.append([led.headroom(t, "A") for t in ("r0/x", "r1/x")])
        led.register("r0/x", "o1", {"A": 100, "B": 50, "C": 0})
        led.register("r1/x", "o1", {"B": 70})
        led.record_alloc("r0/y", "o2", "A", 40)
        led.record_alloc("r0/y", "o2", "C", 10)
        led.record_alloc("r0/y", "o2", "C", 0)
        view()
        led.record_free("r0/y", "o2", "C", 4)
        led.record_free("r0/y", "o2", "A", 400)
        led.record_free("r0/x", "nope", "A", 4)
        view()
        led.record_move("r0/x", "o1", "B", "A", 30)
        led.record_move("r0/x", "o1", "A", "C", 1000)
        led.record_move("r0/x", "o1", "A", "A", 5)
        view()
        led.set_residency("r1/x", "o1", {"A": 11, "C": 3})
        led.set_residency("r1/x", "o9", {"B": 8})
        view()
        led.resize("r0/x", "o1", 500, grow_tier="B")
        led.resize("r1/x", "o1", 7)
        led.resize("r1/x", "o9", 20)
        view()
        led.set_budget("r0/x", "A", 5)
        out.append([led.over_budget("r0/x", "A"),
                    led.over_budget_tenants("A")])
        out.append([led.retire("r0/y", "o2"), led.retire("r0/y", "o2")])
        led.record_free("r1/x", "o9", "B", 20)
        view()
        out.append([led.move("r0/x", "o1", "C", "A", 50),
                    led.aggregate("*/*"), led.summary()])
        view()
        return out
    check(scenario)
