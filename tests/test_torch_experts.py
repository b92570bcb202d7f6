"""The port's MoE expert residency (``serving/expert_pool.py``) against
the JAX reference's, on the inputs of ``tests/test_expert_pool.py``:
heat accounting, LRU and predictive residency after N epochs (which
expert sits on which kind), budgets under churn, prefetch counters,
moves through the move scheduler, class-tagged gather flows, and the
config helpers.  Each scenario runs once on each package; integers and
decisions must be equal, floats within 1e-9 relative.  Also: the
smoke MoE engine with ``expert_policy`` ``lru`` and ``predictive`` on
both decode paths against the reference engine (the fused path feeds
the routed ids; the staged path routes inside ``moe_fwd`` and feeds
none, as in the reference)."""
import pytest

pytest.importorskip("torch")

from _torch_parity import (assert_engines_match, assert_same,  # noqa: E402
                           package, plain, raised, serve_both, tiny_model,
                           tpu_bases)

MODS = ("core", "core.migration", "pool", "serving", "serving.expert_pool",
        "topology", "configs")
REF, PORT = package("repro", *MODS), package("repro_torch", *MODS)
NB = 1 << 20                           # one expert's weight bytes


def check(scenario, *args):
    got, want = scenario(PORT, *args), scenario(REF, *args)
    assert_same(got, want)
    return plain(got)


def _pool(ns, policy="lru", budget=4, n_experts=8, n_layers=2, **kw):
    return ns.serving_expert_pool.ExpertPool(
        n_layers=n_layers, n_experts=n_experts, expert_nbytes=NB,
        fast_expert_budget=budget, policy=policy, **kw)


def _state(p):
    """Everything an expert pool decides: residency, heat, counters."""
    return {"kinds": p.kinds, "last_step": p.last_step,
            "touch": p.touch_count, "counters": p.counters,
            "fast": p.fast_residents(), "hit": p.fast_hit_ratio(),
            "prefetch_hit": p.prefetch_hit_ratio(), "summary": p.summary(),
            "ledger": p.ledger.bytes_on(PORT.serving.FAST_KIND, p.tenant),
            "trace_events": p.trace.total_events}


def test_expert_pool_validation_matches_reference():
    def scenario(ns):
        E = ns.serving_expert_pool.ExpertPool
        return [raised(_pool, ns, policy="clock"),
                raised(E, 0, 8, NB, fast_expert_budget=2),
                raised(E, 2, 8, 0, fast_expert_budget=2)]
    got = check(scenario)
    assert all(got)


def test_heat_accounting_and_lru_match_reference():
    def scenario(ns):
        p = _pool(ns, budget=3)
        out = []
        p.record_routing(0, [1, 1, 3], step=0)
        p.record_routing(1, [5], step=0)
        out.append(_state(p))
        p.record_routing(0, [0, 2, 4], step=0)
        p.step(0)
        out.append(_state(p))
        p.record_routing(0, [6, 7], step=1)
        p.step(1)
        out.append(_state(p))
        p.record_routing(0, [6, 7], step=2)
        out.append(_state(p))
        return out
    got = check(scenario)
    assert got[1]["fast"] == 3 and got[3]["counters"]["fast_hits"] == 2


@pytest.mark.parametrize("policy", ["lru", "predictive"])
def test_residency_under_churn_matches_reference(policy):
    def scenario(ns):
        p = _pool(ns, policy=policy, budget=2, n_experts=16, n_layers=1)
        states = []
        for s in range(12):
            p.record_routing(0, [(s * 3 + i) % 16 for i in range(4)],
                             step=s)
            p.step(s)
            states.append((p.fast_residents(), dict(p.kinds)))
        return states, _state(p)
    got = check(scenario)
    assert all(n <= 2 for n, _ in got[0])


@pytest.mark.parametrize("policy", ["lru", "predictive"])
def test_recurring_phases_residency_matches_reference(policy):
    """Alternating routing phases over several cycles: residency after
    every epoch, prefetch promotes and hits, and the hit ratios."""
    def scenario(ns):
        p = _pool(ns, policy=policy, budget=4, n_experts=16, n_layers=1)
        phases = ([0, 1, 2, 3], [8, 9, 10, 11])
        epoch, states = 0, []
        for _ in range(6):
            for phase in phases:
                for _ in range(3):
                    for s in range(4):
                        p.record_routing(0, phase, step=epoch)
                    p.step(epoch)
                    states.append((epoch, dict(p.kinds),
                                   p.counters.prefetch_promotes))
                    epoch += 1
        return states, _state(p)
    got = check(scenario)
    if policy == "predictive":
        assert got[1]["counters"]["prefetch_hits"] > 0
    else:
        assert got[1]["prefetch_hit"] is None


def _kind_tiers(ns):
    """The pool kinds' tiers from the paper's system A (the same
    descriptors on both sides)."""
    t = ns.core.paper_system("A")
    return ns.serving.kind_tiers(ns.serving.PagedKVPool(4, 4),
                                 fast_base=t["LDRAM"], slow_base=t["CXL"])


@pytest.mark.parametrize("priority", [None, 0.5])
def test_moves_through_movesched_match_reference(priority):
    def scenario(ns):
        ms = ns.pool.MoveScheduler(
            ns.core.MigrationExecutor(_kind_tiers(ns)))
        p = _pool(ns, budget=2, movesched=ms, move_priority=priority)
        p.record_routing(0, [0, 1], step=0)
        p.step(0)
        p.record_routing(1, [3, 4, 3], step=1)
        p.step(1)
        return ([(r, r.moved_bytes("experts"), r.makespan_s)
                 for r in ms.rounds], _state(p), ms.summary())
    got = check(scenario)
    assert {m["move"]["obj"] for m in got[0][0][0]["moves"]} == \
        {"expert.L0.E0", "expert.L0.E1"}


def test_gather_flows_match_reference():
    def scenario(ns):
        g = ns.topology.TopologyGraph("pcie", origin="hbm")
        g.add_node("hbm", "chip", tier=ns.serving.FAST_KIND)
        g.add_node("host", "host", tier="pinned_host")
        g.add_link("hbm", "host", 600.0, 32.0, "pcie")
        p = _pool(ns, policy="predictive", budget=2, n_experts=8,
                  n_layers=1)
        out = [p.gather_flows(None)]
        p.record_routing(0, [0, 1, 2], step=0)
        out.append(p.gather_flows(g))
        p.step(0)
        out.append(p.gather_flows(g, period_s=0.1))
        p.record_routing(0, [0, 1], step=1)
        p.step(1)
        out.append(p.gather_flows(g))
        for e in range(2, 14):
            p.record_routing(0, [e % 4, (e + 2) % 8], step=e)
            p.step(e)
            out.append(p.gather_flows(g, cls="write"))
        return out
    got = check(scenario)
    assert got[2][0]["cls"] == "read" and got[2][0]["tenant"] == "experts"


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
                                  "llama3-8b"])
def test_config_helpers_match_reference(arch):
    def scenario(ns):
        out = []
        for cfg in (ns.configs.get_smoke_config(arch),
                    ns.configs.get_config(arch)):
            n = ns.serving_expert_pool.moe_layers_from_config(cfg)
            out.append((n, ns.serving_expert_pool.expert_nbytes_from_config(
                cfg) if n else None))
        return out
    got = check(scenario)
    if arch == "qwen3-moe-30b-a3b":
        assert got[1] == [48, 3 * 2048 * 768 * 2]


# ===================================================================== #
# the MoE engine with expert residency, against the reference engine    #
# ===================================================================== #
@pytest.fixture(scope="module")
def tiny_moe():
    # the smoke MoE's logits and router are flat: these prompts keep
    # every decode token's top-2 logit gap at 0.0059 or more and every
    # fused decode's router top-8 minus top-9 probability at 3.4e-3 or
    # more (the port's route_margins), so that tokens and routed ids
    # compare the function, not rounding at a near tie
    return tiny_model("qwen3-moe-30b-a3b", 8, (10, 6, 13))


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("policy", ["lru", "predictive"])
def test_expert_engine_matches_reference(tiny_moe, policy, fused,
                                         monkeypatch):
    """Tokens, telemetry (the expert and move-scheduler keys included),
    the trace and the residency of every (layer, expert) after the run
    equal the reference's.  ``predictive`` runs under the predictive
    control plane, whose move scheduler carries the expert moves."""
    import repro_torch.serving.engine as engine_mod
    monkeypatch.setattr(engine_mod, "kind_bases", tpu_bases)
    sv = dict(block_tokens=8, max_batch=3, max_context=32,
              policy="tiering08", fused_gather=fused, expert_policy=policy,
              expert_fast_fraction=0.25)
    if policy == "predictive":
        sv.update(adaptive=True, predictive=True, replan_every=2)
    ref, ref_rep, eng, rep = serve_both(tiny_moe, sv, 10)
    assert_engines_match(ref, ref_rep, eng, rep)
    assert_same(_state(eng.expert_pool), _state(ref.expert_pool))
    t = rep.telemetry
    cfg = eng.cfg
    n_moe = sum(s.moe for s in cfg.pattern) * cfg.n_units
    if fused:
        decoded = sum(len(r.out_tokens) - 1 for r in eng.sched.finished)
        assert t["expert.accesses"] == decoded * n_moe * cfg.top_k
        assert t["expert.promoted"] > 0
    else:
        assert t["expert.accesses"] == 0
    assert t["expert.fast_residents"] <= eng.expert_pool.fast_expert_budget
    if policy == "predictive":
        assert t["movesched.rounds"] > 0
