"""The port's interference-class QoS plane against the JAX reference's,
on the inputs of ``tests/test_qos.py``: blame reports (excursions,
antagonists, pressures, scores), violation forecasts and their audit
joins, the SLO-hook -> blame -> trace chain, calibrated interference,
and the arbiter's blame debit.  Each scenario runs once on each
package; integers and decisions must be equal, floats within 1e-9
relative.  Also: the engine with ``qos=True`` and an impossible decode
SLO on both decode paths, against the reference engine."""
import pytest

pytest.importorskip("torch")

from _torch_parity import (assert_engines_match, assert_same,  # noqa: E402
                           package, plain, serve_both, tiny_model)

MODS = ("core", "obs", "pool", "topology")
REF, PORT = package("repro", *MODS), package("repro_torch", *MODS)


def check(scenario, *args):
    got, want = scenario(PORT, *args), scenario(REF, *args)
    assert_same(got, want)
    return plain(got)


def _shared_link_graph(ns, bw=10.0, kind="upi"):
    """Two nodes, one contended link: FAST at a, SLOW at b."""
    g = ns.topology.TopologyGraph("t", origin="a")
    g.add_node("a", "socket", tier="FAST")
    g.add_node("b", "socket", tier="SLOW")
    g.add_link("a", "b", 100.0, bw, kind)
    return g


def _victim(ns, offered=4.0):
    return ns.topology.Flow("b", "a", offered, cls="read", tenant="victim")


def _neighbor(ns, offered=5.0, cls="write", tenant="noisy"):
    return ns.topology.Flow("b", "a", offered, cls=cls, tenant=tenant)


def _excursion(ex):
    return None if ex is None else (
        ex.victim, ex.metric, ex.observed_s, ex.threshold_s, ex.link,
        ex.link_kind, ex.rho, ex.antagonist, ex.pressure, ex.loads)


# ===================================================================== #
# BlameLedger                                                           #
# ===================================================================== #
@pytest.mark.parametrize("kind", ["upi", "cxl", "local"])
def test_blame_report_matches_reference(kind):
    def scenario(ns):
        g = _shared_link_graph(ns, bw=10.0, kind=kind)
        reg = ns.obs.MetricsRegistry()
        blame = ns.obs.BlameLedger(g, registry=reg)
        blame.publish_flows("victim", [_victim(ns, 4.0)], now=1.0)
        blame.publish_flows("noisy", [_neighbor(ns, 5.0)], now=1.0)
        blame.publish_flows("quiet", [_neighbor(ns, 1.0, cls="read",
                                                tenant="quiet")], now=1.0)
        ex = blame.on_violation("victim", "decode_latency.p99",
                                observed_s=0.05, threshold_s=0.01, now=2.0)
        ex2 = blame.on_violation("quiet", "decode_latency.p99",
                                 observed_s=0.03, threshold_s=0.01, now=3.0)
        return {"ex": _excursion(ex), "ex2": _excursion(ex2),
                "scores": {t: blame.noisy_neighbor_score(t)
                           for t in ("noisy", "victim", "quiet")},
                "report": blame.blame_report(), "summary": blame.summary(),
                "metrics": reg.snapshot()}
    got = check(scenario)
    assert got["report"]["top_antagonist"] == "noisy"


def test_blame_spoofing_missing_victim_and_ring_match_reference():
    def scenario(ns):
        g = _shared_link_graph(ns)
        blame = ns.obs.BlameLedger(g, max_excursions=4)
        blame.publish_flows("noisy", [ns.topology.Flow(
            "b", "a", 5.0, cls="write", tenant="innocent")])
        blame.publish_flows("victim", [_victim(ns)])
        out = [_excursion(blame.on_violation("victim", "m", 1.0, 0.5)),
               _excursion(blame.on_violation("ghost", "m", 1.0, 0.5))]
        for i in range(9):
            blame.on_violation("victim", "m", 1.0, 0.5, now=float(i))
        out.append([_excursion(e) for e in blame.excursions])
        out.append((blame.total_excursions, blame.blame_report()))
        return out
    got = check(scenario)
    assert got[0][7] == "noisy" and got[1] is None


# ===================================================================== #
# ViolationPredictor                                                    #
# ===================================================================== #
def test_predictor_forecasts_match_reference():
    def scenario(ns):
        g = _shared_link_graph(ns, bw=10.0)
        blame = ns.obs.BlameLedger(g)
        pred = ns.obs.ViolationPredictor(g, blame=blame)
        pred.set_target("victim", 0.02)
        pred.set_baseline("victim", 0.01)
        out = {"lone": pred.predict_p99("victim", [_victim(ns, 4.0)]),
               "none": pred.predict_p99("victim", [])}
        for name, flows in (
                ("alone", [_victim(ns, 4.0)]),
                ("writer", [_victim(ns, 4.0), _neighbor(ns, 5.0)]),
                ("reader", [_victim(ns, 4.0),
                            _neighbor(ns, 5.0, cls="read")]),
                ("prefetch", [_victim(ns, 4.0),
                              _neighbor(ns, 3.0, cls="prefetch")])):
            out[name] = (pred.violations(flows), pred.admission_ok(flows))
        blame.publish_flows("victim", [_victim(ns, 4.0)])
        blame.publish_flows("noisy", [_neighbor(ns, 5.0)])
        out["book"] = (pred.admission_ok([]),
                       pred.admission_ok([], exclude="noisy"),
                       pred.admission_ok([_neighbor(ns, 5.0)],
                                         exclude="noisy"),
                       pred.violations([_neighbor(ns, 2.0)],
                                       exclude="noisy"))
        for v in (0.02, 0.013, 0.05, 0.0):
            pred.observe_p99("victim", v)
        out["baselines"] = dict(pred.baselines)
        return out
    got = check(scenario)
    assert got["writer"][1] is False and got["alone"][1] is True


def test_predictor_audit_joins_match_reference():
    def scenario(ns):
        g = _shared_link_graph(ns, bw=10.0)
        audit = ns.obs.PredictionLedger()
        pred = ns.obs.ViolationPredictor(g, audit=audit)
        out = [audit.model_tolerance[ns.obs.QOS_VIOLATION_MODEL]]
        pred.set_baseline("victim", 0.01)
        p = pred.file_prediction("e0", "victim",
                                 extra_flows=[_victim(ns, 4.0)], epoch=0)
        rec = pred.realize("e0", "victim", p * 1.2)
        out += [p, rec, audit.accuracy(ns.obs.QOS_VIOLATION_MODEL)]
        pred.file_prediction("e1", "victim", extra_flows=[_victim(ns, 4.0)],
                             epoch=1)
        pred.realize("e1", "victim", p * 2.0)
        out += [audit.accuracy(ns.obs.QOS_VIOLATION_MODEL), audit.summary(),
                audit.report()]
        return out
    got = check(scenario)
    assert got[3] == 1.0 and got[4] == 0.5


def test_slo_hook_blame_and_trace_chain_match_reference():
    def scenario(ns):
        g = _shared_link_graph(ns, bw=10.0)
        tracer = ns.obs.TraceRecorder(clock=lambda: 0.0)
        blame = ns.obs.BlameLedger(g, tracer=tracer)
        slo = ns.obs.SLOMonitor(
            [ns.obs.SLOTarget("decode_latency", 0.99, 0.01)],
            tracer=tracer, min_samples=4)
        slo.add_violation_hook(
            lambda t, v, now: blame.on_violation("victim", t.key, v,
                                                 t.threshold_s, now=now))
        blame.publish_flows("victim", [_victim(ns, 4.0)])
        blame.publish_flows("noisy", [_neighbor(ns, 5.0)])
        g.contended_flows([_victim(ns, 4.0), _neighbor(ns, 5.0)],
                          tracer=tracer)
        for i in range(8):
            slo.observe("decode_latency", 0.05, now=float(i))
            slo.check(now=float(i))
        chains = ns.obs.qos_chains(tracer.events)
        return ([(e.name, e.args) for e in tracer.events],
                [{k: (v.args if hasattr(v, "args") else
                      [x.args for x in v] if isinstance(v, list) else v)
                  for k, v in c.items()} for c in chains],
                blame.total_excursions, slo.summary())
    got = check(scenario)
    assert got[1] and got[1][0]["blame"]["antagonist"] == "noisy"


# ===================================================================== #
# calibrated interference                                               #
# ===================================================================== #
def test_calibrated_interference_matches_reference():
    def scenario(ns):
        g = _shared_link_graph(ns, bw=10.0)
        cal = ns.obs.CostModelCalibrator(ns.core.paper_system("A"), graph=g)
        out = {"untouched": cal.calibrated_interference() is g.interference}
        for r in (1.5, 1.5, 1.4, 1.6, 1.5, 0.0, float("inf"), 1.5):
            cal.observe_interference("upi", "read", "write", r)
        cal.observe_interference("cxl", "read", "prefetch", 0.7)
        m = cal.calibrated_interference()
        cls = ns.topology.INTERFERENCE_CLASSES
        out["weights"] = {f"{k}/{v}/{a}": m.weight(k, v, a)
                          for k in ("upi", "cxl") for v in cls for a in cls}
        flows = [_victim(ns, 4.0), _neighbor(ns, 5.0)]
        out["before"] = g.contended_flows(flows)
        out["after"] = cal.calibrated_graph().contended_flows(flows)
        out["summary"] = cal.summary()
        return out
    got = check(scenario)
    assert got["untouched"] is True
    assert got["after"][0]["achieved_GBps"] < \
        got["before"][0]["achieved_GBps"]


# ===================================================================== #
# arbiter: blame debits fast-tier grants                                #
# ===================================================================== #
class _StubBlame:
    def __init__(self, scores):
        self.scores = scores

    def noisy_neighbor_score(self, tenant):
        return self.scores.get(tenant, 0.0)


@pytest.mark.parametrize("scores", [{"noisy": 1.0}, {}, {"noisy": 0.3,
                                                         "quiet": 0.1}])
@pytest.mark.parametrize("objective", ["fair_share", "throughput",
                                       "priority"])
def test_arbiter_blame_debit_matches_reference(scores, objective):
    def scenario(ns):
        led = ns.pool.ResidencyLedger()
        for t in ("noisy", "quiet", "third"):
            led.register_tenant(t)
        arb = ns.pool.TierBudgetArbiter(
            led, "LDRAM", capacity_bytes=100, blame=_StubBlame(scores),
            blame_debit=0.5, objective=objective)
        demands = [ns.pool.TenantDemand("noisy", 100, 80, 1.0),
                   ns.pool.TenantDemand("quiet", 100, 80, 2.0),
                   ns.pool.TenantDemand("third", 30, 10, 0.5)]
        return arb.split(demands), arb.blame_debited_bytes
    got = check(scenario)
    if objective == "fair_share" and scores == {"noisy": 1.0}:
        assert got[1] > 0


# ===================================================================== #
# the engine with qos=True, against the reference engine                #
# ===================================================================== #
@pytest.fixture(scope="module")
def tiny():
    return tiny_model("llama3-8b", 2, (12, 7, 9, 20, 5))


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_qos_engine_matches_reference(tiny, fused):
    """An impossible decode SLO fires violations while requests run; the
    blame hook joins each to a link, predictive admission defers and
    preemption sheds a request, which is recomputed; tokens, telemetry
    (the scheduler's real qos counters), the SLO report with its blame
    report and the trace equal the reference's."""
    sv = dict(block_tokens=8, max_batch=2, max_context=40, policy="static",
              topology="far-socket", qos=True, fast_block_budget=1,
              slo_p95_decode_s=1e-9, fused_gather=fused)
    ref, ref_rep, eng, rep = serve_both(tiny, sv, 10)
    assert_engines_match(ref, ref_rep, eng, rep)
    assert rep.slo["targets"][0]["violations"] > 0
    assert rep.slo["blame"]["total_excursions"] > 0
    t = rep.telemetry
    assert t["qos_deferrals"] > 0 and t["slo_preemptions"] > 0
