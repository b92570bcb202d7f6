"""The port's observability plane against the JAX reference's
(``tests/test_{obs,audit}.py`` inputs): the trace recorder and its
exports, the metrics registry and its Prometheus text, the SLO and
lag-ratio monitors, the prediction-audit ledger, and the serving
metrics that publish into them — each scenario run once on each package
under a fake clock, with equal events, files, texts and reports.  Also
the port's transfer probes (``obs.calibrate``), which time copies with
the engine's own clock and so have no reference result to equal."""
import dataclasses
import importlib
import json
import types

import numpy as np
import pytest

pytest.importorskip("torch")


def _pkg(root):
    ns = types.SimpleNamespace(root=root)
    for m in ("obs", "obs.trace", "serving.metrics"):
        setattr(ns, m.replace(".", "_"),
                importlib.import_module(f"{root}.{m}"))
    return ns


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def _clock(times):
    it = iter(times)
    return lambda: next(it)


def _events(tr):
    return [e.to_dict() for e in tr.events]


def _keyed(violations):
    """SLO check results as (target key, value): each package has its
    own SLOTarget class."""
    return [(t.key, v) for t, v in violations]


# ===================================================================== #
# trace                                                                 #
# ===================================================================== #
def _record(ns, tmp_path):
    obs = ns.obs
    tr = obs.TraceRecorder(clock=_clock(np.arange(0.0, 100.0, 0.5)),
                           max_events=12)
    tr.event("phase.update", cat="phase", epoch=1, label="streaming",
             shifts=0)
    tr.event("arbiter.grant", epoch=1, tenant="t", n=np.int64(3),
             frac=np.float32(0.5), arr=(1, 2), obj=object.__new__(
                 type("Opaque", (), {"__repr__": lambda s: "<opaque>"})))
    tr.event("replan.decision", cat="replan", tid="t", epoch=1,
             applied=True, reason="win", moved_bytes=4096)
    tr.complete("movesched.round", ts=1.0, dur=-2.0, epoch=1, moves=2)
    tr.complete("movesched.move", ts=1.5, dur=0.25, epoch=1, obj="seq0")
    tr.event("migration.move", cat="migration", obj="seq0", src="a",
             dst="b", nbytes=10)
    tr.counter("occupancy", 7, ts=2.0)
    with tr.span("replan.span", epoch=2, tenant="t") as args:
        args["result"] = "ok"
    tr.event("link.saturated", link="upi")
    tr.event("slo.violation", key="decode.p99")
    tr.event("qos.blame", tenant="t")
    tr.event("slo.violation", key="ttft.p95")
    for i in range(4):                       # ring eviction
        tr.event("replan.decision", epoch=3 + i, reason="no_win")
    jl = tmp_path / f"{ns.root}.jsonl"
    ch = tmp_path / f"{ns.root}.json"
    n = (tr.to_jsonl(str(jl)), tr.to_chrome(str(ch)))
    chains = ns.obs_trace.replan_chains(tr.events)
    qos = ns.obs_trace.qos_chains(tr.events)
    return (n, tr.dropped, len(tr), _events(tr), jl.read_text(),
            json.loads(ch.read_text()),
            [e.to_dict() for e in ns.obs.TraceRecorder.read_jsonl(str(jl))],
            {k: {s: [e.to_dict() for e in v] for s, v in c.items()}
             for k, c in chains.items()},
            [{k: (v.to_dict() if hasattr(v, "to_dict") else
                  [e.to_dict() for e in v] if isinstance(v, list) else v)
              for k, v in c.items()} for c in qos],
            [e.name for e in tr.filter(cat="replan")],
            [e.name for e in tr.filter(name="slo.violation", tid="main")])


def test_trace_recorder_and_exports_match_reference(tmp_path):
    ref, port = both(_record, tmp_path)
    assert port == ref
    assert port[1] == 4 and sorted(port[7]) == [1, 3, 4, 5, 6]


def test_trace_rejects_empty_ring_like_reference():
    for ns in (REF, PORT):
        with pytest.raises(ValueError, match="positive"):
            ns.obs.TraceRecorder(max_events=0)


# ===================================================================== #
# registry                                                              #
# ===================================================================== #
@pytest.mark.parametrize("seed", [0, 1])
def test_registry_and_sketches_match_reference(seed):
    def scenario(ns):
        obs = ns.obs
        rs = np.random.RandomState(seed)
        reg = obs.MetricsRegistry()
        h = reg.histogram("lat.ttft", help="time to first token",
                          rel_err=0.02)
        for v in rs.lognormal(-3.0, 1.0, 500):
            h.observe(float(v))
        h.observe(0.0)
        h.observe(-1.0)
        reg.counter("req.total", help="requests").inc(5)
        reg.counter("req.total").inc()
        reg.gauge("1weird-name").set(3.5)
        reg.gauge("pool").inc(2)
        n = reg.set_gauges({"a": 1, "b": 2.5, "c": "x", "d": True,
                            "e": None}, prefix="summary")
        with pytest.raises(TypeError):
            reg.gauge("req.total")
        with pytest.raises(ValueError):
            reg.counter("req.total").inc(-1)
        sk = obs.PercentileSketch(rel_err=0.01, max_buckets=16)
        for v in rs.uniform(1e-6, 1e3, 300):
            sk.add(float(v))
        return (n, reg.names(), reg.snapshot(), reg.to_prometheus_text(),
                sk.summary(), [sk.quantile(q) for q in (0, .3, .99, 1)])
    ref, port = both(scenario)
    assert port == ref
    assert "# TYPE req_total counter" in port[3]


# ===================================================================== #
# SLO and lag ratio                                                     #
# ===================================================================== #
def test_slo_monitors_match_reference():
    def scenario(ns):
        obs = ns.obs
        now = [0.0]
        tr = obs.TraceRecorder(clock=lambda: now[0])
        reg = obs.MetricsRegistry()
        fired = []
        mon = obs.SLOMonitor(
            [obs.SLOTarget("ttft", 0.95, 0.2),
             obs.SLOTarget("decode_latency", 0.99, 0.01),
             obs.SLOTarget("decode_latency", 0.999, 0.05)],
            clock=lambda: now[0], registry=reg, tracer=tr, window=64,
            min_samples=4)
        mon.add_violation_hook(lambda t, v, at: fired.append((t.key, v, at)))
        out = []
        for step in range(40):
            now[0] = 0.25 * step
            mon.observe("ttft", 0.05 if step < 20 else 0.5)
            mon.observe("decode_latency", 0.002 * (step % 7 + 1))
            if step % 5 == 4:
                out.append(_keyed(mon.check()))
        out.append((_keyed(mon.check(now=99.0)), mon.summary(),
                    [mon.quantile("decode_latency", q) for q in
                     (0.5, 0.99)], mon.violation_rate("ttft.p95"),
                    mon.violation_rate("nope"), fired, _events(tr),
                    reg.snapshot()))
        lag = obs.LagRatioMonitor()
        for cycle in range(6):
            lag.observe_epoch("burst", 4.0, 1.0 + cycle % 2)
            for _ in range(3):
                lag.observe_epoch("steady", 8.0, 1.0)
            lag.observe_epoch("idle", 0.0, 0.0)
        out.append((lag.ratio(), lag.ratio("steady"), lag.summary()))
        return out
    ref, port = both(scenario)
    assert port == ref


def test_serving_metrics_publish_like_reference():
    def scenario(ns):
        obs = ns.obs
        reg = obs.MetricsRegistry()
        slo = obs.SLOMonitor([obs.SLOTarget("decode_latency", 0.95, 0.03)],
                             clock=lambda: 0.0, registry=reg)
        m = ns.serving_metrics.ServingMetrics(registry=reg, slo=slo)
        for rid in range(3):
            m.on_submit(rid, 0.1 * rid, 8 + rid)
        m.on_admit(0, 0.2)
        m.on_admit(1, 0.3)
        for t in range(6):
            for rid in (0, 1):
                m.on_token(rid, 0.3 + 0.04 * t + 0.01 * rid)
        m.on_preempt(2, 0.5)
        m.on_finish(0, 0.6, 0)
        for it in range(4):
            m.on_iteration(it, 5 + it, 2, 2, 1)
        return (m.summary({"migrated_bytes": 4096}), m.per_request_rows(),
                reg.snapshot(), _keyed(slo.check()), slo.summary())
    ref, port = both(scenario)
    assert port == ref


# ===================================================================== #
# audit                                                                 #
# ===================================================================== #
def test_prediction_ledger_matches_reference():
    def scenario(ns):
        obs = ns.obs
        reg = obs.MetricsRegistry()
        tr = obs.TraceRecorder(clock=_clock(np.arange(0.0, 100.0, 1.0)))
        led = obs.PredictionLedger(registry=reg, tracer=tr, tolerance=0.25,
                                   drift_bound=0.3, drift_window=8,
                                   drift_min_samples=4, max_pending=3)
        out = []
        led.predict("m", "k", 10.0, epoch=1)
        out.append(led.realize("m", "k", 12.0))
        led.predict("m", "k2", 10.0)
        out.append(led.realize("m", "k2", 7.0, resources={"upi": 3.0,
                                                         "cxl": 1.0}))
        out.append(led.realize("m", "ghost", 1.0))
        led.predict("m", "dup", 10.0)
        led.predict("m", "dup", 20.0)
        out.append(led.realize("m", "dup", 20.0, resources=["upi"]))
        led.predict("z", "k", 0.0)
        out.append(led.realize("z", "k", 5.0))
        for i in range(5):
            led.predict("p", i, 1.0)
        for i in range(6):
            led.predict("drift", i, 10.0)
            out.append(led.realize("drift", i, 16.0))
        led.set_model_tolerance("drift", 0.7)
        out = [dataclasses.asdict(r) if r is not None else None
               for r in out]
        out.append((led.models(), led.pending_count(), led.pending_count("p"),
                    led.has_pending("p", 0), led.has_pending("p", 4),
                    led.rel_errors("m"), led.p95_abs_rel_err("m"),
                    led.accuracy("m"), led.accuracy("drift"),
                    led.resource_bias(), led.drifting(), led.summary(),
                    led.report(), reg.snapshot(), _events(tr)))
        det = obs.DriftDetector(bound=0.5, window=4, min_samples=2)
        out.append(([det.observe(e) for e in (0.1, 0.9, 0.9, 0.9, 0.1)],
                    det.p95(), det.fires))
        return out
    ref, port = both(scenario)
    assert port == ref


# ===================================================================== #
# transfer probes                                                       #
# ===================================================================== #
def test_transfer_probes_on_the_cpu():
    """One bandwidth-only probe per kind, in order; an unknown kind
    raises instead of being skipped."""
    from repro_torch.obs import measure_transfer_probes, TierProbe
    kinds = ("device", "pinned_host", "unpinned_host")
    probes = measure_transfer_probes(kinds, n_mb=1, iters=2, device="cpu")
    assert [p.tier for p in probes] == list(kinds)
    assert all(isinstance(p, TierProbe) and p.bw_GBps > 0
               and p.latency_ns is None for p in probes)
    with pytest.raises(ValueError, match="unknown memory kind"):
        measure_transfer_probes(("device", "cxl"), n_mb=1, device="cpu")


def test_transfer_probes_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch
    from repro_torch.obs import measure_transfer_probes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_transfer_probes(n_mb=1)
