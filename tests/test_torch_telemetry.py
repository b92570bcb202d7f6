"""The port's telemetry plane against the JAX reference's
(``tests/test_telemetry.py`` inputs): access traces, the deterministic
sampler, phase detection and the adaptive replanner, each scenario run
once on each package.  Traces, samples, phase shifts, replan decisions,
plans and trace events must be equal; modeled costs equal within 1e-12
relative."""
import dataclasses
import importlib
import types

import pytest

pytest.importorskip("torch")

REL = 1e-12


def _pkg(root):
    ns = types.SimpleNamespace(root=root)
    for m in ("core", "core.migration", "core.policies", "pool.ledger",
              "telemetry", "obs.trace"):
        setattr(ns, m.replace(".", "_"),
                importlib.import_module(f"{root}.{m}"))
    return ns


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def _tiers(ns, ldram_gib=96):
    t = {k: v for k, v in ns.core.paper_system("A").items()
         if k in ("LDRAM", "CXL")}
    t["LDRAM"] = dataclasses.replace(t["LDRAM"], capacity_GiB=ldram_gib)
    return t


def _traffic(t):
    return (t.read_bytes, t.write_bytes, t.random_bytes, t.events,
            t.epochs, t.random_fraction, t.read_bytes_per_epoch,
            t.write_bytes_per_epoch)


def _buckets(tr):
    return [(e, {o: _traffic(t) for o, t in b.items()})
            for e, b in tr.buckets()]


def _emit_epoch(tr, spec):
    for obj, (r, w, rf) in spec.items():
        tr.record(obj, read_bytes=r, write_bytes=w, random_fraction=rf)
    tr.advance_epoch()


# ===================================================================== #
# events                                                                #
# ===================================================================== #
def test_access_trace_matches_reference():
    def scenario(ns):
        T = ns.telemetry.AccessTrace
        tr = T(capacity_epochs=4)
        out = []
        tr.record("a", read_bytes=100, write_bytes=50, random_fraction=0.5)
        tr.record("a", read_bytes=100)
        tr.record("b", write_bytes=30, phase="prefill")
        tr.record("z", read_bytes=0, write_bytes=0)
        tr.record("gone", read_bytes=7)
        tr.forget("gone")
        tr.advance_epoch()
        for i in range(7):
            tr.record("a", read_bytes=200 + i, block=i, phase="decode")
            tr.record("c", write_bytes=10 * i, random_fraction=0.9)
            tr.advance_epoch()
        out.append((_buckets(tr), tr.epoch, tr.total_events,
                    tr.dropped_epochs, tr.phase_events, tr.epochs_recorded))
        out.append({o: _traffic(t) for o, t in
                    tr.object_traffic(window=2).items()})
        out.append(tr.epoch_vector())
        G = ns.core.GiB
        objs = tr.to_data_objects({"a": 20 * G, "c": 5 * G, "cold": G},
                                  window=3, pin_fast=["cold"],
                                  groups={"a": "kv"})
        out.append([dataclasses.asdict(o) for o in objs])
        ev = ns.telemetry.AccessEvent("x", 3, 4, 0.5, "p", 2)
        out.append((ev.total_bytes, dataclasses.astuple(ev)))
        return out
    ref, port = both(scenario)
    assert port == ref


# ===================================================================== #
# sampler                                                               #
# ===================================================================== #
@pytest.mark.parametrize("rate", [1e-6, 0.01, 0.3, 1.0])
def test_sampler_matches_reference(rate):
    """Same samples, carries, estimated bytes and modeled overhead."""
    def scenario(ns):
        T, S, C = (ns.telemetry.AccessTrace, ns.telemetry.AccessSampler,
                   ns.telemetry.SamplerConfig)
        G = ns.core.GiB
        tr = T()
        sm = S(tr, C(sample_rate=rate))
        costly = S(T(), C(sample_rate=rate, tier=_tiers(ns)["CXL"]))
        for e in range(6):
            sm.observe("u", read_bytes=10 * G, write_bytes=2 * G)
            for i in range(50):
                sm.observe("tiny", read_bytes=640, phase="decode")
                sm.observe(f"seq{i}", read_bytes=640 * (i + 1),
                           write_bytes=64 * e, block=i)
                if i % 7 == 0:
                    sm.forget(f"seq{i}")
            costly.observe("a", read_bytes=64 * 100 * (e + 1))
            sm.advance_epoch()
        return (_buckets(tr), sm.samples, sorted(sm._carry.items()),
                costly.samples, sm.overhead_fraction(3.0)), \
            (sm.overhead_s, costly.overhead_s)
    (ref, ref_s), (port, port_s) = both(scenario)
    assert port == ref
    assert port_s == pytest.approx(ref_s, rel=REL)


def test_sampler_rejects_nonpositive_rate_like_reference():
    for ns in (REF, PORT):
        with pytest.raises(ValueError, match="positive"):
            ns.telemetry.SamplerConfig(sample_rate=0.0)


# ===================================================================== #
# phases                                                                #
# ===================================================================== #
PHASE_SCRIPT = ([{"u": (50, 10, 0.0)}] * 5 + [{"a": (20, 0, 0.9)}] * 5
                + [{}] + [{"u": (50, 10, 0.0)}] * 3
                + [{"a": (20, 0, 0.9)}] * 4 + [{"u": (50, 10, 0.0)}] * 3
                + [{"w": (10, 10, 0.0), "u": (10, 0, 0.0)}] * 2
                + [{"a": (20, 0, 0.9)}] * 4 + [{"u": (5, 1, 0.0)}] * 2)


@pytest.mark.parametrize("threshold,min_epochs", [(0.35, 2), (0.35, 1),
                                                  (0.1, 3)])
def test_phase_detector_matches_reference(threshold, min_epochs):
    """Labels, shifts, recurrence signatures and their predictions over
    a script with recurring, idle and drifting epochs."""
    def scenario(ns):
        tel = ns.telemetry
        G = ns.core.GiB
        tr = tel.AccessTrace()
        det = tel.PhaseDetector(tr, threshold=threshold,
                                min_phase_epochs=min_epochs,
                                max_signatures=4, signature_ttl_epochs=12)
        out = []
        for spec in PHASE_SCRIPT:
            _emit_epoch(tr, {o: (r * G, w * G, rf)
                             for o, (r, w, rf) in spec.items()})
            s = det.update()
            out.append((s and dataclasses.astuple(s), det.label,
                        det.phase_id, det.epochs_in_phase,
                        det.signature, det.epochs_in_signature,
                        det.expected_signature(1), det.expected_signature(3),
                        tel.classify_traffic(tr.last_completed()),
                        tel.traffic_signature(tr.last_completed())))
            assert det.update() is None          # nothing new completed
        out.append((tel.traffic_distance({"a": 1.0}, {"b": 1.0}),
                    tel.traffic_distance({"a": .5, "b": .5}, {"a": 1.0}),
                    tel.classify_traffic({})))
        return out
    ref, port = both(scenario)
    assert port == ref


# ===================================================================== #
# replanner                                                             #
# ===================================================================== #
def _decision(d):
    return None if d is None else dataclasses.asdict(d)


def _assert_runs_equal(port, ref):
    """Decisions (costs within REL), plans and trace events equal."""
    pd, pr = port
    rd, rr = ref
    assert pr == rr
    assert len(pd) == len(rd)
    for a, b in zip(pd, rd):
        if b is None:
            assert a is None
            continue
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], float):
                assert a[k] == pytest.approx(b[k], rel=REL), k
            else:
                assert a[k] == b[k], k


def _replan_run(ns, script, cfg, move_fn=None, nb=None, ledger=False,
                budget=None):
    """Drive a replanner through ``script``: a list of (epochs to emit,
    traffic spec, phase, force, nbytes override).  Returns (decisions,
    (plans, summary, trace events, ledger view))."""
    G = ns.core.GiB
    tel = ns.telemetry
    tiers = _tiers(ns)
    tr = tel.AccessTrace()
    tracer = ns.obs_trace.TraceRecorder(clock=lambda: 0.0)
    ex = (ns.core_migration.MigrationExecutor(tiers, move_fn=move_fn)
          if move_fn else None)
    led = ns.pool_ledger.ResidencyLedger(tiers) if ledger else None
    rp = tel.AdaptiveReplanner(tr, tiers, "LDRAM",
                               cfg=tel.ReplanConfig(**cfg), executor=ex,
                               ledger=led, tenant="t", tracer=tracer)
    if budget is not None:
        rp.ledger.set_budget("t", "LDRAM", budget * G)
    nb = {k: v * G for k, v in (nb or {"u": 60, "w": 60}).items()}
    decisions, plans = [], []
    for epoch, (n, spec, phase, force, over) in enumerate(script, 1):
        for _ in range(n):
            _emit_epoch(tr, {o: (r * G, w * G, rf)
                             for o, (r, w, rf) in spec.items()})
        names = nb if over is None else {k: v * G for k, v in over.items()}
        d = rp.maybe_replan(epoch, names, force=force, phase=phase)
        decisions.append(_decision(d))
        plans.append(None if rp.plan is None else
                     (rp.plan.policy, rp.plan.shares))
    events = [(e.name, e.cat, e.tid, e.args) for e in tracer.events]
    return decisions, (plans, rp.summary(), events,
                       rp.ledger.shares("t"), rp.replans_applied,
                       rp.moved_bytes, rp.plan_cache_hits)


A = {"u": (120, 60, 0.0)}
B = {"w": (120, 60, 0.0)}
SCRIPTS = {
    "stable": ([(4, A, None, False, None)] * 3,
               dict(replan_every=1)),
    "cadence": ([(4, A, None, False, None)] * 6, dict(replan_every=5)),
    "shift": ([(4, A, None, False, None), (4, B, None, False, None),
               (4, A, None, False, None)],
              dict(replan_every=1, window_epochs=2, amortize_steps=16)),
    "hysteresis": ([(4, {"u": (120, 0, 0.0)}, None, False, None),
                    (4, {"u": (10, 0, 0.4)}, None, False, None)],
                   dict(replan_every=1, min_speedup=10.0)),
    "phase_cache": ([(3, A, "A", False, None), (4, B, "B", False, None),
                     (4, A, "A", False, None), (4, B, "B", False, None),
                     (1, A, "C", False, None),
                     (1, A, "A", False, {"u": 60, "new_obj": 10})],
                    dict(replan_every=1, window_epochs=2,
                         amortize_steps=32)),
    "migration_cost": ([(4, A, None, True, None),
                        (4, {"w": (12, 6, 0.0)}, None, True, None)],
                       dict(replan_every=0, amortize_steps=2)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_replanner_matches_reference(name):
    script, cfg = SCRIPTS[name]
    ref, port = both(_replan_run, script, cfg)
    _assert_runs_equal(port, ref)


def test_replanner_with_denied_moves_matches_reference():
    """A move_fn that denies half of every move: realized residency,
    denied bytes and executor trace events are the reference's."""
    def half(obj, src, dst, nbytes):
        return nbytes // 2
    script, cfg = SCRIPTS["shift"]
    ref, port = both(_replan_run, script, cfg, half)
    _assert_runs_equal(port, ref)
    assert any(d and d["denied_bytes"] > 0 for d in port[0])


def test_replanner_under_ledger_budget_matches_reference():
    """A shared ledger with a fast-tier budget below the plan's wish:
    budget-capped planning, then a mandatory shrink."""
    ref, port = both(_replan_run, *SCRIPTS["shift"], None, None, True, 40)
    _assert_runs_equal(port, ref)


def test_replanner_no_traffic_no_decision_like_reference():
    for ns in (REF, PORT):
        rp = ns.telemetry.AdaptiveReplanner(ns.telemetry.AccessTrace(),
                                            _tiers(ns), "LDRAM")
        assert rp.maybe_replan(0, {"u": ns.core.GiB}, force=True) is None
