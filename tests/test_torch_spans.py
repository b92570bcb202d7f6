"""Hot-path spans of the port's serving engine
(``ServingConfig.trace_spans``), on the CPU: with spans off the engine's
trace is the reference's event for event; with spans on the tokens and
the control plane are unchanged, and each decode and prefill splits into
its parts (enqueue, the host's wait on the device, bookkeeping), nested
by id and parent, in a ring of their own that never evicts a
control-plane event, and under ``torch.profiler`` as the profiler's
ranges.
"""
import importlib.util
import json
from itertools import chain
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_engines_match, engine_tokens,  # noqa: E402
                           engine_trace, PlaneSteps, ref_pod_parts,
                           serve_both, StepClock, tiny_model, tpu_bases)

from repro_torch.obs import TraceEvent, TraceRecorder  # noqa: E402
from repro_torch.serving import ServingConfig, ServingEngine  # noqa: E402

PATHS = pytest.mark.parametrize("fused", [False, True],
                                ids=["staged", "fused"])
# expert residency under the predictive control plane, so that the
# routing feed, the tier epoch and a replan epoch all run
SV = dict(block_tokens=8, max_batch=3, max_context=32, policy="tiering08",
          expert_policy="lru", expert_fast_fraction=0.25, adaptive=True,
          predictive=True, replan_every=2)
DECODE_PARTS = ["engine.decode.inputs", "engine.decode.forward",
                "engine.decode.read", "engine.decode.commit"]
PREFILL_PARTS = ["engine.prefill.forward", "engine.prefill.write",
                 "engine.prefill.read"]
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def moe():
    # test_torch_experts' prompts: wide top-2 logit and router margins
    return tiny_model("qwen3-moe-30b-a3b", 8, (10, 6, 13))


@pytest.fixture(autouse=True)
def _reference_tiers(monkeypatch):
    import repro_torch.serving.engine as engine_mod
    monkeypatch.setattr(engine_mod, "kind_bases", tpu_bases)


def _serve(moe, fused, spans, clock=None, **sv):
    """The port's engine over ``moe``'s prompts; also returns the rids
    the scheduler admitted and (step, rows) of each decode iteration,
    in order."""
    _, _, cfg, params, prompts = moe
    extra = {} if clock is None else {"clock": clock}
    eng = ServingEngine(cfg, params, ServingConfig(
        **SV, fused_gather=fused, trace_spans=spans, **sv), device="cpu",
        **extra)
    if clock is not None:
        clock.engine = eng
    admitted, decodes = [], []
    admit, decode = eng.sched.admit, eng._decode_iteration

    def admit_seen(**kw):
        out = admit(**kw)
        admitted.extend(r.rid for r in out)
        return out

    def decode_seen(now):
        if eng.sched.running:
            decodes.append((eng._step, len(eng.sched.running)))
        decode(now)
    eng.sched.admit, eng._decode_iteration = admit_seen, decode_seen
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    rep = eng.run()
    return eng, rep, admitted, decodes


@pytest.fixture(scope="module")
def traced(moe):
    """One run per path with spans on, on the wall clock."""
    import repro_torch.serving.engine as engine_mod
    mp = pytest.MonkeyPatch()
    mp.setattr(engine_mod, "kind_bases", tpu_bases)
    try:
        yield {fused: _serve(moe, fused, True) for fused in (False, True)}
    finally:
        mp.undo()


def _spans(eng, name=None):
    return [e for e in eng.tracer.spans
            if e.cat == "span" and (name is None or e.name == name)]


def _end(e):
    return e.ts_s + e.dur_s


# ---------------------------------------------------------------- off
@PATHS
def test_spans_off_trace_matches_reference(moe, fused):
    ref, ref_rep, eng, rep = serve_both(moe, dict(SV, fused_gather=fused),
                                        NEW_TOKENS)
    assert not eng.sv.trace_spans
    assert not eng.tracer.spans
    assert all(e.cat != "span" and e.id is None and e.parent is None
               for e in eng.tracer.events)
    assert_engines_match(ref, ref_rep, eng, rep)


@PATHS
def test_spans_on_leave_tokens_and_control_plane(moe, fused):
    off = _serve(moe, fused, False, StepClock())
    on = _serve(moe, fused, True, StepClock())
    assert engine_tokens(on[0]) == engine_tokens(off[0])
    assert on[2:] == off[2:]              # admissions and decode rows
    assert engine_trace(on[0]) == engine_trace(off[0])
    assert on[1].tiering == off[1].tiering
    assert on[0].expert_pool.summary() == off[0].expert_pool.summary()
    assert len(_spans(on[0])) == len(on[0].tracer.spans) > 0
    assert on[0].tracer.dropped == on[0].tracer.spans_dropped == 0


# ------------------------------------------------------------- decode
@PATHS
def test_one_decode_span_per_iteration_with_four_parts(traced, fused):
    eng, _, _, decodes = traced[fused]
    parents = _spans(eng, "engine.decode")
    assert [(e.args["step"], e.args["rows"]) for e in parents] == decodes
    by_parent = {}
    for e in _spans(eng):
        if e.name.startswith("engine.decode."):
            by_parent.setdefault(e.parent, []).append(e)
    assert set(by_parent) == {p.id for p in parents}
    for p in parents:
        assert p.parent is None
        kids = sorted(by_parent[p.id], key=lambda e: e.ts_s)
        assert [k.name for k in kids] == DECODE_PARTS
        assert all(k.id > p.id for k in kids)
        assert p.ts_s <= kids[0].ts_s and _end(kids[-1]) <= _end(p)
        for a, b in zip(kids, kids[1:]):
            assert _end(a) <= b.ts_s          # no overlap
        assert sum(k.dur_s for k in kids) >= 0.9 * p.dur_s


@PATHS
def test_prefill_span_per_admitted_request(traced, fused):
    eng, _, admitted, _ = traced[fused]
    parents = _spans(eng, "engine.prefill")
    assert [e.args["rid"] for e in parents] == admitted
    prompts = {r.rid: len(r.prompt) for r in eng.sched.finished}
    assert all(e.args["tokens"] == prompts[e.args["rid"]] for e in parents)
    for p in parents:
        kids = sorted((e for e in _spans(eng) if e.parent == p.id),
                      key=lambda e: e.ts_s)
        assert [k.name for k in kids] == PREFILL_PARTS
        assert p.ts_s <= kids[0].ts_s and _end(kids[-1]) <= _end(p)


@PATHS
def test_tier_and_replan_epoch_once_per_iteration(traced, fused):
    eng = traced[fused][0]
    steps = list(range(eng._step))
    for name in ("engine.tier_epoch", "engine.replan_epoch"):
        spans = _spans(eng, name)
        assert [e.args["epoch"] for e in spans] == steps, name
        assert all(e.parent is None for e in spans)
    # the epochs run after the iteration's decode, outside its span
    ends = {e.args["step"]: _end(e) for e in _spans(eng, "engine.decode")}
    for e in _spans(eng, "engine.tier_epoch"):
        if e.args["epoch"] in ends:
            assert e.ts_s >= ends[e.args["epoch"]]


def test_span_ids_are_unique_and_parents_enclose(traced):
    eng = traced[True][0]
    spans = _spans(eng)
    by_id = {e.id: e for e in spans}
    assert len(by_id) == len(spans)
    for e in spans:
        if e.parent is not None:
            p = by_id[e.parent]
            assert p.ts_s <= e.ts_s and _end(e) <= _end(p)


# ----------------------------------------------------------- profiler
def _profiled_ranges(moe, fused, spans):
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng = _serve(moe, fused, spans)[0]
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro_torch."):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return eng, ranges


@pytest.mark.parametrize("spans", [True, False], ids=["on", "off"])
def test_profiler_ranges_nest_under_engine_decode(moe, spans):
    """Under ``torch.profiler`` every span is a profiler range while the
    engine's spans are on, each decode's forward range inside a decode
    range; with spans off the engine opens no range at all."""
    eng, ranges = _profiled_ranges(moe, True, spans)
    if not spans:
        assert ranges == {} and not eng.tracer.spans
        return
    names = {"repro_torch." + n for n in
             ["engine.decode", "engine.prefill", "engine.tier_epoch",
              "engine.replan_epoch"] + DECODE_PARTS + PREFILL_PARTS}
    assert names <= set(ranges)
    decodes = ranges["repro_torch.engine.decode"]
    fwd = ranges["repro_torch.engine.decode.forward"]
    assert len(fwd) == len(decodes) > 0
    for s, e in fwd:
        assert any(ds <= s and e <= de for ds, de in decodes)
    assert len(_spans(eng, "engine.decode")) == len(decodes)


# ------------------------------------------------------------ exports
def test_jsonl_round_trip_keeps_id_and_parent(traced, tmp_path):
    eng = traced[True][0]
    path = tmp_path / "t.jsonl"
    n = eng.tracer.to_jsonl(str(path))
    back = TraceRecorder.read_jsonl(str(path))
    assert n == len(back) == len(eng.tracer)
    written = list(chain(eng.tracer.events, eng.tracer.spans))
    assert [(e.id, e.parent) for e in back] == \
        [(e.id, e.parent) for e in written]
    assert [e.to_dict() for e in back] == [e.to_dict() for e in written]
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert all(("id" in r) == (r["cat"] == "span") for r in rows)
    # the Chrome export keeps its shape: spans are X events on one tid
    chrome = tmp_path / "t.json"
    eng.tracer.to_chrome(str(chrome))
    events = json.loads(chrome.read_text())["traceEvents"]
    spans = [e for e in events if e["cat"] == "span"]
    assert len(spans) == len(eng.tracer.spans) > 0
    assert all(e["ph"] == "X" and e["tid"] == "main"
               and set(e) == {"name", "cat", "ph", "ts", "pid", "tid",
                              "args", "dur"} for e in spans)


def test_recorder_hot_spans_nest_only_when_asked():
    ticks = iter(range(100))
    plain = TraceRecorder(clock=lambda: float(next(ticks)))
    with plain.span("a"):
        with plain.span("b"):
            pass
    assert [(e.name, e.id, e.parent) for e in plain.events] == \
        [("b", None, None), ("a", None, None)]
    assert all("id" not in e.to_dict() and "parent" not in e.to_dict()
               for e in plain.events)
    nested = TraceRecorder(clock=lambda: float(next(ticks)), hot_spans=True)
    with nested.span("a"):
        with nested.span("b"):
            with nested.span("c"):
                pass
        with nested.span("d"):
            pass
    with nested.span("e"):
        pass
    assert not nested.events
    assert [(e.name, e.id, e.parent) for e in nested.spans] == [
        ("c", 3, 2), ("b", 2, 1), ("d", 4, 1), ("a", 1, None),
        ("e", 5, None)]
    d = nested.spans[0].to_dict()
    assert (d["id"], d["parent"]) == (3, 2)
    assert TraceEvent.from_dict(d) == nested.spans[0]
    root = TraceEvent.from_dict(nested.spans[-1].to_dict())
    assert (root.id, root.parent) == (5, None)


def test_hot_spans_keep_a_ring_of_their_own(tmp_path):
    """Spans that outnumber the ring evict only older spans: every
    control-plane event survives, and both exports say what was
    dropped."""
    tr = TraceRecorder(clock=lambda: 0.0, max_events=4, hot_spans=True)
    tr.event("arbiter.grant", epoch=0)
    for i in range(10):
        with tr.span("engine.decode", cat="span", step=i):
            pass
        if i == 5:
            tr.event("phase.update", epoch=1)
    assert [e.name for e in tr.events] == ["arbiter.grant", "phase.update"]
    assert [e.args["step"] for e in tr.spans] == [6, 7, 8, 9]
    assert (tr.dropped, tr.spans_dropped, len(tr)) == (0, 6, 6)
    assert tr.filter(cat="span") == list(tr.spans)
    assert tr.to_jsonl(str(tmp_path / "t.jsonl")) == 6
    names = [e.name for e in
             TraceRecorder.read_jsonl(str(tmp_path / "t.jsonl"))]
    assert names == ["arbiter.grant", "phase.update"] + \
        ["engine.decode"] * 4
    tr.to_chrome(str(tmp_path / "t.json"))
    meta = json.loads((tmp_path / "t.json").read_text())["metadata"]
    assert meta == {"dropped_events": 0, "dropped_spans": 6}


@PATHS
def test_spans_that_fill_the_ring_leave_the_control_plane(moe, fused):
    """An engine whose ring just holds a run's control plane: with spans
    on, the spans overflow their own ring and the control-plane trace is
    the spans-off run's, whole; the summary counts the evicted spans."""
    off = _serve(moe, fused, False, StepClock())
    size = len(off[0].tracer.events)
    on = _serve(moe, fused, True, StepClock(), trace_max_events=size)
    assert off[0].tracer.dropped == on[0].tracer.dropped == 0
    assert engine_trace(on[0]) == engine_trace(off[0])
    assert len(on[0].tracer.spans) == size
    assert on[0].tracer.spans_dropped > 0
    summary = on[0].telemetry_summary()
    assert summary["trace_dropped_events"] == 0.0
    assert summary["trace_dropped_spans"] == on[0].tracer.spans_dropped
    assert "trace_dropped_spans" not in off[0].telemetry_summary()


# ---------------------------------------------------------------- CLI
def test_serve_cli_turns_spans_on_with_trace_out(tmp_path, monkeypatch,
                                                 capsys):
    from repro_torch.launch import serve
    monkeypatch.chdir(tmp_path)
    base = ["--arch", "llama3-8b", "--smoke", "--scheduler", "continuous",
            "--device", "cpu", "--num-requests", "3", "--new-tokens", "4"]
    assert not ServingConfig.from_args(serve.parse_args(base)).trace_spans
    assert ServingConfig.from_args(
        serve.parse_args(base + ["--trace-out", "t.json"])).trace_spans
    serve.main(base + ["--trace-out", "t.jsonl"])
    assert "trace: wrote" in capsys.readouterr().out
    events = TraceRecorder.read_jsonl(str(tmp_path / "t.jsonl"))
    spans = [e for e in events if e.cat == "span"]
    assert {"engine.decode", "engine.prefill"} <= {e.name for e in spans}
    assert {"sched.admit", "phase.update"} <= {e.name for e in events}
    ids = {e.id for e in spans}
    assert all(e.parent in ids for e in spans
               if e.name.startswith(("engine.decode.", "engine.prefill.")))


def test_serve_cli_reports_evicted_events(capsys):
    from repro_torch.launch import serve
    full = TraceRecorder(max_events=2, hot_spans=True)
    for _ in range(3):
        full.event("sched.admit")
        with full.span("engine.decode", cat="span"):
            pass
    serve._report_trace_drops([TraceRecorder(), full])
    assert "evicted the oldest 1 control-plane events and 1 spans" in \
        capsys.readouterr().out
    serve._report_trace_drops([TraceRecorder()])
    assert capsys.readouterr().out == ""


def test_cluster_trace_holds_each_replica_spans():
    """A two-replica plane with spans on: the merged trace keeps every
    replica's control-plane events in order first, then its spans, each
    tid prefixed with the replica."""
    from repro_torch.cluster import ClusterPlane
    from repro_torch.topology import multi_host_pod
    _, _, cfg, params, prompts = tiny_model("llama3-8b", 2, (12, 7, 9))
    clock = StepClock()
    plane = ClusterPlane(
        cfg, params, serving=ServingConfig(
            block_tokens=8, max_batch=2, max_context=32,
            policy="tiering08", trace_spans=True),
        n_replicas=2, clock=clock, seed=1, devices=["cpu"],
        testbed=multi_host_pod(2, tiers=ref_pod_parts()))
    clock.engine = PlaneSteps(plane)
    for i, p in enumerate(prompts):
        plane.submit(p, 4, arrival_s=0.005 * i)
    plane.run()
    merged = plane.merged_trace()
    n_events = len(plane.tracer.events) + sum(
        len(r.engine.tracer.events) for r in plane.replicas.values())
    control, spans = merged[:n_events], merged[n_events:]
    assert all(e.cat != "span" for e in control)
    hosts = sorted(plane.replicas)
    want = []
    for h in hosts:
        want += [(f"{h}/{e.tid}", e.id) for e in
                 plane.replicas[h].engine.tracer.spans]
    assert [(e.tid, e.id) for e in spans] == want
    assert {e.tid.split("/")[0] for e in spans} == set(hosts)
    assert {"engine.decode", "engine.prefill"} <= {e.name for e in spans}


# -------------------------------------------------- tools/serve_spans.py
ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "serve_spans", ROOT / "tools" / "serve_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_tool_means_and_decode_parts():
    """The tool's reading of a window's spans: count and mean ms per
    name, and the four decode parts summed (None where one is missing)."""
    tool = _tool()
    spans = [("engine.decode", 0.0, 0.110), ("engine.decode", 1.0, 1.090),
             ("engine.decode.inputs", 0.0, 0.001),
             ("engine.decode.forward", 0.001, 0.081),
             ("engine.decode.read", 0.081, 0.096),
             ("engine.decode.commit", 0.096, 0.106),
             ("engine.prefill", 2.0, 2.3)]
    means = tool.span_means(spans)
    assert means["engine.decode"]["n"] == 2
    assert means["engine.decode"]["mean_ms"] == pytest.approx(100.0)
    assert means["engine.prefill"] == {"n": 1,
                                       "mean_ms": pytest.approx(300.0)}
    assert tool.decode_parts_ms(means) == pytest.approx(106.0)
    assert tool.decode_parts_ms(tool.span_means(spans[:3])) is None
    assert tool.span_means([]) == {}
