"""Adaptive, observed serving of the port against the JAX reference: the
tiny llama3-8b engine with ``adaptive=True`` on both decode paths, the
nested ``ServingConfig`` sections and their validation, the tiers the
engine plans over, and the CLI's ``--trace-out``/``--metrics-out``/
``--audit-out`` artifacts, all on the CPU.

The reference plans over its TPU tier descriptors; for the engine
parity they are handed to the port (``kind_bases`` monkeypatched),
converted to the port's ``MemoryTier``.  Time-based outputs (timestamps,
the lag ratio) are never compared."""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import tree_to_torch  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import tpu_v5e_tiers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.config import ConfigError as JConfigError  # noqa: E402
from repro.serving.config import validate_args as jvalidate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.tiers import MemoryTier  # noqa: E402
from repro_torch.obs import replan_chains  # noqa: E402
from repro_torch.serving import (ConfigError, FAST_KIND,  # noqa: E402
                                 kind_bases, kind_tiers, PagedKVPool,
                                 ServingConfig, ServingEngine,
                                 validate_args)
from repro_torch.serving import engine as engine_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SV = dict(block_tokens=8, max_batch=3, max_context=40, policy="tiering08",
          replan_every=2)
NEW_TOKENS = 10
# wall-clock outputs of telemetry_summary
TIMED = {"live_burst_entry_ratio"}


def _tpu_bases(pool):
    """The reference's TPU descriptors of the three kinds, as the port's
    MemoryTier: parity input only."""
    t = tpu_v5e_tiers()
    return {kind: MemoryTier(**dataclasses.asdict(t[name]))
            for kind, name in (("device", "HBM"), ("pinned_host", "HOST"),
                               ("unpinned_host", "HOST_UNPINNED"))}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jsmoke("llama3-8b")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, jcfg.vocab, (n,)).astype(np.int32)
               for n in (12, 7, 9, 20, 5)]
    return jcfg, jparams, get_smoke_config("llama3-8b"), \
        tree_to_torch(jparams), prompts


def _serve(cls, cfg_cls, cfg, params, prompts, **kw):
    extra = {"device": "cpu"} if cls is ServingEngine else {}
    eng = cls(cfg, params, cfg_cls(**{**SV, **kw}), **extra)
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    return eng, eng.run()


def _tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.sched.finished}


def _decisions(eng):
    return [(d.epoch, d.applied, d.reason, d.moved_bytes, d.denied_bytes)
            for d in eng.replanner.decisions]


def _trace(eng):
    return [(e.name, e.cat, e.ph, e.tid, e.args) for e in eng.tracer.events]


@pytest.fixture(scope="module")
def runs(tiny):
    """(reference, port adaptive, port non-adaptive) engine runs per
    path, the port planning over the reference's tier descriptors."""
    jcfg, jparams, cfg, params, prompts = tiny
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "kind_bases", _tpu_bases)
        for fused in (False, True):
            out[fused] = (
                _serve(JServingEngine, JServingConfig, jcfg, jparams,
                       prompts, adaptive=True, fused_gather=fused),
                _serve(ServingEngine, ServingConfig, cfg, params, prompts,
                       adaptive=True, fused_gather=fused),
                _serve(ServingEngine, ServingConfig, cfg, params, prompts,
                       fused_gather=fused))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_adaptive_engine_matches_reference(runs, fused):
    (ref, ref_rep), (eng, rep), _ = runs[fused]
    assert _tokens(eng) == _tokens(ref)
    assert _decisions(eng) == _decisions(ref)
    assert any(d[1] and d[3] > 0 for d in _decisions(eng))  # blocks moved
    want = {k: v for k, v in ref_rep.telemetry.items() if k not in TIMED}
    got = {k: v for k, v in rep.telemetry.items() if k not in TIMED}
    assert got == want
    assert _trace(eng) == _trace(ref)
    assert rep.tiering == ref_rep.tiering
    assert eng.pool.used_block_count() == 0


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_adaptive_changes_residency_never_tokens(runs, fused):
    _, (eng, rep), (plain, plain_rep) = runs[fused]
    assert _tokens(eng) == _tokens(plain)
    assert rep.telemetry["moved_bytes"] > 0
    assert "replans_considered" not in plain_rep.telemetry
    # the observability plane is built on every run, adaptive or not
    assert plain_rep.telemetry["trace_events"] > 0
    assert plain.tracer.filter(name="phase.update")


def test_engine_trace_holds_replan_decision_chains(runs):
    _, (eng, rep), _ = runs[False]
    chains = replan_chains(eng.tracer.events)
    decided = {e: c for e, c in chains.items() if c["decisions"]}
    assert sorted(decided) == [d.epoch for d in eng.replanner.decisions]
    assert all(c["phases"] for c in decided.values())
    assert rep.telemetry["replans_considered"] == len(decided)
    # CPU-engine moves are residency bookkeeping: no move-time audit
    assert not eng.replanner.executor.physical_moves
    assert "migration.move_time" not in eng.audit.models()
    assert eng.audit_report()["audit"]["models"]["replan.step_cost"][
        "joins"] > 0


# ===================================================================== #
# tiers from the probes                                                 #
# ===================================================================== #
def test_kind_tiers_are_derived_from_the_probes():
    from repro_torch.serving import KVBlockSpec
    pool = PagedKVPool(12, 4, spec=KVBlockSpec(2, 1, 4, 2, 8),
                       fast_block_budget=5, device="cpu")
    base = kind_bases(pool)
    assert sorted(base) == sorted([FAST_KIND, pool.slow_kind])
    for kind, t in base.items():
        assert t.name == kind and t.peak_bw_GBps > 0
        assert t.stream_bw_GBps == t.peak_bw_GBps
        assert t.saturation_streams == 1.0
        assert t.unloaded_latency_ns == pytest.approx(64 / t.peak_bw_GBps)
        assert t.kind == ("hbm" if kind == FAST_KIND else "host")
    tiers = kind_tiers(pool, *(base[k] for k in (FAST_KIND,
                                                 pool.slow_kind)))
    bn = pool.block_nbytes()
    assert tiers[FAST_KIND].capacity_GiB * 2**30 == pytest.approx(5 * bn)
    assert tiers[pool.slow_kind].capacity_GiB * 2**30 == \
        pytest.approx(12 * bn)
    assert tiers[FAST_KIND].peak_bw_GBps == base[FAST_KIND].peak_bw_GBps


def test_kind_tiers_match_reference_on_the_same_bases():
    from repro.serving import kind_tiers as jkind_tiers
    from repro.serving import PagedKVPool as JPool
    from repro_torch.core.tiers import MemoryTier as T
    t = tpu_v5e_tiers()
    for slow in ("pinned_host", "unpinned_host"):
        want = jkind_tiers(JPool(12, 4, fast_block_budget=5,
                                 slow_kind=slow))
        bases = _tpu_bases(None)
        got = kind_tiers(PagedKVPool(12, 4, fast_block_budget=5,
                                     slow_kind=slow),
                         bases["device"], bases[slow])
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.items()}
    assert T(**dataclasses.asdict(t["HBM"])).bandwidth(8) == \
        t["HBM"].bandwidth(8)


# ===================================================================== #
# configuration                                                         #
# ===================================================================== #
def _sections(sv):
    return {name: dataclasses.asdict(getattr(sv, name))
            for name in ("tiering", "qos_options", "experts")}


def test_serving_config_sections_match_reference():
    from repro.serving import TieringOptions as JTiering
    from repro_torch.serving import TieringOptions
    kw = dict(adaptive=True, replan_every=3, sample_rate=0.5,
              slo_p99_decode_s=0.02, slo_window=64, fused_gather=True,
              policy="static", num_blocks=40)
    assert _sections(ServingConfig(**kw)) == _sections(JServingConfig(**kw))
    # a section passed in wins over the flat fields
    sv = ServingConfig(tiering=TieringOptions(adaptive=True,
                                              replan_every=5))
    ref = JServingConfig(tiering=JTiering(adaptive=True, replan_every=5))
    assert (sv.adaptive, sv.replan_every) == (True, 5)
    assert _sections(sv) == _sections(ref)


def _args(**kw):
    base = dict(scheduler="continuous", adaptive=False, predictive=False,
                calibrate=False, qos=False, topology=None, replicas=1,
                router=None, trace_out=None, fused_gather=False,
                expert_policy=None, tenant=None, slo_p99_decode=None,
                slo_p95_decode=None, batch=4, prompt_len=32, new_tokens=16,
                block_tokens=16, policy="tiering08", num_blocks=None,
                fast_blocks=None, replan_every=8, sample_rate=1.0)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw", [
    dict(predictive=True), dict(calibrate=True),
    dict(scheduler="oneshot", trace_out="t.jsonl"),
    dict(scheduler="oneshot", fused_gather=True),
    dict(qos=True), dict(qos=True, topology="far-socket"),
    dict(replicas=2, fused_gather=True), dict(router="nope"),
    dict(adaptive=True, replan_every=4, trace_out="t.jsonl"),
])
def test_validate_args_matches_reference(kw):
    args = _args(**kw)
    try:
        jvalidate(args)
        want = None
    except JConfigError as e:
        want = str(e)
    try:
        validate_args(args)
        got = None
    except ConfigError as e:
        got = str(e)
    assert got == want
    if got is None:
        sv = ServingConfig.from_args(args)
        assert _sections(sv) == _sections(JServingConfig.from_args(args))


@pytest.mark.parametrize("option,value", [
    pytest.param("cluster", dict(replicas=2, router="round-robin"),
                 id="cluster-value0-item 11"),
])
def test_unported_planes_name_their_roadmap_item(option, value):
    """The cluster plane is ported: its section is accepted as the
    reference's, and a replica's params split over a mesh of two
    devices.  The adaptive, predictive and expert-residency planes build
    over an expert store split across the mesh, the pool one block per
    (layer, expert), as the reference's."""
    from repro.serving import ClusterOptions as JClusterOptions
    from repro_torch.cluster import (axis_mapping, AxisMapping,
                                     shard_lm_params)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.serving import ClusterOptions
    sv = ServingConfig(**{option: ClusterOptions(**value)})
    ref = JServingConfig(**{option: JClusterOptions(**value)})
    assert dataclasses.asdict(sv.cluster) == dataclasses.asdict(ref.cluster)
    cpu = torch.device("cpu")
    two = make_mesh((2,), ("model",), devices=[cpu, cpu])
    placed = shard_lm_params({"embed": torch.zeros(4, 2)}, two,
                             AxisMapping({"vocab": "model"}))
    assert placed["embed"].shard_shapes() == [(2, 2), (2, 2)]
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    with axis_mapping({"experts": "model"}):
        split = shard_lm_params(lm.init_params(cfg, seed=0, device="cpu"),
                                two)
    from repro_torch.serving.expert_pool import moe_layers_from_config
    eng = ServingEngine(cfg, split, ServingConfig(
        fused_gather=True, expert_policy="predictive", adaptive=True,
        predictive=True), device="cpu")
    assert len(eng.expert_pool.kinds) == \
        moe_layers_from_config(cfg) * cfg.n_experts
    assert eng.expert_pool.movesched is eng.movesched is not None
    assert ServingConfig(adaptive=True).adaptive


# ===================================================================== #
# CLI                                                                   #
# ===================================================================== #
def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3-8b", "--smoke", "--scheduler", "continuous", "--device",
         "cpu", "--num-requests", "4", "--new-tokens", "8", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=cwd)


def _cli_in_process(*args, cwd, monkeypatch):
    """The same CLI run in this process (no interpreter start-up)."""
    from repro_torch.launch import serve
    monkeypatch.chdir(cwd)
    serve.main(["--arch", "llama3-8b", "--smoke", "--scheduler",
                "continuous", "--device", "cpu", "--num-requests", "4",
                "--new-tokens", "8", *args])


def _check_artifacts(out: str, cwd: Path) -> None:
    assert "replans=" in out and "slo: decode_latency p95" in out
    events = [json.loads(line) for line in
              (cwd / "t.jsonl").read_text().splitlines()]
    names = {e["name"] for e in events}
    assert {"phase.update", "replan.decision", "sched.admit"} <= names
    chains = [e for e in events if e["name"] == "replan.decision"]
    assert chains and all("epoch" in e["args"] for e in chains)
    prom = (cwd / "m.prom").read_text()
    assert "# TYPE" in prom and "serving_telemetry_replans_considered" \
        in prom and "serving_summary_throughput_tok_s" in prom
    audit = json.loads((cwd / "a.json").read_text())
    assert "replan.step_cost" in audit["audit"]["models"]


ARTIFACTS = ("--adaptive", "--replan-every", "2", "--trace-out", "t.jsonl",
             "--metrics-out", "m.prom", "--audit-out", "a.json",
             "--slo-p95-decode", "1e-4")


def test_cli_writes_obs_artifacts(tmp_path):
    res = _cli(*ARTIFACTS, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    _check_artifacts(res.stdout, tmp_path)


def test_cli_writes_obs_artifacts_fused(tmp_path, monkeypatch, capsys):
    _cli_in_process(*ARTIFACTS, "--fused-gather", cwd=tmp_path,
                    monkeypatch=monkeypatch)
    _check_artifacts(capsys.readouterr().out, tmp_path)


def test_cli_chrome_trace_and_bad_rate(tmp_path, monkeypatch, capsys):
    _cli_in_process("--trace-out", "t.json", cwd=tmp_path,
                    monkeypatch=monkeypatch)
    chrome = json.loads((tmp_path / "t.json").read_text())
    assert chrome["traceEvents"]
    assert "replans=" not in capsys.readouterr().out
    with pytest.raises(SystemExit):
        _cli_in_process("--sample-rate", "0", cwd=tmp_path,
                        monkeypatch=monkeypatch)
    assert "--sample-rate must be in (0, 1]" in capsys.readouterr().err


def test_cli_meets_the_reference_ci_observability_contract(tmp_path):
    """The reference's CI contract for the observability plane
    (``.github/workflows/ci.yml``, "Observability artifacts smoke"),
    run against the port's CLI: a predictive serve leaves a non-empty
    trace holding a replan decision chain, and Prometheus text."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--scheduler", "continuous", "--adaptive",
         "--predictive", "--trace-out", "obs-trace.jsonl",
         "--metrics-out", "obs-metrics.prom"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    from repro_torch.obs import TraceRecorder
    events = TraceRecorder.read_jsonl(str(tmp_path / "obs-trace.jsonl"))
    assert events, "trace artifact is empty"
    chains = replan_chains(events)
    assert any(c["decisions"] for c in chains.values())
    prom = (tmp_path / "obs-metrics.prom").read_text()
    assert "# TYPE" in prom and "serving_" in prom
    assert "prefetches=" in res.stdout and "budget_preemptions=" in \
        res.stdout


def test_cli_topology_qos_printouts(tmp_path, monkeypatch, capsys):
    _cli_in_process("--topology", "far-socket", "--qos",
                    "--slo-p99-decode", "1e-9", cwd=tmp_path,
                    monkeypatch=monkeypatch)
    out = capsys.readouterr().out
    assert "topology vendor-a-far:" in out
    assert "qos: deferrals=" in out and "slo_preemptions=" in out
    assert "slo: decode_latency p99" in out
    with pytest.raises(SystemExit):
        _cli_in_process("--qos", cwd=tmp_path, monkeypatch=monkeypatch)
    assert "--qos requires --topology" in capsys.readouterr().err


def test_cli_expert_policy_printout(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.chdir(tmp_path)
    serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--scheduler",
                "continuous", "--device", "cpu",
                "--num-requests", "3", "--new-tokens", "6",
                "--fused-gather", "--expert-policy", "predictive",
                "--expert-fast-frac", "0.5"])
    out = capsys.readouterr().out
    assert "experts: policy=predictive fast=" in out
    assert "hit_ratio=" in out and "promoted=" in out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--expert-fast-frac",
                    "1.5"])
    assert "--expert-fast-frac must be in [0, 1]" in capsys.readouterr().err
