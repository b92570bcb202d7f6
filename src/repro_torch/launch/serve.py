"""Serving CLI of the port: one-shot batch or tier-aware continuous
batching, on CUDA unless ``--device cpu``.

One-shot (FlexGen-style, statically split weights and KV; the default):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --batch 4 --prompt-len 32 --new-tokens 16 \
        --kv-host-frac 0.5 --device cpu

Continuous batching over the paged, tier-migrating KV pool:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --scheduler continuous --policy tiering08 \
        --num-requests 6 --device cpu

Adaptive object-level re-interleaving from observed access telemetry,
with the control-plane trace, the metrics and the audit report written
out:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --scheduler continuous --adaptive --replan-every 8 \
        --trace-out t.jsonl --metrics-out m.prom --audit-out a.json \
        --device cpu

The control planes: the predictive arbiter and move scheduler
(``--predictive``), cost-model calibration (``--calibrate``), a
topology testbed (``--topology``; ``h100-node`` is built from transfer
probes of this machine's memory kinds), interference-class QoS
(``--qos`` with a decode SLO) and MoE expert residency
(``--expert-policy`` on a MoE arch):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --scheduler continuous --adaptive --predictive \
        --calibrate --topology far-socket --qos --slo-p99-decode 1e-3 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --smoke --scheduler continuous \
        --fused-gather --adaptive --predictive --expert-policy predictive \
        --device cpu

A hybrid of Mamba-2 and attention layers, on the fused path, its
recurrent states in per-request slots beside the paged KV pool:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-4.0-h-small --smoke --scheduler continuous \
        --fused-gather --device cpu

The multi-host cluster plane: ``--replicas`` engines, each its own
paged pool, over one shared namespaced ledger, sessions placed by the
``--router`` policy; the replicas' meshes split every CUDA device (on
one card the replicas share it and its weights):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --scheduler continuous --replicas 2 \
        --router headroom-distance --device cpu

Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..configs.registry import PORT_ARCH_IDS
from ..models import lm


def _rate(text: str) -> float:
    """argparse type: a sampling rate in (0, 1]."""
    try:
        val = float(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            f"--sample-rate must be a number, got {text!r}") from e
    if not 0.0 < val <= 1.0:
        raise argparse.ArgumentTypeError(
            f"--sample-rate must be in (0, 1], got {val} (use a small "
            "rate like 1e-6 to minimize profiling, not 0)")
    return val


def _fraction(name: str):
    """argparse type: a float that must land in [0, 1]."""
    def parse(text: str) -> float:
        try:
            val = float(text)
        except ValueError as e:
            raise argparse.ArgumentTypeError(
                f"{name} must be a number, got {text!r}") from e
        if not 0.0 <= val <= 1.0:
            raise argparse.ArgumentTypeError(
                f"{name} must be in [0, 1], got {val}")
        return val
    return parse


def run_oneshot(args, cfg, params) -> None:
    from ..offload.serve_engine import FlexGenEngine, ServeConfig

    w = args.weights_host_frac
    k = args.kv_host_frac
    eng = FlexGenEngine(cfg, params, ServeConfig(
        max_new_tokens=args.new_tokens, prompt_len=args.prompt_len,
        weight_shares=[("device", 1 - w), ("pinned_host", w)],
        kv_shares=[("device", 1 - k), ("pinned_host", k)]),
        device=args.device)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    st = eng.run(prompts)
    print(f"batch={st.batch} prefill={st.prefill_s*1e3:.1f} ms "
          f"decode={st.decode_tok_s:.1f} tok/s "
          f"({st.new_tokens} new tokens/seq; weights {w:.0%} host, "
          f"KV {k:.0%} host)")


def run_continuous(args, cfg, params) -> None:
    from ..serving import ServingConfig, ServingEngine

    sv = ServingConfig.from_args(args)
    eng = ServingEngine(cfg, params, sv, device=args.device)
    rs = np.random.RandomState(0)
    lens = [args.prompt_len, max(args.prompt_len // 2, 4)]
    for i in range(args.num_requests):
        plen = lens[i % len(lens)]
        eng.submit(rs.randint(0, cfg.vocab, (plen,)).astype(np.int32),
                   max_new_tokens=args.new_tokens,
                   arrival_s=i * args.arrival_gap_s)
    t0 = time.perf_counter()
    rep = eng.run()
    wall = time.perf_counter() - t0
    s = rep.summary
    print(f"policy={rep.policy} requests={int(s['requests'])} "
          f"finished={int(s['finished'])} "
          f"iterations={int(s['iterations'])} wall={wall:.2f} s")
    print(f"throughput={s['throughput_tok_s']:.1f} tok/s "
          f"mean_ttft={s['mean_ttft_s']*1e3:.1f} ms "
          f"mean_decode={s['mean_decode_tok_s']:.1f} tok/s/req "
          f"preemptions={int(s['preemptions'])}")
    print(f"kv-pool: blocks={eng.pool.num_blocks} "
          f"fast_budget={eng.pool.fast_block_budget} "
          f"mean_used={s['mean_pool_blocks']:.1f} "
          f"promoted={rep.tiering['promoted']} "
          f"demoted={rep.tiering['demoted']} "
          f"hint_faults={rep.tiering['hint_faults']}")
    t = rep.telemetry
    if t.get("audit.matched", 0.0) > 0:
        acc = {k.split("prediction.accuracy.", 1)[1]: v
               for k, v in sorted(t.items())
               if k.startswith("prediction.accuracy.")}
        print("audit: "
              + f"joins={int(t['audit.matched'])} "
              + " ".join(f"acc[{m}]={v:.2f}" for m, v in acc.items())
              + (f" probes={int(t['calibration.probes'])} "
                 f"obs={int(t['calibration.observations'])}"
                 if args.calibrate else ""))
    print(f"telemetry: events={int(t['trace_events'])} "
          f"samples={int(t['profiling_samples'])} "
          f"overhead={t['profiling_overhead_s']*1e3:.2f} ms "
          f"phase_shifts={int(t['phase_shifts'])}"
          + (f" replans={int(t['replans_applied'])}/"
             f"{int(t['replans_considered'])} "
             f"moved={t['moved_bytes']/1e6:.2f} MB "
             f"denied={t['denied_bytes']/1e6:.2f} MB "
             f"plan_cache_hits={int(t['plan_cache_hits'])}"
             if args.adaptive else "")
          + (f" prefetches={int(t['prefetches'])} "
             f"budget_preemptions={int(t['budget_preemptions'])}"
             if args.predictive else ""))
    if args.expert_policy:
        print(f"experts: policy={args.expert_policy} "
              f"fast={int(t['expert.fast_residents'])} "
              f"hit_ratio={t.get('expert.fast_hit_ratio', 0.0):.2f} "
              f"promoted={int(t['expert.promoted'])} "
              f"demoted={int(t['expert.demoted'])}"
              + (f" prefetch_hit_ratio="
                 f"{t['expert.prefetch_hit_ratio']:.2f}"
                 if "expert.prefetch_hit_ratio" in t else ""))
    for tgt in rep.slo.get("targets", ()):
        rate = tgt.get("violation_rate")
        print(f"slo: {tgt['metric']} "
              f"p{round(tgt['quantile']*100, 4):g} <= "
              f"{tgt['threshold_s']*1e3:.1f} ms -> "
              f"{tgt['violations']} violation(s) over "
              f"{rep.slo['checks']} check(s)"
              + (f" rate={rate:.2f}" if rate is not None else ""))
    if args.qos:
        blame = rep.slo.get("blame", {})
        print(f"qos: deferrals={int(t['qos_deferrals'])} "
              f"slo_preemptions={int(t['slo_preemptions'])} "
              f"excursions={blame.get('total_excursions', 0)}"
              + (f" antagonist={blame['top_antagonist']} "
                 f"link={blame['top_link']}"
                 if blame.get("top_antagonist") else ""))
    for rid, row in rep.per_request:
        ttft = row.get("ttft_s")
        dec = row.get("decode_tok_s")
        ttft_str = f"{ttft*1e3:.1f} ms" if ttft is not None else "n/a"
        dec_str = f"{dec:.1f} tok/s" if dec is not None else "n/a"
        print(f"  req{rid}: prompt={int(row['prompt_tokens'])} "
              f"new={int(row['new_tokens'])} "
              f"ttft={ttft_str} decode={dec_str} "
              f"preempted={int(row['preemptions'])}x")
    _write_obs_artifacts(args, eng)


def run_cluster(args, cfg, params):
    """Multi-host plane: route the trace across ``--replicas`` engines.
    Returns the plane, run."""
    from ..cluster import ClusterPlane
    from ..serving import ServingConfig

    sv = ServingConfig.from_args(args)
    plane = ClusterPlane(
        cfg, params, serving=sv, n_replicas=args.replicas,
        router_policy=args.router or "headroom-distance",
        devices=None if args.device == "cuda" else [args.device])
    for line in plane.testbed.describe():
        print(line)
    rs = np.random.RandomState(0)
    lens = [args.prompt_len, max(args.prompt_len // 2, 4)]
    for i in range(args.num_requests):
        plen = lens[i % len(lens)]
        plane.submit(rs.randint(0, cfg.vocab, (plen,)).astype(np.int32),
                     args.new_tokens, arrival_s=i * args.arrival_gap_s)
    t0 = time.perf_counter()
    rep = plane.run()
    wall = time.perf_counter() - t0
    s = rep.summary
    print(f"cluster: replicas={int(s['replicas'])} "
          f"router={plane.router.policy} "
          f"requests={int(s['requests'])} "
          f"finished={int(s['finished'])} wall={wall:.2f} s")
    print(f"aggregate: throughput={s['throughput_tok_s']:.1f} tok/s "
          f"worst_p95_latency={s['worst_p95_latency_s']*1e3:.1f} ms "
          f"preemptions={int(s['preemptions'])}")
    for host, n in sorted(rep.routed.items()):
        rsum = getattr(rep.per_replica.get(host), "summary", {})
        print(f"  {host}: routed={n} "
              f"throughput={rsum.get('throughput_tok_s', 0.0):.1f} tok/s "
              f"fast_headroom={plane.replicas[host].fast_headroom_bytes()}"
              f" B dist={plane.testbed.distance_ns('router', host):.0f} ns")
    cons = plane.namespace_conservation()
    total = cons.pop("total")
    if sum(cons.values()) != total:
        raise RuntimeError(f"namespace aggregation leaked: {cons} sum to "
                           f"{sum(cons.values())}, not {total}")
    print(f"ledger: tenants={sorted(str(t) for t in plane.ledger.tenants)}"
          f" fast_bytes_by_replica={cons} (sum == replica/* aggregate)")
    if args.trace_out:
        events = [ev.to_dict() for ev in plane.merged_trace()]
        with open(args.trace_out, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")
        print(f"trace: wrote {len(events)} merged events -> "
              f"{args.trace_out}")
        _report_trace_drops([plane.tracer] + [
            plane.replicas[h].engine.tracer for h in plane.testbed.hosts])
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(plane.registry.to_prometheus_text())
        print(f"metrics: wrote {len(plane.registry.names())} series "
              f"(prometheus text) -> {args.metrics_out}")
    return plane


def _report_trace_drops(tracers) -> None:
    """Say so where a trace's rings were full and evicted their oldest
    events: the written trace then starts later than the run."""
    events = sum(t.dropped for t in tracers)
    spans = sum(t.spans_dropped for t in tracers)
    if events or spans:
        print(f"trace: WARNING the rings were full and evicted the "
              f"oldest {events} control-plane events and {spans} spans")


def _write_obs_artifacts(args, eng) -> None:
    """--trace-out / --metrics-out / --audit-out exports of a run."""
    if args.trace_out:
        if args.trace_out.endswith(".jsonl"):
            n = eng.tracer.to_jsonl(args.trace_out)
            kind = "jsonl"
        else:
            n = eng.tracer.to_chrome(args.trace_out)
            kind = "chrome trace_event"
        print(f"trace: wrote {n} events ({kind}) -> {args.trace_out}")
        _report_trace_drops([eng.tracer])
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(eng.registry.to_prometheus_text())
        print(f"metrics: wrote {len(eng.registry.names())} series "
              f"(prometheus text) -> {args.metrics_out}")
    if args.audit_out:
        with open(args.audit_out, "w") as fh:
            json.dump(eng.audit_report(), fh, indent=2, sort_keys=True)
        print(f"audit: wrote prediction residual report -> "
              f"{args.audit_out}")


def parse_args(argv=None) -> argparse.Namespace:
    """The serve CLI's arguments, every cross-field rule checked
    (``serving.config.validate_args``; a violation exits with usage)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    choices=ARCH_IDS + PORT_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--weights-host-frac",
                    type=_fraction("--weights-host-frac"), default=0.0,
                    help="fraction of weights resident on the host tier")
    ap.add_argument("--kv-host-frac",
                    type=_fraction("--kv-host-frac"), default=0.0,
                    help="fraction of the KV cache on the host tier")
    ap.add_argument("--scheduler", choices=["oneshot", "continuous"],
                    default="oneshot",
                    help="oneshot = FlexGen batch; continuous = "
                         "paged-KV continuous batching")
    ap.add_argument("--policy", default="tiering08",
                    choices=["static", "autonuma", "tiering08", "tpp"],
                    help="KV-block tiering policy (continuous only)")
    ap.add_argument("--num-requests", type=int, default=6)
    ap.add_argument("--arrival-gap-s", type=float, default=0.0)
    ap.add_argument("--block-tokens", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="total KV pool blocks (default: sized to batch)")
    ap.add_argument("--fast-blocks", type=int, default=None,
                    help="fast-tier (device) block budget")
    ap.add_argument("--tenant", default=None,
                    help="residency-ledger tenant namespace (default: "
                         "serving)")
    ap.add_argument("--fused-gather", action="store_true",
                    help="fused decode: attention reads blocks straight "
                         "from the pooled KV layout through block tables")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive object-level re-interleaving from "
                         "observed access telemetry")
    ap.add_argument("--replan-every", type=int, default=8,
                    help="scheduler iterations between adaptive replans")
    ap.add_argument("--predictive", action="store_true",
                    help="predictive control plane: key replans by "
                         "phase recurrence signature, pre-stage the "
                         "proven plan of a predicted next phase, "
                         "rebalance the fast-tier grant and schedule "
                         "moves in rounds (requires --adaptive)")
    ap.add_argument("--calibrate", action="store_true",
                    help="self-calibrating cost model: probe the pool's "
                         "slow kind at start-up and keep correcting "
                         "planning bandwidths online from prediction-"
                         "audit residuals (requires --adaptive)")
    from ..topology import TOPOLOGY_CHOICES
    ap.add_argument("--topology", default=None,
                    choices=list(TOPOLOGY_CHOICES),
                    help="budget shared links in admission and (with "
                         "--adaptive) price placements over this machine "
                         "topology; h100-node is built from transfer "
                         "probes of this machine's memory kinds")
    ap.add_argument("--qos", action="store_true",
                    help="interference-class QoS plane: blame ledger "
                         "naming the noisy neighbour per tail excursion "
                         "and violation-predictive admission (requires "
                         "--topology and a decode SLO)")
    ap.add_argument("--expert-policy", default=None,
                    choices=["lru", "predictive"],
                    help="MoE expert tier residency: experts become "
                         "tiered objects with routing-driven heat; "
                         "predictive also prefetches the predicted next "
                         "phase's hot experts (MoE arch; the routing "
                         "feed comes from --fused-gather)")
    ap.add_argument("--expert-fast-frac",
                    type=_fraction("--expert-fast-frac"), default=0.25,
                    help="share of experts that may be fast-resident")
    ap.add_argument("--sample-rate", type=_rate, default=1.0,
                    help="telemetry sampling rate (fraction of cache "
                         "lines; 1.0 = full instrumentation)")
    ap.add_argument("--trace-out", default=None,
                    help="write the control-plane trace and the "
                         "engine's hot-path spans here after the run: "
                         ".jsonl = one event per line, anything else = "
                         "Chrome trace_event JSON")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry as Prometheus text "
                         "exposition here")
    ap.add_argument("--audit-out", default=None,
                    help="write the prediction-audit residual report "
                         "(JSON) here")
    ap.add_argument("--slo-p95-ttft", type=float, default=None,
                    help="live SLO target: p95 TTFT threshold (s)")
    ap.add_argument("--slo-p95-decode", type=float, default=None,
                    help="live SLO target: p95 inter-token decode "
                         "latency threshold (s)")
    ap.add_argument("--slo-p99-decode", type=float, default=None,
                    help="live SLO target: p99 inter-token decode "
                         "latency threshold (s)")
    ap.add_argument("--slo-p999-decode", type=float, default=None,
                    help="live SLO target: p99.9 inter-token decode "
                         "latency threshold (s); the window grows to "
                         "hold its 1/(1-q) warmup")
    ap.add_argument("--slo-window", type=int, default=512,
                    help="rolling SLO window size in samples")
    ap.add_argument("--replicas", type=int, default=1,
                    help="multi-host serving plane: this many replica "
                         "engines, one paged pool each, sharing one "
                         "namespaced residency ledger (continuous only; "
                         "meshes over every CUDA device; on one card "
                         "the replicas share its weights)")
    from ..serving.config import ROUTER_POLICIES
    ap.add_argument("--router", default=None,
                    choices=list(ROUTER_POLICIES),
                    help="session-placement policy for --replicas > 1 "
                         "(default: headroom-distance: fast-tier "
                         "headroom first, front-end distance as the "
                         "tiebreak)")
    args = ap.parse_args(argv)
    from ..serving.config import ConfigError, validate_args
    try:
        validate_args(args)
    except ConfigError as e:
        ap.error(str(e))
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.topology:
        from ..topology import build_topology
        for line in build_topology(args.topology,
                                   device=args.device).describe():
            print(line)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    params = lm.init_params(cfg, seed=0, device=args.device)
    if args.scheduler == "continuous" and args.replicas > 1:
        run_cluster(args, cfg, params)
    elif args.scheduler == "continuous":
        run_continuous(args, cfg, params)
    else:
        run_oneshot(args, cfg, params)


if __name__ == "__main__":
    main()
