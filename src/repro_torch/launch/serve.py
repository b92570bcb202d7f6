"""Serving CLI of the port: continuous batching over the paged,
tier-migrating KV pool, on CUDA unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --scheduler continuous --policy tiering08 \\
        --num-requests 6 --device cpu

Adaptive object-level re-interleaving from observed access telemetry,
with the control-plane trace, the metrics and the audit report written
out:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --scheduler continuous --adaptive --replan-every 8 \\
        --trace-out t.jsonl --metrics-out m.prom --audit-out a.json \\
        --device cpu

Only the continuous scheduler is ported; ``--scheduler oneshot`` (the
FlexGen path of ``repro.launch.serve``) raises until ROADMAP queue 1,
item 7 ports it.  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..configs import ARCH_IDS, get_config, get_smoke_config
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
    print(f"telemetry: events={int(t['trace_events'])} "
          f"samples={int(t['profiling_samples'])} "
          f"overhead={t['profiling_overhead_s']*1e3:.2f} ms "
          f"phase_shifts={int(t['phase_shifts'])}"
          + (f" replans={int(t['replans_applied'])}/"
             f"{int(t['replans_considered'])} "
             f"moved={t['moved_bytes']/1e6:.2f} MB "
             f"denied={t['denied_bytes']/1e6:.2f} MB "
             f"plan_cache_hits={int(t['plan_cache_hits'])}"
             if args.adaptive else ""))
    for tgt in rep.slo.get("targets", ()):
        rate = tgt.get("violation_rate")
        print(f"slo: {tgt['metric']} "
              f"p{round(tgt['quantile']*100, 4):g} <= "
              f"{tgt['threshold_s']*1e3:.1f} ms -> "
              f"{tgt['violations']} violation(s) over "
              f"{rep.slo['checks']} check(s)"
              + (f" rate={rate:.2f}" if rate is not None else ""))
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--scheduler", choices=["oneshot", "continuous"],
                    default="continuous",
                    help="continuous = paged-KV continuous batching; "
                         "oneshot is not ported yet")
    ap.add_argument("--policy", default="tiering08",
                    choices=["static", "autonuma", "tiering08", "tpp"],
                    help="KV-block tiering policy")
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
    ap.add_argument("--sample-rate", type=_rate, default=1.0,
                    help="telemetry sampling rate (fraction of cache "
                         "lines; 1.0 = full instrumentation)")
    ap.add_argument("--trace-out", default=None,
                    help="write the control-plane trace here after the "
                         "run: .jsonl = one event per line, anything "
                         "else = Chrome trace_event JSON")
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
    args = ap.parse_args(argv)
    if args.scheduler == "oneshot":
        raise NotImplementedError(
            "--scheduler oneshot is not ported to repro_torch yet "
            "(ROADMAP queue 1, item 7)")
    from ..serving.config import ConfigError, validate_args
    try:
        validate_args(args)
    except ConfigError as e:
        ap.error(str(e))
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    params = lm.init_params(cfg, seed=0, device=args.device)
    run_continuous(args, cfg, params)


if __name__ == "__main__":
    main()
