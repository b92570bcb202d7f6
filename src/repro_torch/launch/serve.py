"""Serving CLI of the port: continuous batching over the paged,
tier-migrating KV pool, on CUDA unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --scheduler continuous --policy tiering08 \\
        --num-requests 6 --device cpu

Only the continuous scheduler is ported; ``--scheduler oneshot`` (the
FlexGen path of ``repro.launch.serve``) raises until ROADMAP queue 1,
item 10 ports it.  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..models import lm


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
    for rid, row in rep.per_request:
        ttft = row.get("ttft_s")
        dec = row.get("decode_tok_s")
        ttft_str = f"{ttft*1e3:.1f} ms" if ttft is not None else "n/a"
        dec_str = f"{dec:.1f} tok/s" if dec is not None else "n/a"
        print(f"  req{rid}: prompt={int(row['prompt_tokens'])} "
              f"new={int(row['new_tokens'])} "
              f"ttft={ttft_str} decode={dec_str} "
              f"preempted={int(row['preemptions'])}x")


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
    args = ap.parse_args(argv)
    if args.scheduler == "oneshot":
        raise NotImplementedError(
            "--scheduler oneshot is not ported to repro_torch yet "
            "(ROADMAP queue 1, item 10)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    params = lm.init_params(cfg, seed=0, device=args.device)
    run_continuous(args, cfg, params)


if __name__ == "__main__":
    main()
