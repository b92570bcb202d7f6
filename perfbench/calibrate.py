"""The readings a cell's limit is set from, on the card at the cell's own
size and load, many seeds in one process:

  * the program's reading of the compared number on each seed (a short
    window at the cell's own load and warm-up, then the run's own
    check);
  * the control's, on the same runs: the plain reference computed one
    precision below the configuration's (products in float8 e4m3),
    teacher-forced on the program's prompts and served tokens, whose
    first-ranked token at each served position is put in the program's
    place and judged by the run's own check and ``Outcome.correct``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 15

Prints one JSON line per seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def ints(s: str):
    return [int(x) for x in s.split(",") if x]


def show(**kw) -> None:
    print(json.dumps(kw), flush=True)


def control(drv, cell, out, keep, device) -> dict:
    """The control's tokens in the program's place, through the check."""
    import torch

    from perfbench.reference import qwen3_moe as ref
    m = cell["config"]["model"]
    sample = keep["sample"]
    seqs, _ = drv.sequences(sample, device)
    with torch.no_grad():
        toks = [c.argmax(dim=-1) for c in ref.served_logits(
            keep["w"], m, seqs, [len(r.prompt) for r in sample], fp8=True)]
    checks = drv.check(keep["w"], m, sample,
                       cell["traffic"]["check"]["served_logit_gap_mean"],
                       served=toks)
    judged = dataclasses.replace(out, checks=checks)
    return {"correct": judged.correct,
            **{k: v["value"] for k, v in checks.items()}}


def main(argv=None, device="cuda", cell=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = cell or harness.cell(args.workload)
    import torch
    drv = harness.driver(cell["config"]["driver"])
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        keep = {}
        t0 = time.perf_counter()
        out = drv.run(cell, seed, args.seconds, False, t0, device=device,
                      keep=keep)
        row = {"seed": seed, "correct": out.correct,
               "program": {k: v["value"] for k, v in out.checks.items()},
               "sample": out.ctx["sample"], "e2e": out.e2e}
        if seed in args.control_seeds:
            row["control"] = control(drv, cell, out, keep, device)
        row["seconds"] = time.perf_counter() - t0
        show(**row)
        del keep, out
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
