#!/usr/bin/env python3
"""Peak device memory of the training launcher with the plain AdamW
update in row chunks of at most ``optim.adam.CHUNK_ELEMS`` elements (the
port's code) and with every leaf updated whole in one call.

    python3 tools/adam_chunk_peak.py

Runs, from the repository root on a machine with one GPU, the launcher
as ``chip_smoke.py``'s launcher phase runs it (``LAUNCHER_ARCH`` at full
width and depth, 8 x 128 tokens, ``--adaptive --replan-every 2``,
``LAUNCHER_STEPS`` steps), once per mode, each in a child process of its
own: chunked, whole, whole, chunked.  Prints the card's name and power
limit, then one JSON line per run: the peak of
``torch.cuda.max_memory_allocated`` over the run, the largest leaf and
the wall seconds, or that the run ran out of device memory.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("chunked", "whole", "whole", "chunked")


def child(mode: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adam
    if mode == "whole":
        adam._chunked = (lambda update, ma, m, v, g, scale, kw:
                         update(ma, m, v, g.float() * scale, **kw))
    args = train_cli.parse_args([
        "--arch", cs.LAUNCHER_ARCH, "--steps", str(cs.LAUNCHER_STEPS),
        "--batch", "8", "--seq", "128", "--adaptive", "--replan-every",
        "2", "--lr", repr(cs.launcher_lr(cs.LAUNCHER_ARCH))])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = train_cli.run(args)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        return {"mode": mode, "out_of_memory": str(e).splitlines()[0],
                "peak_allocated": torch.cuda.max_memory_allocated()}
    largest = max(torch.utils._pytree.tree_leaves(res.opt["master"]),
                  key=lambda t: t.numel())
    return {"mode": mode, "peak_allocated": torch.cuda.max_memory_allocated(),
            "largest_leaf": list(largest.shape),
            "largest_leaf_elems": largest.numel(),
            "chunk_elems": adam.CHUNK_ELEMS,
            "wall_s": time.perf_counter() - t0,
            "losses": res.losses}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    for mode in MODES:
        out = subprocess.run([sys.executable, __file__, "--child", mode],
                             capture_output=True, text=True, cwd=ROOT)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
