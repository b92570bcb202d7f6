"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run
of one cell, printed as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``perfbench/metrics/<name>.py``),
read from a run under the profiler.  A run without a CUDA card, or with
fewer cards than the cell asks for, fails; so does one whose process
holds a module of the JAX stack or of the JAX package once the window
has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # one host thread in each pool: the serving loop is one Python
    # thread, and pool threads that spin take cores from it
    for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_v] = "1"
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell, out) -> dict:
    got = {}
    for spec in cell["per_layer"]:
        mod = harness.reader(spec["name"])
        if mod.UNIT != spec["unit"]:
            raise ValueError(f"{spec['name']}: reader unit {mod.UNIT!r}, "
                             f"BENCHMARK.json {spec['unit']!r}")
        v = mod.read(out)
        if v is not None:
            got[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    return got


def main(argv=None, device: str = "cuda", cell=None) -> int:
    """``device`` and ``cell`` are for tests on the CPU, which drive a
    whole run but the look for a card at a small size."""
    args = parse(argv)
    harness.set_environment()
    cell = cell or harness.cell(args.workload)
    import torch
    if device == "cuda" and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    drv = harness.driver(cell["config"]["driver"])
    out = drv.run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                  device=device)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {bad}: the benchmark may load none of "
              f"{harness.FORBIDDEN}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = per_layer(cell, out)
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        result["breakdown"] = out.trace["breakdown"]
    harness.emit(result, out.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
