#!/usr/bin/env python3
"""Times the port's serving kernels of several source trees in turns on
one GPU, with ``chip_smoke.py``'s own kernel checks.

    python3 tools/kernel_ab.py OLD . . OLD

Each argument is a checkout of this repository (for example the parent
commit, ``git archive``d into ``build/``).  Each runs in a child process
of its own, in the order given, that imports ``repro_torch`` from that
tree's ``src/`` (and builds that tree's kernels into its
``build/kernels``), warms the card for a second, and then runs this
tree's ``chip_smoke.attention_kernels`` at KV 8 and KV 4,
``chip_smoke.expert_kernel`` and ``chip_smoke.expert_range_kernel``
(row ``fused_expert_ffn@4 expert ranges``, each range's ``device_ms``
printed under it): every kernel held against its plain version and
timed cold beside its library call, both as ``ms`` (host time of a
wrapper that the L2-evicting write does not hide included) and as
``device_ms`` (the card's time alone).  Those functions call the
wrappers only, whose signatures are those of every tree since the
port's first slice (the range form's since its 13th), so the trees are
measured by one yardstick.  Then the expert kernel's two passes
(``expert_up_kernel``, ``expert_down_kernel``, the names of both
designs) are timed apart under ``torch.profiler``, whole and over the
first quarter of the experts, each against the weight bytes it reads.
Prints the card, one JSON line per run and a table.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("ms", "device_ms", "library_ms", "library_device_ms")
RANGE_ROW = "fused_expert_ffn@4 expert ranges"
PASSES = ("expert_up_kernel", "expert_down_kernel")
PASS_CALLS = 20


def expert_passes(cs, gen) -> dict:
    """Device ms per launch of each pass of the expert kernel, read by
    ``torch.profiler`` over ``PASS_CALLS`` calls that each follow an
    L2-evicting write, whole and over the experts [0, E / 4) on
    ``chip_smoke.expert_inputs``; beside each, the weight bytes the pass
    reads (its in-range slots' matrices: two of D x F up, one down) and
    the rate they give."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.tiered_gather import (fused_expert_ffn,
                                                   fused_expert_ffn_partial)
    x, wg, wu, wd, ids, wts = cs.expert_inputs(gen)
    E, D, F = wg.shape[0], wg.shape[1], wg.shape[2]
    q = E // 4
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=x.device)
    out = {}
    for label, hi, call in (
            ("whole", E, lambda: fused_expert_ffn(x, wg, wu, wd, ids, wts)),
            (f"range [0, {q})", q, lambda: fused_expert_ffn_partial(
                x, wg[:q], wu[:q], wd[:q], ids, wts, 0, q, E))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PASS_CALLS):
                flush.zero_()
                call()
            torch.cuda.synchronize()
        slots = int((ids < hi).sum())
        row = {"slots": slots}
        for name, mats in zip(PASSES, (2, 1)):
            evs = [e for e in prof.key_averages() if name in e.key]
            ms = (sum(e.self_device_time_total for e in evs)
                  / max(1, sum(e.count for e in evs)) / 1e3)
            nbytes = slots * mats * D * F * 2
            row[name] = {"device_ms": ms, "weight_bytes": nbytes,
                         "tb_s": nbytes / ms / 1e9 if ms else None}
        out[label] = row
    return out


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != tree:
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs    # after repro_torch: it keeps the tree's
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        flush.zero_()
        torch.cuda.synchronize()
    del flush
    rows = {}
    for KV in (8, 4):
        for name, row in cs.attention_kernels(dev, gen, KV).items():
            rows[f"{name}@KV{KV}"] = row
            if "L2048" in row:
                rows[f"{name}@KV{KV} L2048"] = row["L2048"]
    rows["fused_expert_ffn"] = cs.expert_kernel(dev, gen)
    rows[RANGE_ROW] = cs.expert_range_kernel(dev, gen)
    return {"tree": str(tree), "rows": {
        name: {k: row[k] for k in FIELDS + ("max_abs_err",)}
        for name, row in rows.items()},
        "ranges": [{k: r[k] for k in ("lo", "hi", "slots", "distinct_experts",
                                      "ms", "device_ms")}
                   for r in rows[RANGE_ROW]["ranges"]],
        "passes": expert_passes(cs, gen)}


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    trees = [Path(a).resolve() for a in sys.argv[1:]]
    if not trees:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in trees:
        res = subprocess.run([sys.executable, __file__, "--child",
                              str(tree)], capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"kernel_ab: {tree} failed")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(f"{'row':34s} {'tree':24s} " + " ".join(f"{f:>17s}" for f in FIELDS)
          + f" {'max err':>8s}")
    for name in runs[0]["rows"]:
        for run in runs:
            r = run["rows"][name]
            print(f"{name:34s} {run['tree'][-24:]:24s} "
                  + " ".join("{:17s}".format("none" if r[f] is None
                                             else f"{r[f]:.5f}")
                             for f in FIELDS)
                  + f" {r['max_abs_err']:8.2g}")
            if name == RANGE_ROW:
                print(f"{'':34s} {'':24s} per range device_ms "
                      + " ".join(f"[{p['lo']},{p['hi']}) "
                                 f"{p['device_ms']:.5f}"
                                 for p in run["ranges"]))
    print(f"{'pass':34s} {'tree':24s} {'slots':>5s} {'device_ms':>10s} "
          f"{'weight MB':>10s} {'TB/s':>6s}")
    for label in runs[0]["passes"]:
        for name in PASSES:
            for run in runs:
                p = run["passes"][label]
                r = p[name]
                print(f"{label + ' ' + name:34s} {run['tree'][-24:]:24s} "
                      f"{p['slots']:5d} {r['device_ms']:10.5f} "
                      f"{r['weight_bytes'] / 1e6:10.2f} "
                      + ("  none" if r["tb_s"] is None
                         else f"{r['tb_s']:6.3f}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
