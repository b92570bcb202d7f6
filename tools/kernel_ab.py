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

    python3 tools/kernel_ab.py --ssm

times the Mamba-2 decode state update (``kernels/ops.py
ssm_state_update``) at granite-4.0-h-small's heads (128 of P 64, N
128, one group) over 65 slots at 1, 8, 32 and 64 rows in permuted
slots through ``chip_smoke.ssm_kernels``, cold as ``chip_smoke.time_ms``
times (``ms``, ``device_ms``), beside its plain version's ``ms`` and its
bound (the state read and written once, ``perfbench/costs/hybrid.py``);
each call checked against the plain version first.

    python3 tools/kernel_ab.py --moe-layer

times one prefill MoE layer (``models/modules.py::moe_fwd``) of this
tree at qwen3-moe-30b-a3b's widths and the serving cell's routing (D
2048, 128 experts of F 768, top-8, capacity 1.25, 32 groups) at N 1020
and 5003 tokens, with autograd off as serving runs it, its plain path
(``kernels.ops.moe_bucket_*`` swapped for their plain versions in
``kernels/ref.py``) against its kernel path (the ``moe_bucket_*``
kernels) in turns: per call the wall ms (the host's enqueue and the
card's tail, median and range over ``MOE_ROUNDS`` turns), and from one
call under ``torch.profiler`` the operations the card ran and their
summed device ms, and the device ms of the kernel path's memset and
three kernels; the two paths' outputs must agree bit for bit.  Then,
under ``torch.profiler``, ``FLASH_ROUNDS`` times the layer on each
path followed by ``flash_attention`` over as many tokens (32 heads, 4
KV heads of 128, causal), and as many flash calls back to back: the
median device us of flash's kernel after each path and alone, which
says whether a path's buffers slow the attention that follows.
"""
from __future__ import annotations

import contextlib
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
MOE_TOKENS = (1020, 5003)
MOE_ROUNDS = 6
# the kernel path's own device operations (the scatter's memset first)
MOE_BUCKET_OPS = ("Memset", "moe_bucket_positions_kernel",
                  "moe_bucket_scatter_kernel", "moe_bucket_combine_kernel")
FLASH_ROUNDS = 10


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


def moe_layer() -> dict:
    """The ``--moe-layer`` rows: {N: {path: {wall_ms, device_ms, ops,
    flash_after_us}}, with ``flash_alone_us`` beside the paths}."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops, ref
    from repro_torch.models import modules as M

    @contextlib.contextmanager
    def plain_bucket():
        """``moe_fwd``'s dispatch and combine as their plain versions."""
        plain = {"moe_bucket_positions":
                 lambda topi, E, xt: ref.moe_bucket_positions(topi, E),
                 "moe_bucket_scatter": ref.moe_bucket_scatter,
                 "moe_bucket_combine": ref.moe_bucket_combine}
        saved = {name: getattr(ops, name) for name in plain}
        try:
            for name, fn in plain.items():
                setattr(ops, name, fn)
            yield
        finally:
            for name, fn in saved.items():
                setattr(ops, name, fn)

    def device_events(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def flash_us(events):
        return statistics.median(e.time_range.elapsed_us() for e in events
                                 if "flash_attention_kernel" in e.name)

    D, E, F = 2048, 128, 768
    kw = dict(top_k=8, capacity_factor=1.25, n_groups=32, act="silu")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rnd(*shape, std):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)

    p = {"router": torch.randn(D, E, generator=gen, device="cuda")
         * D ** -0.5, "w_gate": rnd(E, D, F, std=D ** -0.5),
         "w_up": rnd(E, D, F, std=D ** -0.5),
         "w_down": rnd(E, F, D, std=F ** -0.5)}
    paths = {"plain": plain_bucket, "kernel": contextlib.nullcontext}
    rows = {}
    for N in MOE_TOKENS:
        x = rnd(1, N, D, std=1.0)
        q = rnd(1, N, 32, 128, std=1.0)
        k, v = rnd(1, N, 4, 128, std=1.0), rnd(1, N, 4, 128, std=1.0)

        def call(path):
            with paths[path](), torch.no_grad():
                return M.moe_fwd(p, x, **kw)[0]

        def layer_then_flash(path):
            for _ in range(FLASH_ROUNDS):
                call(path)
                ops.flash_attention(q, k, v, causal=True)

        outs = {path: call(path) for path in paths}   # builds, warms
        if not torch.equal(outs["plain"].view(torch.int16),
                           outs["kernel"].view(torch.int16)):
            raise SystemExit(f"moe layer N {N}: the paths' outputs differ")
        walls = {path: [] for path in paths}
        for r in range(MOE_ROUNDS):
            for path in (("plain", "kernel") if r % 2 == 0
                         else ("kernel", "plain")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(path)
                torch.cuda.synchronize()
                walls[path].append((time.perf_counter() - t0) * 1e3)
        row = {}
        for path in paths:
            ran = device_events(lambda: call(path))
            row[path] = {
                "wall_ms": statistics.median(walls[path]),
                "wall_ms_range": [min(walls[path]), max(walls[path])],
                "device_ms": sum(e.time_range.elapsed_us()
                                 for e in ran) / 1e3,
                "ops": len(ran),
                "bucket_device_ms": {
                    name: sum(e.time_range.elapsed_us() for e in ran
                              if name in e.name) / 1e3
                    for name in MOE_BUCKET_OPS},
                "flash_after_us": flash_us(device_events(
                    lambda: layer_then_flash(path)))}
        row["flash_alone_us"] = flash_us(device_events(lambda: [
            ops.flash_attention(q, k, v, causal=True)
            for _ in range(FLASH_ROUNDS)]))
        rows[N] = row
    return rows


SSM_ROWS = (1, 8, 32, 64)


def ssm_kernel() -> dict:
    """The ``--ssm`` rows, ``chip_smoke.ssm_kernels`` at ``SSM_ROWS``:
    {rows: {ms, device_ms, plain_ms, bound_ms, max_abs_err}}."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    rows = cs.ssm_kernels(gen, SSM_ROWS)
    return {B: {k: rows[f"ssm_state_update@B{B}"][k]
                for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                          "max_abs_err")}
            for B in SSM_ROWS}


def ssm_main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rows = ssm_kernel()
    print(json.dumps(rows), flush=True)
    for B, r in rows.items():
        print(f"rows {B:3d}: ms {r['ms']:.4f} device_ms {r['device_ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({100 * r['bound_ms'] / r['device_ms']:.1f}% of it) "
              f"max err {r['max_abs_err']:.2e}")
    return 0


def moe_layer_main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rows = moe_layer()
    print(json.dumps(rows), flush=True)
    print(f"{'N':>5s} {'path':7s} {'wall ms':>9s} {'range':>19s} "
          f"{'device ms':>10s} {'ops':>5s}")
    for N, row in rows.items():
        for path in ("plain", "kernel"):
            r = row[path]
            lo, hi = r["wall_ms_range"]
            print(f"{N:5d} {path:7s} {r['wall_ms']:9.3f} "
                  f"{lo:9.3f}-{hi:9.3f} {r['device_ms']:10.3f} "
                  f"{r['ops']:5d} flash after {r['flash_after_us']:.1f} us "
                  + " ".join(f"{k} {v:.4f}" for k, v in
                             r["bucket_device_ms"].items() if v))
        print(f"{N:5d} flash alone {row['flash_alone_us']:.1f} us")
    return 0


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
    if sys.argv[1:] == ["--moe-layer"]:
        return moe_layer_main()
    if sys.argv[1:] == ["--ssm"]:
        return ssm_main()
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
