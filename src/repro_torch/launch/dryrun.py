"""Multi-pod dry-run: trace and cost every (arch x shape x mesh) cell
(counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all

Runs on the CPU and needs no GPU: each cell's step is traced over fake
tensors at its full shapes (``launch.specs``) on a production mesh over
placeholder devices (``launch.mesh.placeholder_devices``), and costed by
the aten walker (``launch.jaxpr_cost``) with an H100's roofline
constants (``launch.hlo_analysis``).  Unlike the reference, the port
sets no environment variable: the mesh needs no devices, so importing
this module is safe.

The reference lowers and compiles each cell with XLA; the port cannot,
so the artifact's ``memory_analysis``, ``cost_analysis_raw``,
``collectives`` and ``memory_structural.saved_stacks`` each hold only a
``"reason"`` saying why they are absent.  Per cell this produces a JSON
artifact with:
  * memory_structural (per-device argument bytes, from each leaf's
    shard shape under its partition spec),
  * jaxpr_cost_global / jaxpr_cost_vmem_fused (FLOPs and bytes, exact
    trips; the fused one with the on-chip residency budget
    ``FUSED_BUDGET_BYTES``),
  * the roofline terms of both + the dominant bottleneck.
Artifacts go to ``experiments/dryrun_torch/`` (never the reference's
``experiments/dryrun/``, which ``benchmarks/roofline.py`` reads).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

from ..configs.base import SHAPES
from ..configs.registry import ASSIGNED_ARCHS, assigned_cells
from ..models import shardings as sh
from ..optim import adam
from . import hlo_analysis as H
from . import jaxpr_cost as JC
from .mesh import make_production_mesh, placeholder_devices
from .specs import build_cell

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
# the on-chip residency budget of the fused cost: an H100's L2 (50 MB)
FUSED_BUDGET_BYTES = H.L2_BYTES
NO_COMPILE = ("the port traces with make_fx and compiles nothing: no "
              "XLA executable to ask")
ABSENT = {
    "memory_analysis": NO_COMPILE + " for its buffer assignment",
    "cost_analysis_raw": NO_COMPILE + " for its cost analysis "
                         "(jaxpr_cost_global holds the walker's count)",
    "collectives": "no partitioned program: the port places nothing over "
                   "more than one device (ROADMAP queue 1, item 11), so "
                   "there are no collectives to parse",
    "saved_stacks": NO_COMPILE + " for the scan stacks "
                    "(dynamic-update-slice buffers) it saves",
}


def _shard_bytes(t, spec, sizes) -> int:
    """Bytes of one device's shard of ``t`` under ``spec``."""
    if not hasattr(t, "shape"):
        return 0
    shape = list(t.shape)
    for i, ax in enumerate(tuple(spec)[:len(shape)]):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                shape[i] //= sizes[a]
    return math.prod(shape) * t.element_size()


def argument_bytes_per_dev(cell, mesh) -> int:
    """Per-device bytes of the cell's arguments: each leaf's shard shape
    under its partition spec."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = []
    for args, specs in zip(cell.args, cell.specs):
        sh._map_with_path(lambda path, t, s: total.append(
            _shard_bytes(t, s, sizes)), args, specs)
    return sum(total)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             adam_cfg: adam.AdamConfig | None = None,
             save: bool = True, verbose: bool = True) -> dict:
    mesh_tag = "multipod" if multi_pod else "singlepod"
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=placeholder_devices(512))
    n_chips = mesh.size
    cell = build_cell(arch, shape_name, mesh, adam_cfg=adam_cfg)
    gm = JC.trace(cell.fn, *cell.args)

    arg_bytes = argument_bytes_per_dev(cell, mesh)
    structural = {
        "argument_bytes_per_dev": arg_bytes,
        "saved_stacks": {"reason": ABSENT["saved_stacks"]},
        "structural_total_per_dev": arg_bytes,
    }
    mf = H.model_flops_estimate(cell.model_cfg, cell.shape)
    # exact-trip-count global flops/bytes from the traced program
    w = JC.walk_graph(gm)
    jc = {JC.FLOPS: w.flops, JC.BYTES: w.bytes}
    # residency model: tensors that fit the on-chip budget stay there
    wf = JC.walk_graph(gm, vmem_bytes=FUSED_BUDGET_BYTES, n_chips=n_chips)
    jc_fused = {JC.FLOPS: wf.flops, JC.BYTES: wf.bytes}
    stats = H.CollectiveStats()
    roof = H.roofline_terms(jc["flops"], jc["bytes"], stats, n_chips, mf)
    roof_fused = H.roofline_terms(jc_fused["flops"], jc_fused["bytes"],
                                  stats, n_chips, mf)

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "n_chips": n_chips, "step": cell.step_name,
        "status": "ok", "trace_s": round(time.time() - t0, 1),
        "graph_nodes": len(gm.graph.nodes),
        "device_model": {
            "name": "NVIDIA H100 SXM (data sheet)",
            "peak_flops_bf16": H.PEAK_FLOPS_BF16, "hbm_bw": H.HBM_BW,
            "link_bw": H.ICI_BW, "fused_budget_bytes": FUSED_BUDGET_BYTES},
        "memory_analysis": {"reason": ABSENT["memory_analysis"]},
        "memory_structural": structural,
        "cost_analysis_raw": {"reason": ABSENT["cost_analysis_raw"]},
        "jaxpr_cost_global": jc,
        "jaxpr_cost_by_rule": w.by_rule,
        "jaxpr_cost_vmem_fused": jc_fused,
        "roofline_vmem_fused": roof_fused.to_dict(),
        "collectives": {"reason": ABSENT["collectives"]},
        "roofline": roof.to_dict(),
    }
    if verbose:
        sm = arg_bytes / 2**30
        print(f"[{arch} x {shape_name} x {mesh_tag}] OK "
              f"trace={result['trace_s']}s nodes={result['graph_nodes']} "
              f"args/dev={sm:.2f} GiB "
              f"flops/dev={jc['flops'] / n_chips:.3e} "
              f"dominant={roof.dominant} "
              f"useful={roof.useful_flops_ratio:.2f} "
              f"roofline_frac={roof.roofline_fraction:.3f}", flush=True)
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        out = ART_DIR / f"{arch}__{shape_name}__{mesh_tag}.json"
        out.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every assigned (arch x shape) cell")
    ap.add_argument("--compress-grads", action="store_true",
                    help="bf16+error-feedback gradient compression")
    args = ap.parse_args(argv)

    adam_cfg = adam.AdamConfig(compress_grads=args.compress_grads) \
        if args.compress_grads else None

    cells = []
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    for a in archs:
        shapes = assigned_cells(a) if (args.all or not args.shape) \
            else [args.shape]
        for s in shapes:
            if args.both_meshes:
                cells.append((a, s, False))
                cells.append((a, s, True))
            else:
                cells.append((a, s, args.multi_pod))

    failures = 0
    for a, s, mp in cells:
        try:
            run_cell(a, s, mp, adam_cfg=adam_cfg)
        except Exception:
            failures += 1
            tag = "multipod" if mp else "singlepod"
            print(f"[{a} x {s} x {tag}] FAILED", file=sys.stderr)
            traceback.print_exc()
            ART_DIR.mkdir(parents=True, exist_ok=True)
            (ART_DIR / f"{a}__{s}__{tag}.json").write_text(json.dumps(
                {"arch": a, "shape": s, "mesh": tag, "status": "failed",
                 "error": traceback.format_exc()[-2000:]}, indent=1))
    print(f"\ndry-run complete: {len(cells) - failures}/{len(cells)} OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
