#!/usr/bin/env python3
"""The serving benchmark's run (``perfbench/run.py``) with the engine's
hot-path spans on: how each decode and prefill of the window splits
into the host enqueuing work, the host waiting on the card and the
host's bookkeeping.

    python3 tools/serve_spans.py --workload moe-chat-closed64 \
        --seed <n> --seconds 51 --trace <0|1>

The run is the benchmark's own, in this process, with the engine built
with ``ServingConfig.trace_spans`` and the window's spans copied out of
the engine's tracer when the driver takes the window's statistics.
Prints the run's result line (with ``--trace 1`` its breakdown labels
the idle gaps by the engine's ranges, the innermost host events), then
one JSON line: each span's count and mean ms in the window, the sum of
the four decode parts, the harness's own decode and prefill means from
the same window, and the spans the tracer's ring evicted.  Kept until
the benchmark's serving driver reads the engine's spans itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
DECODE_PARTS = ("engine.decode.inputs", "engine.decode.forward",
                "engine.decode.read", "engine.decode.commit")


def span_means(spans: Sequence[Tuple[str, float, float]]) -> Dict:
    """{name: {"n", "mean_ms"}} of (name, start s, end s) spans."""
    acc: Dict[str, List[float]] = defaultdict(list)
    for name, s, e in spans:
        acc[name].append(e - s)
    return {n: {"n": len(v), "mean_ms": 1e3 * sum(v) / len(v)}
            for n, v in sorted(acc.items())}


def decode_parts_ms(means: Dict) -> Optional[float]:
    """The four decode parts' means summed, None where one is missing."""
    if not all(p in means for p in DECODE_PARTS):
        return None
    return sum(means[p]["mean_ms"] for p in DECODE_PARTS)


def _mean_ms(spans) -> Optional[float]:
    if not spans:
        return None
    return 1e3 * sum(s[1] - s[0] for s in spans) / len(spans)


def main(argv=None, device: str = "cuda", cell=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness, run
    harness.set_environment()
    from perfbench.drivers import serve_continuous as drv
    from repro_torch.serving.engine import ServingEngine

    got: Dict = {}
    init, stats = ServingEngine.__init__, drv._window_stats

    def init_spans(self, cfg, params, serving=None, **kw):
        if serving is not None:
            serving = dataclasses.replace(serving, trace_spans=True)
        init(self, cfg, params, serving, **kw)

    def window_stats(loop, t0, t1):
        tr = loop.eng.tracer
        got["spans"] = [(e.name, e.ts_s, e.ts_s + e.dur_s)
                        for e in tr.spans if t0 <= e.ts_s + e.dur_s <= t1]
        got["dropped"] = tr.spans_dropped
        got["decodes"] = drv.ctx_decodes(loop, t0, t1)
        got["prefills"] = [p for p in loop.prefill_spans
                           if t0 <= p[0] and p[1] <= t1]
        return stats(loop, t0, t1)

    ServingEngine.__init__ = init_spans
    drv._window_stats = window_stats
    passed = ["--workload", args.workload, "--seed", str(args.seed),
              "--seconds", str(args.seconds), "--trace", str(args.trace)]
    try:
        rc = run.main(passed, device=device, cell=cell)
    finally:
        ServingEngine.__init__ = init
        drv._window_stats = stats
    if rc:
        return rc
    means = span_means(got.get("spans", []))
    out = {"spans": means, "decode_parts_ms": decode_parts_ms(means),
           "decode_step_ms": _mean_ms(got.get("decodes")),
           "prefill_ms": _mean_ms(got.get("prefills")),
           "decodes": len(got.get("decodes") or ()),
           "spans_dropped": got.get("dropped")}
    print("spans " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # as perfbench/run.py: one host thread in each pool
    for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_v] = "1"
    sys.exit(main())
