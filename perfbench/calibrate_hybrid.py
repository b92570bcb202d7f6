"""``perfbench/calibrate.py`` for a cell of the hybrid driver
(``serve_hybrid``): the same readings, with the control computed by the
hybrid's plain reference (``reference/granite_hybrid.py``) in float8.

    python3 perfbench/calibrate_hybrid.py --workload <cell> \
        --seeds 1,2,3 --control-seeds 4,5,6 --seconds 15

Prints one JSON line per seed.
"""
import time

T_START = time.perf_counter()

import dataclasses  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import calibrate  # noqa: E402


def control(drv, cell, out, keep, device) -> dict:
    """The control's tokens in the program's place, through the check
    (``calibrate.control`` with the hybrid's reference)."""
    import torch

    from perfbench.reference import granite_hybrid as ref
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
    calibrate.control = control
    return calibrate.main(argv, device=device, cell=cell)


if __name__ == "__main__":
    sys.exit(main())
