"""One driver per kind of entry: ``run(cell, seed, seconds, trace,
t_start, device)`` sets up from the seed, warms up, measures for
``seconds`` of wall clock, checks the timed path's output against the
plain reference and returns the pieces of the result line (``Outcome``).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]           # end-to-end metrics by name
    ctx: Dict[str, Any]             # what the per-layer readers read
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]   # name -> {"value", "limit"}
    memory_peak_bytes: int
    trace: Optional[Dict] = None    # devtrace summary of the traced slice

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def port_config(conf: Dict):
    """The port's ModelConfig of the registry name, with the sizes of the
    configuration file's ``model`` (the file is what runs); a size that
    differs from the registry's is said on standard error."""
    from repro_torch.configs import get_config
    base = get_config(conf["registry"])
    fields = {f.name for f in dataclasses.fields(base)}
    over = {k: v for k, v in conf["model"].items() if k in fields}
    for k, v in over.items():
        if getattr(base, k) != v:
            print(f"config {conf['name']}: {k} = {v!r} (registry "
                  f"{getattr(base, k)!r})", file=sys.stderr)
    return dataclasses.replace(base, **over)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
