"""Plumbing shared by every cell: the cell's files found by name, the
run's environment, the guard against the JAX package, and the result
line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kind of entry sits in a file of its own:

  * ``BENCHMARK.json`` (the checkout's root) names the cells;
  * ``perfbench/configs/<config>.json``: the sizes, and the driver;
  * ``perfbench/traffic/<mix>.json``: the load;
  * ``perfbench/drivers/<driver>.py``: one kind of entry (``run``);
  * ``perfbench/metrics/<metric>.py``: one per-layer reader (``read``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_environment() -> None:
    """Fixed cache directories inside the checkout, and no JAX through a
    library.  ``src`` goes on the import path: the system under test is
    the checkout's own ``repro_torch``."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    # fewer stranded blocks when prompts of many lengths come and go
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# ---------------------------------------------------------------------- #
# files found by name                                                    #
# ---------------------------------------------------------------------- #
def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[dict] = None) -> Dict[str, Any]:
    """The workload ``name`` with its configuration and traffic files
    read in: keys ``name``, ``chips``, ``config`` (dict), ``traffic``
    (dict), ``end_to_end`` and ``per_layer`` (the entries it reports)."""
    bench = bench or benchmark()
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return {"name": name, "chips": w["chips"],
            "config": load_json(ROOT / conf["file"]),
            "traffic": traffic(w["traffic"]),
            "end_to_end": e2e, "per_layer": per_layer}


def traffic(name: str) -> Dict[str, Any]:
    return load_json(BENCH / "traffic" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def reader(metric: str):
    """``perfbench/metrics/<metric>.py`` as a module (names hold dots, so
    it is loaded from its path)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------- #
# seeds                                                                  #
# ---------------------------------------------------------------------- #
def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (weights,
    traffic, sample), from numpy's SeedSequence."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


WEIGHTS, TRAFFIC, SAMPLE, TOKENS = 1, 2, 3, 4


# ---------------------------------------------------------------------- #
# statistics                                                             #
# ---------------------------------------------------------------------- #
def percentile(values, q: float) -> float:
    """numpy's linear percentile; +inf where a value is +inf beyond it."""
    if len(values) == 0:
        return math.nan
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def memory(device) -> str:
    """The card's memory in use, for the log."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu"
    free, total = torch.cuda.mem_get_info()
    return (f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"free {free / 2**30:.2f} of {total / 2**30:.2f} GiB")


# ---------------------------------------------------------------------- #
# the result                                                             #
# ---------------------------------------------------------------------- #
def emit(result: Dict[str, Any], checks: Dict[str, Dict[str, float]]
         ) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, and the result as the last line of standard output
    with the checks under the key that comes last."""
    out = dict(result)
    out["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
