"""Post-SPMD HLO analysis: collective bytes, op census, roofline terms
(counterpart of ``repro.launch.hlo_analysis``; the parser is the
reference's, since HLO text is HLO text, and the roofline constants are
an H100's).

``compiled.cost_analysis()`` gives FLOPs and bytes accessed but NOT
collective traffic; we parse the optimized HLO text and sum operand sizes
of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, converting to per-device wire bytes with ring-algorithm
factors (convention documented in EXPERIMENTS.md §Roofline):

    all-gather         out_bytes * (n-1)/n
    reduce-scatter     out_bytes * (n-1)
    all-reduce         2 * bytes * (n-1)/n
    all-to-all         bytes * (n-1)/n
    collective-permute bytes
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_NEW_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_OLD_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_NEW_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_OLD_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0          # per-device wire bytes (ring model)
    result_bytes: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, op: str, wire: float, result: int):
        self.wire_bytes += wire
        self.result_bytes += result
        self.counts[op] = self.counts.get(op, 0) + 1
        self.by_op_bytes[op] = self.by_op_bytes.get(op, 0.0) + wire


_COMP_HEAD_RE = re.compile(
    r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\(.*\))?\s*->.*\{\s*$")
_WHILE_RE = re.compile(
    r"while\(.*?body=%?([\w.\-]+)")
_TRIP_RE = re.compile(r'known_trip_count[\\\":{\s]+n[\\\":\s]+(\d+)')
_CALL_RE = re.compile(r"(?:to_apply|calls|body|condition|branch_computations)="
                      r"\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?")


def _parse_computations(hlo_text: str) -> Dict[str, List[str]]:
    """Split HLO text into computation-name -> list of instruction lines."""
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for raw in hlo_text.splitlines():
        line = raw.rstrip()
        s = line.strip()
        m = _COMP_HEAD_RE.match(s)
        if m and s.endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            continue
        if s == "}":
            cur = None
            continue
        if cur is not None and s:
            comps[cur].append(s)
    return comps


def _line_collective(s: str, n_devices: int):
    """Return (op, wire_bytes, result_bytes) if the line is a collective."""
    op = None
    for c in _COLLECTIVES:
        if f" {c}(" in s or f" {c}-start(" in s:
            op = c
            break
    if op is None or "-done(" in s:
        return None
    try:
        _, rhs = s.split("=", 1)
    except ValueError:
        return None
    type_part = rhs.split(op)[0]
    rbytes = sum(_shape_bytes(d, dims)
                 for d, dims in _SHAPE_RE.findall(type_part))
    if rbytes == 0:
        return None
    n = _group_size(s, n_devices)
    if n <= 1:
        return None
    frac = (n - 1) / n
    if op == "all-gather":
        wire = rbytes * frac
    elif op == "reduce-scatter":
        wire = rbytes * (n - 1)
    elif op == "all-reduce":
        wire = 2.0 * rbytes * frac
    elif op == "all-to-all":
        wire = rbytes * frac
    else:  # collective-permute
        wire = float(rbytes)
    return op, wire, rbytes


def collective_bytes(hlo_text: str, n_devices: int) -> CollectiveStats:
    """Collective wire bytes per device, with while-loop trip counts.

    Walks the computation graph from ENTRY; a ``while`` op multiplies its
    body/condition computations by the ``known_trip_count`` XLA records in
    backend_config (1 if absent).  Fusion computations (kLoop/kOutput) hold
    no collectives, so only call/while/cond edges matter.
    """
    comps = _parse_computations(hlo_text)
    entry = None
    for raw in hlo_text.splitlines():
        s = raw.strip()
        if s.startswith("ENTRY"):
            m = _COMP_HEAD_RE.match(s)
            if m:
                entry = m.group(1)
            break
    if entry is None or entry not in comps:
        # fall back: treat whole text as one computation, trips=1
        stats = CollectiveStats()
        for line in hlo_text.splitlines():
            r = _line_collective(line.strip(), n_devices)
            if r:
                stats.add(*r)
        return stats

    stats = CollectiveStats()
    import functools

    @functools.lru_cache(maxsize=None)
    def comp_cost(name: str) -> Tuple[Tuple[str, float, int], ...]:
        """Flattened (op, wire, result) contributions of one computation."""
        out: List[Tuple[str, float, int]] = []
        for line in comps.get(name, ()):
            r = _line_collective(line, n_devices)
            if r:
                out.append(r)
            if " while(" in line:
                m = _WHILE_RE.search(line)
                trips = 1
                tm = _TRIP_RE.search(line)
                if tm:
                    trips = int(tm.group(1))
                if m:
                    body = m.group(1)
                    for (op, w, rb) in comp_cost(body):
                        out.append((op, w * trips, rb))
            elif "fusion(" in line or " call(" in line or " conditional(" \
                    in line or "to_apply=" in line:
                for mm in _CALL_RE.finditer(line):
                    for cname in mm.group(1).split(","):
                        cname = cname.strip().lstrip("%")
                        if cname in comps and cname != name:
                            out.extend(comp_cost(cname))
        return tuple(out)

    for (op, w, rb) in comp_cost(entry):
        stats.add(op, w, rb)
    return stats


# ---------------------------------------------------------------------- #
# Roofline terms (NVIDIA H100 SXM data sheet: dense rates, 700 W).        #
# ---------------------------------------------------------------------- #
PEAK_FLOPS_BF16 = 989e12       # per card, bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12        # per card, fp32 outside the tensor cores
HBM_BW = 3.35e12               # per card
ICI_BW = 900e9 / 18            # per NVLink 4 link: 900 GB/s over 18 links
L2_BYTES = 50 * 1024**2        # per card, the L2 cache (50 MB)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float             # total across chips
    hlo_bytes: float             # total across chips
    wire_bytes_per_dev: float
    model_flops: float
    n_chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound term that is the compute term — how close
        the step is to being compute-limited at peak."""
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return self.compute_s / max(bound, 1e-30)

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "wire_bytes_per_dev": self.wire_bytes_per_dev,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
        }


def roofline_terms(total_flops: float, total_bytes: float,
                   stats: CollectiveStats, n_chips: int,
                   model_flops: float) -> Roofline:
    """total_flops/bytes are GLOBAL (jaxpr_cost.step_cost, exact trips)."""
    return Roofline(
        compute_s=total_flops / (n_chips * PEAK_FLOPS_BF16),
        memory_s=total_bytes / (n_chips * HBM_BW),
        collective_s=stats.wire_bytes / ICI_BW,
        hlo_flops=total_flops,
        hlo_bytes=total_bytes,
        wire_bytes_per_dev=stats.wire_bytes,
        model_flops=model_flops,
        n_chips=n_chips,
    )


_DUS_RE = re.compile(r"= (\w+)\[([\d,]+)\]\{[^}]*\} dynamic-update-slice\(")


def saved_stack_bytes(hlo_text: str) -> Dict[str, int]:
    """Unique dynamic-update-slice result shapes = persistent scan stacks
    (remat-saved residuals / ys buffers), one buffer per shape.

    This is the *structural* per-device activation-stack footprint; the
    XLA:CPU temp_size additionally holds transients its scheduler keeps
    alive that a TPU buffer assignment would not (documented in
    EXPERIMENTS.md §Dry-run)."""
    shapes = {}
    for m in _DUS_RE.finditer(hlo_text):
        d, dims = m.groups()
        n = 1
        for x in dims.split(","):
            n *= int(x)
        shapes[f"{d}[{dims}]"] = n * _DTYPE_BYTES.get(d, 4)
    total = sum(shapes.values())
    top = dict(sorted(shapes.items(), key=lambda kv: -kv[1])[:8])
    return {"total_bytes": total, "top_stacks": top}


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference
    steps (D = tokens processed by the step)."""
    n_active = cfg.active_param_count()
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens
