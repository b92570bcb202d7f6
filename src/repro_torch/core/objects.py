"""PyTorch-port copy of ``repro.core.objects`` (framework-free).

Data-object descriptors — the unit of placement in the paper's OLI policy.

A *data object* is a named array (or logical group of arrays, e.g. "all
optimizer moments") together with the information the paper's §V-B selection
criteria need:

  * footprint          (bytes)
  * bytes touched per step, split into streaming vs random access
  * latency sensitivity (random/pointer-chasing access => latency-bound)

The per-step access volumes are *exact* for our workloads: a training or
serving step has a static dataflow, so unlike the paper (which instruments
with profiling) we derive them analytically from the model config.  That is
the "application semantics" §V-B says should guide interleaving.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple


@dataclasses.dataclass
class DataObject:
    """One placeable object."""

    name: str
    nbytes: int
    # Per-step traffic generated against this object's home tier(s).
    read_bytes_per_step: int = 0
    write_bytes_per_step: int = 0
    # Fraction of accesses that are random/indirect (CG-style) rather than
    # streaming (MG-style).  Drives latency- vs bandwidth-sensitivity.
    random_fraction: float = 0.0
    # Pinning: some objects must live on the fast tier (e.g. SSM decode
    # state: tiny and on the critical path every token).
    pin_fast: bool = False
    # group tag, e.g. "params" / "opt_state" / "kv_cache" / "activations"
    group: str = "misc"

    @property
    def bytes_per_step(self) -> int:
        return self.read_bytes_per_step + self.write_bytes_per_step

    @property
    def intensity(self) -> float:
        """Accesses per resident byte per step — the paper's 'intensive' axis."""
        if self.nbytes == 0:
            return 0.0
        return self.bytes_per_step / self.nbytes

    @property
    def latency_sensitive(self) -> bool:
        return self.random_fraction > 0.5

    @property
    def bandwidth_hungry(self) -> bool:
        return (not self.latency_sensitive) and self.bytes_per_step > 0


def total_footprint(objs: Iterable[DataObject]) -> int:
    return sum(o.nbytes for o in objs)


def select_interleave_candidates(objs: List[DataObject],
                                 footprint_threshold: float = 0.10,
                                 top_k: Optional[int] = None
                                 ) -> List[DataObject]:
    """The paper's §V-B two-criteria selection.

    1. footprint >= `footprint_threshold` of total memory consumption;
    2. among those, the most access-intensive (largest per-step traffic);
       multiple objects may be selected (paper: Table III last column).
    Latency-sensitive (random-access) and pinned objects are excluded — they
    are exactly the objects §V-A observation 3 says should be *gathered* in
    one node, not spread.
    """
    total = max(total_footprint(objs), 1)
    big = [o for o in objs
           if o.nbytes / total >= footprint_threshold
           and not o.pin_fast and not o.latency_sensitive
           and o.bytes_per_step > 0]
    big.sort(key=lambda o: o.bytes_per_step, reverse=True)
    if top_k is not None:
        big = big[:top_k]
    return big


# ---------------------------------------------------------------------- #
# Object inventories for the paper's workload families.                   #
# ---------------------------------------------------------------------- #
def hpc_workload_objects(name: str) -> List[DataObject]:
    """Table III: the seven HPC dwarfs with their bandwidth-hungry objects.

    Footprints are the paper's (Class E / D); per-step traffic is modeled as
    `sweeps` full passes over each hungry object per iteration; the rest of
    the footprint gets background traffic.
    """
    G = 1024**3

    def mk(total_G, hungry: List[Tuple[str, float]], rand=0.0, sweeps=1.0):
        objs = []
        hungry_total = 0.0
        for nm, sz in hungry:
            objs.append(DataObject(
                name=nm, nbytes=int(sz * G),
                read_bytes_per_step=int(sz * G * sweeps),
                write_bytes_per_step=int(sz * G * sweeps * 0.5),
                random_fraction=rand, group="hpc"))
            hungry_total += sz
        rest = max(total_G - hungry_total, 0.0)
        if rest > 0:
            # the non-hungry residue (index arrays, metadata, temporaries)
            # is latency-sensitive and ALLOCATED LAST — under LDRAM
            # pressure 'preferred' pushes exactly this onto CXL (the
            # paper's OLI-observation-2 reason 1).
            objs.append(DataObject(
                name="rest", nbytes=int(rest * G),
                read_bytes_per_step=int(rest * G * 0.5),
                random_fraction=max(rand, 0.6), group="hpc"))
        return objs

    table = {
        # unit-strided dense accesses
        "BT": mk(166, [("u", 39.6), ("rsh", 39.6), ("forcing", 39.6)]),
        # indexed loads/stores, compressed matrices: mostly streaming
        # within compressed rows, light indirection
        "LU": mk(134, [("u", 39.6), ("rsd", 39.6)], rand=0.15),
        # irregular indirect indexing -> latency-sensitive
        "CG": mk(134, [("a", 48.9)], rand=0.9),
        # structured grid sweeps, bandwidth-hungry
        "MG": mk(210, [("v", 64.2), ("r", 73.4)], sweeps=2.0),
        "SP": mk(174, [("u", 39.6), ("rsh", 39.6), ("forcing", 39.6)]),
        # bandwidth-consuming transpose
        "FT": mk(80, [("u0", 32.0), ("u1", 32.0)], sweeps=2.0),
        # Monte Carlo random trials over nuclide grids
        "XSBench": mk(116, [("nuclide_grids", 60.0)], rand=0.95),
    }
    if name not in table:
        raise ValueError(f"unknown HPC workload {name!r}")
    return table[name]


def llm_train_objects(n_params: int, batch_tokens: int, d_model: int,
                      n_layers: int, optimizer_on_host: bool = True
                      ) -> List[DataObject]:
    """ZeRO-Offload object inventory (Fig. 7): fp16 params/grads on device,
    fp32 master params + moments on the slow tier, activations on device."""
    act_bytes = 2 * batch_tokens * d_model * n_layers * 12  # rough, w/ remat
    return [
        DataObject("params_bf16", 2 * n_params,
                   read_bytes_per_step=2 * n_params * 2,  # fwd+bwd
                   group="params"),
        DataObject("grads_bf16", 2 * n_params,
                   read_bytes_per_step=2 * n_params,
                   write_bytes_per_step=2 * n_params, group="grads"),
        DataObject("master_params_fp32", 4 * n_params,
                   read_bytes_per_step=4 * n_params,
                   write_bytes_per_step=4 * n_params, group="opt_state"),
        DataObject("adam_m_fp32", 4 * n_params,
                   read_bytes_per_step=4 * n_params,
                   write_bytes_per_step=4 * n_params, group="opt_state"),
        DataObject("adam_v_fp32", 4 * n_params,
                   read_bytes_per_step=4 * n_params,
                   write_bytes_per_step=4 * n_params, group="opt_state"),
        DataObject("activations", act_bytes,
                   read_bytes_per_step=act_bytes,
                   write_bytes_per_step=act_bytes,
                   pin_fast=True, group="activations"),
    ]


def llm_serve_objects(n_params: int, kv_bytes: int, act_bytes: int
                      ) -> List[DataObject]:
    """FlexGen object inventory (Fig. 10): weights, KV cache, activations."""
    return [
        DataObject("weights", 2 * n_params,
                   read_bytes_per_step=2 * n_params, group="params"),
        DataObject("kv_cache", kv_bytes,
                   read_bytes_per_step=kv_bytes,
                   write_bytes_per_step=kv_bytes // 64, group="kv_cache"),
        DataObject("activations", act_bytes,
                   read_bytes_per_step=2 * act_bytes,
                   write_bytes_per_step=act_bytes,
                   pin_fast=True, group="activations"),
    ]
