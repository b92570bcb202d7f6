"""Transfer probes of the memory kinds (the ported part of
``repro.obs.calibrate``).

``measure_transfer_probes`` times bulk copies from the engine's device
into each memory kind and returns one bandwidth-only ``TierProbe`` per
kind: bulk copies cannot separate latency.  The serving engine builds
the tiers its adaptive replanner plans over from these probes
(``serving.engine.kind_bases``), so on the card the planner prices moves
with the card's own copy rates.  The rest of the reference module (the
``CostModelCalibrator`` and its online corrections) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional

import torch

from ..core.tiered_array import DeviceLike, empty_on, resolve_device

__all__ = ["TierProbe", "measure_transfer_probes"]


@dataclasses.dataclass(frozen=True)
class TierProbe:
    """One measured end-to-end observation of a tier from the origin.

    ``latency_ns`` may be None when the probe method cannot observe
    latency (bulk-transfer timing measures bandwidth only)."""

    tier: str
    bw_GBps: float
    latency_ns: Optional[float] = None


def measure_transfer_probes(kinds: Iterable[str] = ("pinned_host",
                                                    "unpinned_host"),
                            n_mb: int = 32, iters: int = 3,
                            device: DeviceLike = None) -> List[TierProbe]:
    """Copy bandwidth from ``device`` into each memory kind, in GB/s
    (bytes copied per second / 1e9).

    For each kind, an ``n_mb`` MiB destination buffer is allocated once
    and written by one warm-up copy, then ``iters`` copies of an
    ``n_mb`` MiB buffer on the device are timed together.  On CUDA the
    time is taken with CUDA events around the copies on the current
    stream (``device`` to ``device`` for the device kind, a DMA into
    page-locked or pageable host memory for the host kinds).  Under a
    CPU engine the kinds are logical CPU memory and the synchronous
    copies are timed with the host clock.  A kind that cannot be probed
    raises; none is skipped.
    """
    dev = resolve_device(device)
    nbytes = n_mb * 1024 * 1024
    src = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    out: List[TierProbe] = []
    for kind in kinds:
        dst = empty_on(kind, (nbytes,), torch.uint8, dev)
        dst.copy_(src)                              # warm-up
        n = max(1, iters)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(n):
                dst.copy_(src)
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                dst.copy_(src)
            dt = time.perf_counter() - t0
        if not dt > 0.0:
            raise RuntimeError(f"transfer probe of {kind!r} measured "
                               f"{dt} s for {n} copies")
        out.append(TierProbe(kind, bw_GBps=n * nbytes / dt / 1e9))
    return out
