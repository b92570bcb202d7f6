"""What the per-layer readers (``perfbench/metrics/<name>.py``) share.
Each takes the driver's ``Outcome`` and returns a number, or None where
the run gave it nothing to read (never 0 for a share of a peak)."""
from __future__ import annotations

from typing import Optional

from .costs import peaks


def roofline(out, kernel: str) -> Optional[float]:
    """Percent: the calls' summed roofline bound over the kernel's device
    time in the traced slice."""
    if out.trace is None:
        return None
    bound = out.ctx.get("bounds", {}).get(kernel)
    busy = out.trace["kernel_s"].get(kernel)
    if not bound or not busy:
        return None
    return 100.0 * bound / busy


def mfu(out) -> Optional[float]:
    """Percent of the bf16 peak: model FLOPs of the window over the
    window's wall seconds."""
    flops, secs = out.ctx.get("flops"), out.ctx.get("window_s")
    if not flops or not secs:
        return None
    return 100.0 * flops / (secs * peaks.BF16_FLOP_PER_S)


def idle_share(out) -> Optional[float]:
    """Percent of the traced slice with nothing running on the card
    (the union of its device intervals)."""
    if out.trace is None or out.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - out.trace["busy_s"] / out.trace["window_s"])


def mean_ms(spans) -> Optional[float]:
    if not spans:
        return None
    return 1e3 * sum(s[1] - s[0] for s in spans) / len(spans)
