"""PyTorch-port copy of ``repro.telemetry.sampler`` (framework-free).

Sampling front-end: the hint-fault / PEBS analogue.

Full-resolution recording of every access is exactly the profiling
overhead the paper's PMO 2 warns about (TPP's every-touch hint faults
cost it the win).  Production profilers therefore *sample*: one record
per ``1/sample_rate`` cache lines (a PEBS period, or a hint-fault scan
interval).  ``AccessSampler`` models that: emitters call ``observe``
with true byte counts, the sampler deterministically takes
``lines * rate`` samples (a carry accumulator per (object, channel) —
no RNG, so runs are reproducible), scales the sampled lines back up by
``1/rate`` into an *estimated* event on the underlying AccessTrace, and
charges every sample a profiling cost.

The per-sample cost mirrors how core.migration charges hint faults
(``fault_cost_s``), plus — when a ``MemoryTier`` is given — the loaded
random-access time of the sampled cache line on that tier
(core.tiers.access_time_s): sampling slow-tier pages is more expensive,
which is the paper's PMO-2 observation that profiling overhead scales
with where the samples land.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.tiers import MemoryTier
from .events import AccessTrace

LINE_BYTES = 64


@dataclasses.dataclass
class SamplerConfig:
    """PEBS-analogue knobs.

    sample_rate   fraction of cache lines sampled (1e-6 = one sample per
                  million lines, a realistic PEBS period; >= 1.0 means
                  full instrumentation — every line recorded and paid).
    sample_cost_s CPU cost per retired sample (hint-fault analogue;
                  matches core.migration's fault_cost_s scale).
    tier          optional tier the samples land on; adds that tier's
                  loaded random cache-line access time per sample.
    """

    sample_rate: float = 1e-6
    sample_cost_s: float = 2e-6
    tier: Optional[MemoryTier] = None

    def __post_init__(self):
        if self.sample_rate <= 0:
            raise ValueError("sample_rate must be positive")


class AccessSampler:
    """Deterministic sampling layer over an AccessTrace."""

    def __init__(self, trace: AccessTrace,
                 cfg: Optional[SamplerConfig] = None):
        self.trace = trace
        self.cfg = cfg or SamplerConfig()
        self._carry: Dict[Tuple[str, str], float] = {}
        self.samples = 0
        self.overhead_s = 0.0

    # ------------------------------------------------------------------ #
    def _per_sample_cost(self) -> float:
        c = self.cfg.sample_cost_s
        if self.cfg.tier is not None:
            c += self.cfg.tier.access_time_s(LINE_BYTES, streams=1.0,
                                             random=True)
        return c

    def _sample(self, obj: str, channel: str, nbytes: int) -> int:
        """Sampled-line count -> estimated bytes for one channel."""
        if nbytes <= 0:
            return 0
        lines = nbytes / LINE_BYTES
        rate = self.cfg.sample_rate
        if rate >= 1.0:
            n = max(int(round(lines)), 1)
            self.samples += n
            self.overhead_s += n * self._per_sample_cost()
            return nbytes                      # exact at full rate
        acc = self._carry.get((obj, channel), 0.0) + lines * rate
        n = int(acc)
        self._carry[(obj, channel)] = acc - n
        if n == 0:
            return 0
        self.samples += n
        self.overhead_s += n * self._per_sample_cost()
        return int(n * LINE_BYTES / rate)      # scale back to bytes

    # ------------------------------------------------------------------ #
    def observe(self, obj: str, read_bytes: int = 0, write_bytes: int = 0,
                random_fraction: float = 0.0, phase: str = "",
                block: Optional[int] = None) -> None:
        """Record a (possibly sampled) access against the trace."""
        r = self._sample(obj, "r", int(read_bytes))
        w = self._sample(obj, "w", int(write_bytes))
        if r or w:
            self.trace.record(obj, r, w, random_fraction, phase=phase,
                              block=block)

    def advance_epoch(self) -> int:
        return self.trace.advance_epoch()

    def forget(self, obj: str) -> None:
        """Drop the carry state of a retired object (e.g. a finished
        sequence) so long-running emitters with ever-fresh object names
        cannot grow the accumulator without bound."""
        self._carry.pop((obj, "r"), None)
        self._carry.pop((obj, "w"), None)
        self.trace.forget(obj)

    # ------------------------------------------------------------------ #
    def overhead_fraction(self, step_time_s: float) -> float:
        """Profiling overhead as a fraction of the given run time."""
        return self.overhead_s / max(step_time_s, 1e-12)
