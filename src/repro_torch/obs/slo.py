"""PyTorch-port copy of ``repro.obs.slo`` (framework-free).

Live SLO monitors over serving latency streams.

Two monitors:

- :class:`SLOMonitor` — rolling-window p50/p95/p99 per metric stream
  (TTFT, decode inter-token latency) checked against threshold targets,
  with violation counters and optional trace events. Windows are exact
  (numpy percentile over a bounded deque) because SLO checks are
  control-plane-rate, not token-rate.
- :class:`LagRatioMonitor` — the ROADMAP's online burst-entry/steady
  lag ratio, computed from live per-epoch serving rates instead of the
  bench's analytic derivation. A ratio near 1.0 at burst entry means
  the predictive prefetch path hid the tier-promotion lag.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SLOTarget", "SLOMonitor", "LagRatioMonitor"]


def _qkey(q: float) -> str:
    """'95' for 0.95, '99.9' for 0.999 — no collision at extreme tails
    (int rounding would alias p99.9 to p100)."""
    return f"{round(q * 100, 4):g}"


@dataclass(frozen=True)
class SLOTarget:
    """Threshold on a quantile of a latency stream (seconds)."""

    metric: str            # e.g. "ttft" or "decode_latency"
    quantile: float        # e.g. 0.95
    threshold_s: float     # violation when quantile > threshold

    @property
    def key(self) -> str:
        return f"{self.metric}.p{_qkey(self.quantile)}"

    def warmup_samples(self, min_samples: int) -> int:
        """Samples the window must hold before this target can violate.

        Extreme-tail targets (beyond p99) need at least 1/(1-q) samples
        for the empirical quantile to be a tail at all — a 50-sample
        "p99.9" is its max, an arrival artifact.  p95/p99 targets keep
        the caller's ``min_samples`` contract unchanged.
        """
        if self.quantile > 0.99:
            return max(min_samples,
                       int(math.ceil(1.0 / (1.0 - self.quantile))))
        return min_samples


class SLOMonitor:
    """Rolling-window quantile checks with violation counting.

    ``observe`` feeds a sample into a metric's window; ``check``
    evaluates every target against its current window and bumps
    violation counters. The clock is injected so tests can drive
    violations deterministically.
    """

    QUANTILES = (0.50, 0.95, 0.99, 0.999)

    def __init__(self, targets: Optional[List[SLOTarget]] = None,
                 window: int = 256,
                 clock: Optional[Callable[[], float]] = None,
                 registry=None, tracer=None,
                 min_samples: int = 4) -> None:
        self.targets = list(targets or [])
        # the window must be able to hold every target's warmup — a
        # p99.9 target inside a 256-sample window could never become
        # eligible (and its "p99.9" would just be the window max)
        need = max((t.warmup_samples(max(int(min_samples), 1))
                    for t in self.targets), default=0)
        self.window = max(int(window), need)
        self.clock = clock if clock is not None else (lambda: 0.0)
        self.registry = registry
        self.tracer = tracer
        # warmup: a target's window must hold at least this many samples
        # before it can violate — a 2-sample "p99" is an arrival
        # artifact, not a tail
        self.min_samples = max(int(min_samples), 1)
        self._streams: Dict[str, Deque[float]] = {}
        self.violations: Dict[str, int] = {t.key: 0 for t in self.targets}
        # checks where the target's window was past warmup — the
        # denominator of its violation rate
        self.eligible_checks: Dict[str, int] = {t.key: 0
                                                for t in self.targets}
        self.checks = 0
        self.last_quantiles: Dict[str, float] = {}
        # violation hooks: fn(target, observed_value, now) — the QoS
        # blame plane joins each firing to its bottleneck link here
        self._hooks: List[Callable[[SLOTarget, float, float], None]] = []

    def add_violation_hook(
            self, fn: Callable[[SLOTarget, float, float], None]) -> None:
        self._hooks.append(fn)

    def violation_rate(self, key: str) -> Optional[float]:
        """Violations per eligible (post-warmup) check for one target."""
        eligible = self.eligible_checks.get(key, 0)
        if eligible <= 0:
            return None
        return self.violations.get(key, 0) / eligible

    def observe(self, metric: str, value: float,
                now: Optional[float] = None) -> None:
        stream = self._streams.get(metric)
        if stream is None:
            stream = self._streams[metric] = deque(maxlen=self.window)
        stream.append(float(value))
        if self.registry is not None:
            self.registry.histogram(f"slo.{metric}").observe(float(value))

    def quantile(self, metric: str, q: float) -> Optional[float]:
        stream = self._streams.get(metric)
        if not stream:
            return None
        return float(np.percentile(np.asarray(stream, dtype=np.float64),
                                   q * 100.0))

    def check(self, now: Optional[float] = None) -> List[Tuple[SLOTarget, float]]:
        """Evaluate all targets; returns the violated (target, value)s."""
        now = float(self.clock() if now is None else now)
        self.checks += 1
        violated: List[Tuple[SLOTarget, float]] = []
        for metric, stream in self._streams.items():
            if not stream:
                continue
            arr = np.asarray(stream, dtype=np.float64)
            for q in self.QUANTILES:
                self.last_quantiles[f"{metric}.p{_qkey(q)}"] = \
                    float(np.percentile(arr, q * 100.0))
        for t in self.targets:
            value = self.last_quantiles.get(t.key)
            if value is None:
                continue
            stream = self._streams.get(t.metric)
            if stream is None or \
                    len(stream) < t.warmup_samples(self.min_samples):
                continue               # warmup: too few samples to judge
            self.eligible_checks[t.key] += 1
            if value > t.threshold_s:
                self.violations[t.key] += 1
                violated.append((t, value))
                if self.tracer is not None:
                    self.tracer.event("slo.violation", cat="slo", ts=now,
                                      metric=t.metric, quantile=t.quantile,
                                      threshold_s=t.threshold_s,
                                      observed_s=value)
                if self.registry is not None:
                    self.registry.counter(
                        f"slo.violations.{t.key}",
                        help="rolling-window SLO threshold breaches").inc()
                for hook in self._hooks:
                    hook(t, value, now)
            if self.registry is not None:
                self.registry.gauge(
                    f"slo.violation_rate.{t.key}",
                    help="violations per post-warmup check").set(
                        self.violations[t.key]
                        / self.eligible_checks[t.key])
        return violated

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "checks": self.checks,
            "targets": [
                {"metric": t.metric, "quantile": t.quantile,
                 "threshold_s": t.threshold_s,
                 "violations": self.violations[t.key],
                 "eligible_checks": self.eligible_checks[t.key],
                 "violation_rate": self.violation_rate(t.key)}
                for t in self.targets
            ],
        }
        out.update(self.last_quantiles)
        return out


@dataclass
class _PhaseRun:
    """Accumulator for one contiguous run of a phase label."""

    label: str
    occurrence: int
    pos: int = 0


class LagRatioMonitor:
    """Online burst-entry / steady lag ratio from live serving rates.

    Feed one sample per telemetry epoch: the detected phase label, the
    work done (tokens) and the wall/virtual time spent. Epochs are
    classified by their position inside a contiguous run of the same
    label: position 0 is *entry*, positions >= ``steady_from`` are
    *steady*. The first ``warmup_occurrences`` runs of each label are
    discarded (the predictive table has not seen the phase yet), which
    matches the bench's analytic ``burst_entry_ratio`` definition, so
    live and analytic values agree on identical data.

    ``ratio()`` = mean entry rate / mean steady rate for the phase; a
    reactive-only control plane shows a dip (<1) at burst entry while
    prefetching pulls it toward 1.
    """

    def __init__(self, warmup_occurrences: int = 2,
                 steady_from: int = 2) -> None:
        self.warmup_occurrences = int(warmup_occurrences)
        self.steady_from = int(steady_from)
        self._run: Optional[_PhaseRun] = None
        self._occurrences: Dict[str, int] = {}
        self.entry_rates: Dict[str, List[float]] = {}
        self.steady_rates: Dict[str, List[float]] = {}
        self.epochs = 0

    def observe_epoch(self, phase: str, work: float, time_s: float) -> None:
        self.epochs += 1
        phase = str(phase)
        if self._run is None or self._run.label != phase:
            occ = self._occurrences.get(phase, 0) + 1
            self._occurrences[phase] = occ
            self._run = _PhaseRun(label=phase, occurrence=occ, pos=0)
        else:
            self._run.pos += 1
        if not (time_s > 0.0):   # also rejects NaN, not just <= 0
            return
        if self._run.occurrence <= self.warmup_occurrences:
            return
        rate = float(work) / float(time_s)
        if not math.isfinite(rate):
            return
        if self._run.pos == 0:
            self.entry_rates.setdefault(phase, []).append(rate)
        elif self._run.pos >= self.steady_from:
            self.steady_rates.setdefault(phase, []).append(rate)

    def _default_phase(self) -> Optional[str]:
        """The phase with the highest mean steady rate (the 'burst')."""
        best, best_rate = None, -1.0
        for phase, rates in self.steady_rates.items():
            if phase not in self.entry_rates:
                continue
            mean = sum(rates) / len(rates)
            if mean > best_rate:
                best, best_rate = phase, mean
        return best

    def ratio(self, phase: Optional[str] = None) -> Optional[float]:
        """Entry/steady rate ratio for ``phase`` (default: busiest)."""
        if phase is None:
            phase = self._default_phase()
        if phase is None:
            return None
        entry = self.entry_rates.get(phase)
        steady = self.steady_rates.get(phase)
        # an empty or all-zero steady window yields no ratio, not a
        # ZeroDivisionError or inf
        if not entry or not steady:
            return None
        steady_mean = sum(steady) / len(steady)
        if steady_mean <= 0.0 or not math.isfinite(steady_mean):
            return None
        result = (sum(entry) / len(entry)) / steady_mean
        return result if math.isfinite(result) else None

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"epochs": self.epochs}
        r = self.ratio()
        if r is not None:
            out["burst_entry_ratio"] = r
            out["phase"] = self._default_phase()
        return out
