"""PyTorch-port copy of ``repro.obs.registry`` (framework-free).

Central metrics registry: counters, gauges, histograms.

Histograms use a DDSketch-style log-bucketed percentile sketch with a
bounded *relative* error guarantee: for relative accuracy ``alpha``,
``quantile(q)`` is within ``alpha * true_value`` of the exact sample
quantile, at O(log(range)) memory independent of sample count. That is
the right trade for latency tails — the paper's tail-latency findings
(and CXL-Interference's co-location effects) live in p95/p99 where
fixed-width histogram buckets lose exactly the resolution that matters.

Everything here is zero-dependency and snapshot-friendly; the registry
exports both a flat dict (for bench JSON artifacts) and Prometheus-style
text exposition (for ``--metrics-out``).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = ["PercentileSketch", "Counter", "Gauge", "Histogram",
           "MetricsRegistry"]


class PercentileSketch:
    """DDSketch-style streaming quantile sketch (relative-error bound).

    Values ``v > 0`` land in log bucket ``k = ceil(log_gamma(v))`` with
    ``gamma = (1 + alpha) / (1 - alpha)``; the representative value of
    bucket ``k`` is ``2 * gamma^k / (gamma + 1)`` (the geometric bucket
    midpoint), which keeps the relative error below ``alpha``. Values
    ``<= 0`` are collapsed into a zero bucket (latencies are positive;
    this keeps the sketch total-count correct if a zero slips in). When
    the bucket map exceeds ``max_buckets`` the lowest buckets collapse
    together — tails (high quantiles) keep their guarantee.
    """

    def __init__(self, rel_err: float = 0.01, max_buckets: int = 2048) -> None:
        if not 0.0 < rel_err < 1.0:
            raise ValueError("rel_err must be in (0, 1)")
        self.rel_err = float(rel_err)
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self.gamma)
        self.max_buckets = int(max_buckets)
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if value <= 0.0:
            self.zero_count += 1
            return
        k = math.ceil(math.log(value) / self._log_gamma)
        self.buckets[k] = self.buckets.get(k, 0) + 1
        if len(self.buckets) > self.max_buckets:
            self._collapse_lowest()

    def _collapse_lowest(self) -> None:
        keys = sorted(self.buckets)
        lo, nxt = keys[0], keys[1]
        self.buckets[nxt] += self.buckets.pop(lo)

    def _bucket_value(self, k: int) -> float:
        return 2.0 * self.gamma ** k / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Return the ``q``-quantile (q in [0, 1]) of observed values."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        if rank < self.zero_count:
            return 0.0
        seen = float(self.zero_count)
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if seen > rank:
                return self._bucket_value(k)
        return self._bucket_value(max(self.buckets)) if self.buckets else 0.0

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0.0, "sum": 0.0}
        return {
            "count": float(self.count),
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


@dataclass
class Counter:
    """Monotonically increasing counter."""

    name: str
    help: str = ""
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only increase")
        self.value += float(amount)


@dataclass
class Gauge:
    """Set-to-current-value metric."""

    name: str
    help: str = ""
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)


@dataclass
class Histogram:
    """Distribution metric backed by a :class:`PercentileSketch`."""

    name: str
    help: str = ""
    rel_err: float = 0.01
    sketch: PercentileSketch = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.sketch is None:
            self.sketch = PercentileSketch(rel_err=self.rel_err)

    def observe(self, value: float) -> None:
        self.sketch.add(value)


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    safe = _NAME_RE.sub("_", name)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return safe


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    One shared namespace: asking for an existing name with a different
    metric type is an error (the same guard Prometheus client libraries
    apply), so publishers can't silently shadow each other.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, name: str, cls, **kwargs):
        existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}, not {cls.__name__}")
            return existing
        metric = cls(name=name, **kwargs)
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  rel_err: float = 0.01) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   rel_err=rel_err)

    def set_gauges(self, mapping: Mapping[str, Any],
                   prefix: str = "") -> int:
        """Bulk-publish numeric values from a dict as gauges.

        Non-numeric values are skipped; returns how many were set. This
        is how ledger summaries and engine telemetry dicts flow in
        without per-key plumbing.
        """
        n = 0
        for key, value in mapping.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            name = f"{prefix}.{key}" if prefix else str(key)
            self.gauge(name).set(float(value))
            n += 1
        return n

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # ---------------------------------------------------------- export
    def snapshot(self) -> Dict[str, float]:
        """Flat {name: value} dict; histograms expand to sub-keys."""
        out: Dict[str, float] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                for k, v in m.sketch.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (histograms as summary quantiles)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value}")
            else:
                s = m.sketch.summary()
                lines.append(f"# TYPE {pname} summary")
                for q in (0.5, 0.95, 0.99):
                    val = m.sketch.quantile(q) if m.sketch.count else 0.0
                    lines.append(f'{pname}{{quantile="{q}"}} {val}')
                lines.append(f"{pname}_sum {s.get('sum', 0.0)}")
                lines.append(f"{pname}_count {int(s.get('count', 0.0))}")
        return "\n".join(lines) + "\n"
