"""PyTorch-port copy of ``repro.serving.metrics``.

Serving metrics: per-request latency, throughput, pool + migration.

Timestamps are injected by the caller (wall clock in the engine, a
simulated clock in the trace-driven benchmark), so the same aggregator
serves both and stays deterministic under test.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]); 0.0 when empty."""
    if not values:
        return 0.0
    return float(np.percentile(values, q))


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    arrival_s: float = 0.0
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    last_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    prompt_tokens: int = 0
    new_tokens: int = 0
    preemptions: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (queueing + prefill)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s

    @property
    def decode_tok_s(self) -> Optional[float]:
        """Tokens/s over the decode span (first token -> finish)."""
        if self.finished_s is None or self.first_token_s is None:
            return None
        span = self.finished_s - self.first_token_s
        if self.new_tokens <= 1:
            return None
        return (self.new_tokens - 1) / max(span, 1e-9)


@dataclasses.dataclass
class PoolSample:
    step: int
    used_blocks: int
    fast_blocks: int
    running: int
    waiting: int


class ServingMetrics:
    """Aggregates request lifecycles, pool occupancy, and migration.

    ``registry`` (a repro.obs.MetricsRegistry) and ``slo`` (a
    repro.obs.SLOMonitor) are optional sinks: when attached, request
    lifecycle events also stream into central histograms (TTFT,
    inter-token decode gap, end-to-end latency) and the live SLO
    windows, without changing any of the aggregate math here.
    """

    def __init__(self, registry=None, slo=None,
                 max_decode_gaps: int = 65536):
        self.requests: Dict[int, RequestMetrics] = {}
        self.samples: List[PoolSample] = []
        # retained inter-token gaps: exact tail quantiles (p95/p99)
        # over a bounded window — the QoS plane's victim-tail metric
        self.decode_gaps: Deque[float] = deque(
            maxlen=int(max_decode_gaps))
        self.iterations = 0
        self.prefills = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.start_s: Optional[float] = None
        self.end_s: Optional[float] = None
        self.registry = registry
        self.slo = slo

    # ------------------------------------------------------------------ #
    def on_submit(self, rid: int, arrival_s: float,
                  prompt_tokens: int) -> None:
        self.requests[rid] = RequestMetrics(
            rid=rid, arrival_s=arrival_s, prompt_tokens=prompt_tokens)
        if self.start_s is None or arrival_s < self.start_s:
            self.start_s = arrival_s

    def on_admit(self, rid: int, now_s: float) -> None:
        r = self.requests[rid]
        if r.admitted_s is None:      # keep the first admission (TTFT)
            r.admitted_s = now_s
        self.prefills += 1

    def on_token(self, rid: int, now_s: float) -> None:
        r = self.requests[rid]
        if r.first_token_s is None:
            r.first_token_s = now_s
            ttft = now_s - r.arrival_s
            if self.registry is not None:
                self.registry.histogram(
                    "serving.ttft_s", help="time to first token").observe(ttft)
            if self.slo is not None:
                self.slo.observe("ttft", ttft, now=now_s)
        elif r.last_token_s is not None:
            gap = now_s - r.last_token_s
            self.decode_gaps.append(gap)
            if self.registry is not None:
                self.registry.histogram(
                    "serving.decode_gap_s",
                    help="inter-token decode latency").observe(gap)
            if self.slo is not None:
                self.slo.observe("decode_latency", gap, now=now_s)
        r.last_token_s = now_s
        r.new_tokens += 1
        self.decode_tokens += 1

    def on_preempt(self, rid: int, now_s: float = 0.0) -> None:
        """Record a preemption as it happens (not only at finish), so
        preempted-but-unfinished requests show up in the summary."""
        r = self.requests.get(rid)
        if r is not None:
            r.preemptions += 1
        if self.registry is not None:
            self.registry.counter(
                "serving.preemptions", help="request evictions").inc()

    def on_finish(self, rid: int, now_s: float, preemptions: int) -> None:
        r = self.requests[rid]
        r.finished_s = now_s
        # the scheduler's count is authoritative; on_preempt keeps the
        # live count, so take whichever saw more
        r.preemptions = max(r.preemptions, preemptions)
        if self.end_s is None or now_s > self.end_s:
            self.end_s = now_s
        if self.registry is not None:
            self.registry.counter(
                "serving.finished", help="completed requests").inc()
            if r.latency_s is not None:
                self.registry.histogram(
                    "serving.latency_s",
                    help="end-to-end request latency").observe(r.latency_s)

    def on_iteration(self, step: int, used_blocks: int, fast_blocks: int,
                     running: int, waiting: int) -> None:
        self.iterations += 1
        if running:
            self.decode_steps += 1
        self.samples.append(PoolSample(step, used_blocks, fast_blocks,
                                       running, waiting))

    # ------------------------------------------------------------------ #
    def aggregate_decode_tok_s(self) -> float:
        """New tokens per second of wall time across the whole trace."""
        if self.start_s is None or self.end_s is None:
            return 0.0
        return self.decode_tokens / max(self.end_s - self.start_s, 1e-9)

    def mean_occupancy(self) -> float:
        if not self.samples:
            return 0.0
        return sum(s.used_blocks for s in self.samples) / len(self.samples)

    def summary(self, tiering: Optional[Dict[str, int]] = None
                ) -> Dict[str, float]:
        done = [r for r in self.requests.values()
                if r.finished_s is not None]
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        lats = [r.latency_s for r in done if r.latency_s is not None]
        toks = [r.decode_tok_s for r in done
                if r.decode_tok_s is not None]
        out: Dict[str, float] = {
            "requests": float(len(self.requests)),
            "finished": float(len(done)),
            "iterations": float(self.iterations),
            "decode_tokens": float(self.decode_tokens),
            "throughput_tok_s": self.aggregate_decode_tok_s(),
            "mean_ttft_s": (sum(ttfts) / len(ttfts)) if ttfts else 0.0,
            "p50_ttft_s": percentile(ttfts, 50),
            "p95_ttft_s": percentile(ttfts, 95),
            "p99_ttft_s": percentile(ttfts, 99),
            "p50_latency_s": percentile(lats, 50),
            "p95_latency_s": percentile(lats, 95),
            "p99_latency_s": percentile(lats, 99),
            "p95_decode_gap_s": percentile(list(self.decode_gaps), 95),
            "p99_decode_gap_s": percentile(list(self.decode_gaps), 99),
            "mean_decode_tok_s": (sum(toks) / len(toks)) if toks else 0.0,
            "p50_decode_tok_s": percentile(toks, 50),
            "p95_decode_tok_s": percentile(toks, 95),
            "mean_pool_blocks": self.mean_occupancy(),
            # all requests, not just finished: a preempted request that
            # never re-finished must still count
            "preemptions": float(sum(r.preemptions
                                     for r in self.requests.values())),
        }
        if tiering:
            for k, v in tiering.items():
                out[f"tiering.{k}"] = float(v)
            # tiering overhead per unit of useful work: how many bytes
            # were migrated for each generated token
            out["migrated_bytes_per_token"] = (
                float(tiering.get("migrated_bytes", 0))
                / max(self.decode_tokens, 1))
        return out

    def per_request_rows(self) -> List[Tuple[int, Dict[str, float]]]:
        """Exportable per-request rows.

        ``ttft_s`` / ``decode_tok_s`` are *omitted* (not sentinel
        ``-1.0``) when undefined, so downstream tooling can never
        mistake a never-started request for a negative latency.
        """
        rows = []
        for rid in sorted(self.requests):
            r = self.requests[rid]
            row: Dict[str, float] = {
                "prompt_tokens": float(r.prompt_tokens),
                "new_tokens": float(r.new_tokens),
                "preemptions": float(r.preemptions),
            }
            if r.ttft_s is not None:
                row["ttft_s"] = r.ttft_s
            if r.decode_tok_s is not None:
                row["decode_tok_s"] = r.decode_tok_s
            rows.append((rid, row))
        return rows
