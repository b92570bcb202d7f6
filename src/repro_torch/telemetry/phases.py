"""PyTorch-port copy of ``repro.telemetry.phases`` (framework-free).

Workload-phase detection from trace deltas.

The paper's PMOs show static placement loses the moment the access
pattern shifts (PMO 1 vs PMO 5: which policy wins depends on the
workload's hot-set dynamics).  This module turns the access trace into
a phase signal the replanner can act on:

  * each completed epoch is summarized as a normalized per-object byte
    vector plus a coarse *label* from its aggregate character:
    ``random`` (CG/XSBench-style, latency-bound), ``write_heavy``
    (prefill / optimizer-update-style), ``streaming`` (MG/decode-style
    bandwidth-bound reads), or ``idle``;
  * a phase shift fires when the total-variation distance between
    consecutive epoch vectors exceeds ``threshold`` (request-mix /
    working-set drift) or the label flips (prefill -> decode,
    train -> eval), debounced by ``min_phase_epochs`` so transient
    epochs cannot thrash the replanner;
  * each epoch also gets a quantized **recurrence signature**
    (``traffic_signature``): label + log-bucketed intensity + coarse
    per-object shares.  The detector tracks how long each signature
    runs and which signature follows it, so ``expected_signature``
    can predict the *next* epoch's phase for a periodic workload —
    the signal the predictive ``TierBudgetArbiter`` and the
    replanner's phase prefetch consume to grant budgets and pre-stage
    promotions *before* a recurring burst's first epoch.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Hashable, List, Mapping, Optional

from .events import AccessTrace, ObjectTraffic


def classify_traffic(bucket: Mapping[str, ObjectTraffic]) -> str:
    """Coarse phase label from one epoch's aggregate traffic."""
    reads = sum(t.read_bytes for t in bucket.values())
    writes = sum(t.write_bytes for t in bucket.values())
    total = reads + writes
    if total <= 0:
        return "idle"
    rand = sum(t.random_bytes for t in bucket.values()) / total
    if rand > 0.5:
        return "random"
    if writes / total > 0.35:
        return "write_heavy"
    return "streaming"


def traffic_signature(bucket: Mapping[str, ObjectTraffic],
                      levels: int = 4,
                      mag_base: float = 4.0) -> Hashable:
    """Quantized recurrence signature of one epoch's traffic.

    Two epochs of the same workload phase should hash to the same
    signature even under modest noise, while phases that differ in
    *intensity* (a decode burst vs a drained lull with the same object
    mix) must not collide — the coarse label and the normalized share
    vector are blind to absolute traffic, so the signature also carries
    a log-bucketed magnitude (``mag_base`` = one bucket per ~4x traffic
    change).  Shares are rounded to ``levels`` steps per object.
    """
    label = classify_traffic(bucket)
    total = sum(t.total_bytes for t in bucket.values())
    if total <= 0:
        return (label, 0, ())
    mag = int(round(math.log(max(total, 1), mag_base)))
    shares = tuple(sorted(
        (obj, q) for obj, t in bucket.items()
        if (q := round(t.total_bytes / total * levels)) > 0))
    return (label, mag, shares)


def traffic_distance(a: Mapping[str, float],
                     b: Mapping[str, float]) -> float:
    """Total-variation distance between two normalized traffic vectors
    (0 = identical mix, 1 = disjoint working sets)."""
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys)


@dataclasses.dataclass(frozen=True)
class PhaseShift:
    """One detected phase boundary."""

    epoch: int
    distance: float
    old_label: str
    new_label: str


class PhaseDetector:
    """Online phase tracking over an AccessTrace.

    Call ``update()`` once per completed epoch (after
    ``advance_epoch``); it returns a PhaseShift when a boundary is
    crossed, else None.
    """

    def __init__(self, trace: AccessTrace, threshold: float = 0.35,
                 min_phase_epochs: int = 2,
                 max_signatures: int = 32,
                 signature_ttl_epochs: int = 256):
        self.trace = trace
        self.threshold = threshold
        self.min_phase_epochs = min_phase_epochs
        self.phase_id = 0
        self.label = "idle"
        self.shifts: List[PhaseShift] = []
        self._prev_vec: Optional[Dict[str, float]] = None
        self._epochs_in_phase = 0
        self._last_seen_epoch = -1
        # recurrence tracking: the signature of the last completed
        # epoch, how long its run has lasted, observed run lengths per
        # signature, and which signature historically follows which
        self.signature: Optional[Hashable] = None
        self.max_signatures = max_signatures
        self.signature_ttl_epochs = signature_ttl_epochs
        self._sig_run = 0
        self._sig_durations: Dict[Hashable, Deque[int]] = {}
        self._sig_successor: Dict[Hashable, Dict[Hashable, int]] = {}
        self._sig_seen: Dict[Hashable, int] = {}

    def _observe_signature(self, epoch_id: int, bucket) -> None:
        sig = traffic_signature(bucket)
        if sig == self.signature:
            self._sig_run += 1
        else:
            prev = self.signature
            if prev is not None and self._sig_run > 0:
                self._sig_durations.setdefault(
                    prev, deque(maxlen=8)).append(self._sig_run)
                succ = self._sig_successor.setdefault(prev, {})
                succ[sig] = succ.get(sig, 0) + 1
            self.signature = sig
            self._sig_run = 1
        self._sig_seen[sig] = epoch_id
        self._evict_stale_signatures(epoch_id)

    def _evict_stale_signatures(self, epoch_id: int) -> None:
        """Drop recurrence state for signatures not seen recently: a
        workload that stopped recurring must not keep predicting, and
        the tables stay bounded on long-lived processes."""
        stale = {s for s, last in self._sig_seen.items()
                 if epoch_id - last > self.signature_ttl_epochs}
        if len(self._sig_seen) - len(stale) > self.max_signatures:
            keep = sorted(self._sig_seen, key=self._sig_seen.get,
                          reverse=True)[: self.max_signatures]
            stale |= set(self._sig_seen) - set(keep) - {self.signature}
        for s in stale:
            self._sig_seen.pop(s, None)
            self._sig_durations.pop(s, None)
            self._sig_successor.pop(s, None)
        for succ in self._sig_successor.values():
            for s in stale:
                succ.pop(s, None)

    def typical_duration(self, sig: Hashable) -> Optional[int]:
        """Median observed run length of ``sig`` (None if never ended)."""
        runs = self._sig_durations.get(sig)
        if not runs:
            return None
        return sorted(runs)[len(runs) // 2]

    def likely_successor(self, sig: Hashable) -> Optional[Hashable]:
        """The signature that most often followed ``sig``."""
        succ = self._sig_successor.get(sig)
        if not succ:
            return None
        return max(sorted(succ), key=succ.get)

    def expected_signature(self, ahead: int = 1) -> Optional[Hashable]:
        """Signature predicted for the epoch ``ahead`` steps after the
        last completed one (``ahead=1`` = the epoch about to run).

        Walks the learned recurrence forward: while the current
        signature's run has not reached its typical duration the phase
        is expected to continue; once it has, the most common successor
        takes over.  Falls back to "more of the same" whenever duration
        or successor is unknown — the reactive behaviour.
        """
        sig, run = self.signature, self._sig_run
        if sig is None:
            return None
        for _ in range(max(ahead, 0)):
            dur = self.typical_duration(sig)
            succ = self.likely_successor(sig)
            if dur is not None and succ is not None and run + 1 > dur:
                sig, run = succ, 1
            else:
                run += 1
        return sig

    def update(self) -> Optional[PhaseShift]:
        if self.trace.epochs_recorded == 0:
            return None
        epoch_id, bucket = self.trace.buckets(1)[0]
        if epoch_id == self._last_seen_epoch:
            return None                      # nothing new completed
        self._last_seen_epoch = epoch_id
        self._observe_signature(epoch_id, bucket)
        vec = self.trace.epoch_vector(bucket)
        label = classify_traffic(bucket)
        shift: Optional[PhaseShift] = None
        if self._prev_vec is not None:
            d = traffic_distance(self._prev_vec, vec)
            moved = d > self.threshold or (label != self.label
                                           and label != "idle")
            if moved and self._epochs_in_phase >= self.min_phase_epochs:
                shift = PhaseShift(epoch_id, d, self.label, label)
                self.shifts.append(shift)
                self.phase_id += 1
                self._epochs_in_phase = 0
        elif label != "idle":
            self.label = label
        if shift is not None:
            self.label = label
        self._prev_vec = vec
        self._epochs_in_phase += 1
        return shift

    @property
    def epochs_in_phase(self) -> int:
        return self._epochs_in_phase

    @property
    def epochs_in_signature(self) -> int:
        """Run length of the current recurrence signature."""
        return self._sig_run
