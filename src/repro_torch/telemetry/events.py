"""PyTorch-port copy of ``repro.telemetry.events`` (framework-free).

Access-event recording: the shared profiling substrate.

The paper derives placement from *application semantics*; its §VI study
(and "Dissecting CXL Memory Performance at Scale") shows production
placement must instead follow **observed** access heat.  This module is
the observation side: emitters (the serving KV pool, the offload
engines, benchmark workloads) record per-object access events, bucketed
into *epochs* (one scheduler iteration / train step / benchmark step),
and consumers (phase detection, the adaptive replanner) read aggregated
per-object traffic back out as ``core.objects.DataObject`` inventories.

The trace is a ring buffer of epoch buckets: memory stays bounded on a
production run, and old epochs age out exactly like a PEBS/hint-fault
history would.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple

from ..core.objects import DataObject


@dataclasses.dataclass(frozen=True)
class AccessEvent:
    """One recorded access aggregate against a named object."""

    obj: str
    read_bytes: int = 0
    write_bytes: int = 0
    random_fraction: float = 0.0
    phase: str = ""            # emitter tag: "prefill" / "decode" / ...
    block: Optional[int] = None

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes


@dataclasses.dataclass
class ObjectTraffic:
    """Aggregated traffic for one object over one or more epochs."""

    read_bytes: int = 0
    write_bytes: int = 0
    random_bytes: float = 0.0  # random-weighted bytes (rf * total)
    events: int = 0
    epochs: int = 1

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes

    @property
    def random_fraction(self) -> float:
        return self.random_bytes / max(self.total_bytes, 1)

    @property
    def read_bytes_per_epoch(self) -> float:
        return self.read_bytes / max(self.epochs, 1)

    @property
    def write_bytes_per_epoch(self) -> float:
        return self.write_bytes / max(self.epochs, 1)

    def add(self, ev: AccessEvent) -> None:
        self.read_bytes += ev.read_bytes
        self.write_bytes += ev.write_bytes
        self.random_bytes += ev.random_fraction * ev.total_bytes
        self.events += 1

    def merge(self, other: "ObjectTraffic") -> None:
        self.read_bytes += other.read_bytes
        self.write_bytes += other.write_bytes
        self.random_bytes += other.random_bytes
        self.events += other.events


EpochBucket = Dict[str, ObjectTraffic]


class AccessTrace:
    """Ring-buffered, epoch-bucketed access recorder.

    ``record`` adds an event to the *current* (open) epoch;
    ``advance_epoch`` closes it and pushes it into the ring (capacity
    ``capacity_epochs`` — the oldest bucket is dropped when full, and
    ``dropped_epochs`` counts the loss so consumers can tell a short
    history from a truncated one).
    """

    def __init__(self, capacity_epochs: int = 256):
        if capacity_epochs <= 0:
            raise ValueError("capacity_epochs must be positive")
        self.capacity_epochs = capacity_epochs
        self._ring: Deque[Tuple[int, EpochBucket]] = deque(
            maxlen=capacity_epochs)
        self._current: EpochBucket = {}
        self.epoch = 0             # id of the open epoch
        self.total_events = 0
        self.dropped_epochs = 0
        self.phase_events: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    # recording                                                          #
    # ------------------------------------------------------------------ #
    def record(self, obj: str, read_bytes: int = 0, write_bytes: int = 0,
               random_fraction: float = 0.0, phase: str = "",
               block: Optional[int] = None) -> None:
        ev = AccessEvent(obj, int(read_bytes), int(write_bytes),
                         float(random_fraction), phase, block)
        if ev.total_bytes <= 0:
            return
        self._current.setdefault(obj, ObjectTraffic()).add(ev)
        self.total_events += 1
        if phase:
            self.phase_events[phase] = self.phase_events.get(phase, 0) + 1

    # the emitter-facing alias shared with AccessSampler, so a pool or
    # engine can be handed either a raw trace or a sampling front-end
    observe = record

    def forget(self, obj: str) -> None:
        """Retire an object (interface shared with AccessSampler).

        History already in the ring stays — it is bounded and still
        describes past epochs — but the open bucket drops the object so
        a retired sequence cannot appear in the epoch that closes after
        its teardown."""
        self._current.pop(obj, None)

    def advance_epoch(self) -> int:
        """Close the current epoch; returns the id of the new open epoch."""
        if len(self._ring) == self._ring.maxlen:
            self.dropped_epochs += 1
        self._ring.append((self.epoch, self._current))
        self._current = {}
        self.epoch += 1
        return self.epoch

    # ------------------------------------------------------------------ #
    # reading                                                            #
    # ------------------------------------------------------------------ #
    @property
    def epochs_recorded(self) -> int:
        """Completed epochs still in the ring."""
        return len(self._ring)

    def buckets(self, window: Optional[int] = None
                ) -> List[Tuple[int, EpochBucket]]:
        """The last `window` completed epoch buckets (all if None)."""
        items = list(self._ring)
        if window is not None:
            items = items[-window:]
        return items

    def last_completed(self) -> Optional[EpochBucket]:
        return self._ring[-1][1] if self._ring else None

    def object_traffic(self, window: Optional[int] = None
                       ) -> Dict[str, ObjectTraffic]:
        """Per-object traffic aggregated over the window, with ``epochs``
        set so the per-epoch means divide correctly."""
        buckets = self.buckets(window)
        out: Dict[str, ObjectTraffic] = {}
        for _, bucket in buckets:
            for obj, t in bucket.items():
                agg = out.setdefault(obj, ObjectTraffic(epochs=0))
                agg.merge(t)
        n = max(len(buckets), 1)
        for agg in out.values():
            agg.epochs = n
        return out

    def epoch_vector(self, bucket: Optional[EpochBucket] = None
                     ) -> Dict[str, float]:
        """Normalized per-object byte shares of one epoch (for phase
        detection: request-mix / working-set drift shows up here)."""
        if bucket is None:
            bucket = self.last_completed() or {}
        total = sum(t.total_bytes for t in bucket.values())
        if total <= 0:
            return {}
        return {obj: t.total_bytes / total for obj, t in bucket.items()}

    # ------------------------------------------------------------------ #
    # bridge to the analytic layer                                       #
    # ------------------------------------------------------------------ #
    def to_data_objects(self, nbytes: Mapping[str, int],
                        window: Optional[int] = None,
                        pin_fast: Iterable[str] = (),
                        groups: Optional[Mapping[str, str]] = None,
                        group: str = "observed") -> List[DataObject]:
        """Rebuild DataObjects from *measured* traffic.

        ``nbytes`` names the placeable objects and their footprints (the
        trace only knows traffic); objects without observed traffic come
        back with zero per-step bytes — the planner treats them as cold.
        """
        traffic = self.object_traffic(window)
        pins = set(pin_fast)
        objs: List[DataObject] = []
        for name in nbytes:
            t = traffic.get(name)
            objs.append(DataObject(
                name=name, nbytes=int(nbytes[name]),
                read_bytes_per_step=int(t.read_bytes_per_epoch) if t else 0,
                write_bytes_per_step=int(t.write_bytes_per_epoch) if t
                else 0,
                random_fraction=t.random_fraction if t else 0.0,
                pin_fast=name in pins,
                group=(groups or {}).get(name, group)))
        return objs
