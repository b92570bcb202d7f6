"""PyTorch-port copy of ``repro.obs.trace`` (framework-free).

Structured control-plane tracing.

A zero-dependency span/event recorder for the decision path that the
paper's measurement methodology motivates: phase detection -> arbiter
grant -> replan verdict -> scheduled move round -> executed deltas.
Events are ring-bounded (bounded memory even on long serves), carry an
injected clock (deterministic tests, engine-virtual time), and export as
both JSONL (machine diffing / round-trips) and Chrome ``trace_event``
JSON (drop the file into chrome://tracing or Perfetto for a timeline).

Event phases follow the trace_event vocabulary we need:

- ``"i"``  instant   -- a decision point (grant, verdict, admit, ...)
- ``"X"``  complete  -- a span with explicit start + duration (moves,
                        rounds; the MoveScheduler's fluid schedule gives
                        exact start/finish times)
- ``"C"``  counter   -- a sampled numeric series

A recorder made with ``hot_spans=True`` also holds a hot path's spans
(``TraceRecorder.span``): each gets an integer ``id`` and the
``parent`` id of the innermost span still open on it, and goes into a
ring of its own (``spans``, evictions counted in ``spans_dropped``), so
that however many spans a long run records, they never evict a
control-plane event.  While a ``torch.profiler`` profile records, such
a span also opens the profiler's range ``"repro_torch." + name``, so it
appears among the profiler's host events, on the clock its device
events are aligned to.  A plain recorder's spans are events like any
other, and open no range.
"""
from __future__ import annotations

import json
import sys
from collections import deque
from contextlib import contextmanager, nullcontext
from itertools import chain
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterable, Iterator, List, Optional

__all__ = ["TraceEvent", "TraceRecorder", "hot_span", "qos_chains",
           "replan_chains"]

# the profiler range a span opens is named PROFILER_PREFIX + its name
PROFILER_PREFIX = "repro_torch."
_NO_SPAN = nullcontext()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` profile is recording (without
    importing torch: a process that never loaded it records none)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and bool(prof._is_profiler_enabled)


def _profiler_range(name: str):
    from torch.profiler import record_function
    return record_function(PROFILER_PREFIX + name)


def hot_span(tracer: Optional["TraceRecorder"], name: str, **args: Any):
    """A span at a hot-path site: into ``tracer`` with ``cat="span"``
    where spans are on; nothing (a shared no-op context) where they are
    off (``tracer`` None)."""
    if tracer is None:
        return _NO_SPAN
    return tracer.span(name, cat="span", **args)


def _json_safe(value: Any) -> Any:
    """Coerce a trace-arg value into something json.dumps accepts."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    # numpy scalars expose .item(); anything else degrades to repr.
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:  # pragma: no cover - defensive
            pass
    return repr(value)


@dataclass
class TraceEvent:
    """One structured event on the control-plane timeline."""

    name: str
    cat: str
    ts_s: float
    ph: str = "i"              # "i" instant | "X" complete | "C" counter
    dur_s: float = 0.0         # only meaningful for ph == "X"
    tid: str = "main"          # logical track (tenant, component, ...)
    args: Dict[str, Any] = field(default_factory=dict)
    id: Optional[int] = None       # a span's id (recorders with hot_spans)
    parent: Optional[int] = None   # the id of the span it opened inside

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "cat": self.cat,
            "ts_s": self.ts_s,
            "ph": self.ph,
            "tid": self.tid,
            "args": self.args,
        }
        if self.ph == "X":
            d["dur_s"] = self.dur_s
        if self.id is not None:
            d["id"] = self.id
        if self.parent is not None:
            d["parent"] = self.parent
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TraceEvent":
        return TraceEvent(
            name=d["name"],
            cat=d["cat"],
            ts_s=float(d["ts_s"]),
            ph=d.get("ph", "i"),
            dur_s=float(d.get("dur_s", 0.0)),
            tid=d.get("tid", "main"),
            args=dict(d.get("args", {})),
            id=d.get("id"),
            parent=d.get("parent"),
        )


class TraceRecorder:
    """Ring-bounded recorder of :class:`TraceEvent`.

    ``clock`` is injected so the engine can record in its virtual
    timebase and tests can use fake clocks; it defaults to a monotonic
    zero-origin clock. When the ring is full the oldest events are
    evicted and ``dropped`` counts them, so a misbehaving hot path can
    never grow memory unboundedly.  ``hot_spans``: spans nest by id and
    go into a ring of their own, ``max_events`` long (see the module's
    docstring).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: int = 65536, hot_spans: bool = False) -> None:
        if max_events <= 0:
            raise ValueError("max_events must be positive")
        if clock is None:
            import time

            t0 = time.monotonic()
            clock = lambda: time.monotonic() - t0  # noqa: E731
        self.clock = clock
        self.max_events = int(max_events)
        self.events: Deque[TraceEvent] = deque(maxlen=self.max_events)
        self.dropped = 0
        self.hot_spans = hot_spans
        self.spans: Deque[TraceEvent] = deque(maxlen=self.max_events)
        self.spans_dropped = 0
        self._open: List[int] = []     # ids of the open spans, innermost last
        self._next_id = 1

    def __len__(self) -> int:
        return len(self.events) + len(self.spans)

    def _all(self) -> Iterable[TraceEvent]:
        """The control-plane events, then the hot path's spans."""
        return chain(self.events, self.spans)

    # ---------------------------------------------------------- record
    def _push(self, ev: TraceEvent) -> TraceEvent:
        if len(self.events) == self.max_events:
            self.dropped += 1
        self.events.append(ev)
        return ev

    def event(self, name: str, cat: str = "obs", tid: str = "main",
              ts: Optional[float] = None, **args: Any) -> TraceEvent:
        """Record an instant event at ``ts`` (default: now)."""
        return self._push(TraceEvent(
            name=name, cat=cat, ph="i",
            ts_s=float(self.clock() if ts is None else ts),
            tid=tid, args={k: _json_safe(v) for k, v in args.items()},
        ))

    def complete(self, name: str, cat: str = "obs", tid: str = "main",
                 ts: float = 0.0, dur: float = 0.0,
                 **args: Any) -> TraceEvent:
        """Record a complete span with explicit start time + duration."""
        return self._push(TraceEvent(
            name=name, cat=cat, ph="X", ts_s=float(ts),
            dur_s=max(0.0, float(dur)), tid=tid,
            args={k: _json_safe(v) for k, v in args.items()},
        ))

    def counter(self, name: str, value: float, cat: str = "obs",
                tid: str = "main", ts: Optional[float] = None) -> TraceEvent:
        """Record a counter sample (rendered as a series in viewers)."""
        return self._push(TraceEvent(
            name=name, cat=cat, ph="C",
            ts_s=float(self.clock() if ts is None else ts),
            tid=tid, args={"value": float(value)},
        ))

    @contextmanager
    def span(self, name: str, cat: str = "obs", tid: str = "main",
             **args: Any) -> Iterator[Dict[str, Any]]:
        """Time a block of code as a complete event.

        Yields the args dict so the body can attach results before the
        span closes.
        """
        safe = {k: _json_safe(v) for k, v in args.items()}
        if not self.hot_spans:
            start = float(self.clock())
            try:
                yield safe
            finally:
                end = float(self.clock())
                self._push(TraceEvent(
                    name=name, cat=cat, ph="X", ts_s=start,
                    dur_s=max(0.0, end - start), tid=tid,
                    args={k: _json_safe(v) for k, v in safe.items()},
                ))
            return
        sid, self._next_id = self._next_id, self._next_id + 1
        parent = self._open[-1] if self._open else None
        self._open.append(sid)
        rng = _profiler_range(name) if _profiling() else None
        if rng is not None:
            rng.__enter__()
        start = float(self.clock())
        try:
            yield safe
        finally:
            end = float(self.clock())
            if rng is not None:
                rng.__exit__(None, None, None)
            self._open.pop()
            if len(self.spans) == self.max_events:
                self.spans_dropped += 1
            self.spans.append(TraceEvent(
                name=name, cat=cat, ph="X", ts_s=start,
                dur_s=max(0.0, end - start), tid=tid,
                args={k: _json_safe(v) for k, v in safe.items()},
                id=sid, parent=parent,
            ))

    # ----------------------------------------------------------- query
    def filter(self, name: Optional[str] = None, cat: Optional[str] = None,
               tid: Optional[str] = None) -> List[TraceEvent]:
        out = []
        for ev in self._all():
            if name is not None and ev.name != name:
                continue
            if cat is not None and ev.cat != cat:
                continue
            if tid is not None and ev.tid != tid:
                continue
            out.append(ev)
        return out

    # ---------------------------------------------------------- export
    def to_jsonl(self, path: str) -> int:
        """Write one JSON object per line; returns the event count."""
        n = 0
        with open(path, "w") as fh:
            for ev in self._all():
                fh.write(json.dumps(ev.to_dict(), sort_keys=True) + "\n")
                n += 1
        return n

    @staticmethod
    def read_jsonl(path: str) -> List[TraceEvent]:
        out: List[TraceEvent] = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(TraceEvent.from_dict(json.loads(line)))
        return out

    def to_chrome(self, path: str) -> int:
        """Write Chrome ``trace_event`` JSON (ts/dur in microseconds)."""
        events = []
        for ev in self._all():
            entry: Dict[str, Any] = {
                "name": ev.name,
                "cat": ev.cat,
                "ph": ev.ph,
                "ts": ev.ts_s * 1e6,
                "pid": 0,
                "tid": ev.tid,
                "args": ev.args,
            }
            if ev.ph == "X":
                entry["dur"] = ev.dur_s * 1e6
            if ev.ph == "i":
                entry["s"] = "t"  # instant scope: thread
            events.append(entry)
        meta: Dict[str, Any] = {"dropped_events": self.dropped}
        if self.hot_spans:
            meta["dropped_spans"] = self.spans_dropped
        with open(path, "w") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms",
                       "metadata": meta}, fh)
        return len(events)


def replan_chains(events: Iterable[TraceEvent]) -> Dict[int, Dict[str, List[TraceEvent]]]:
    """Group control-plane events by epoch into decision chains.

    Returns ``{epoch: {"phases": [...], "grants": [...], "decisions":
    [...], "rounds": [...], "moves": [...]}}`` — the reconstruction the
    acceptance criteria ask for: phase detection -> arbiter grant ->
    replan verdict -> scheduled move round -> executed migration moves.
    Events without an ``epoch`` arg are skipped.
    """
    slot_for = {
        "phase.update": "phases",
        "arbiter.grant": "grants",
        "replan.decision": "decisions",
        "movesched.round": "rounds",
        "movesched.move": "moves",
        "migration.move": "moves",
    }
    chains: Dict[int, Dict[str, List[TraceEvent]]] = {}
    for ev in events:
        slot = slot_for.get(ev.name)
        if slot is None or "epoch" not in ev.args:
            continue
        epoch = int(ev.args["epoch"])
        chain = chains.setdefault(epoch, {
            "phases": [], "grants": [], "decisions": [],
            "rounds": [], "moves": [],
        })
        chain[slot].append(ev)
    return chains


def qos_chains(events: Iterable[TraceEvent]
               ) -> List[Dict[str, Optional[TraceEvent]]]:
    """Pair each ``slo.violation`` with its ``qos.blame`` attribution.

    The BlameLedger fires synchronously from the SLO monitor's
    violation hook, so a blame event directly follows its violation on
    the timeline. Returns one ``{"violation": ev, "blame": ev-or-None,
    "saturations": [...]}`` entry per violation, where ``saturations``
    are the ``link.saturated`` events observed since the previous
    violation — the clamped-rho breadcrumbs leading into the excursion.
    """
    out: List[Dict[str, Any]] = []
    pending_sat: List[TraceEvent] = []
    for ev in events:
        if ev.name == "link.saturated":
            pending_sat.append(ev)
        elif ev.name == "slo.violation":
            out.append({"violation": ev, "blame": None,
                        "saturations": pending_sat})
            pending_sat = []
        elif ev.name == "qos.blame" and out and out[-1]["blame"] is None:
            out[-1]["blame"] = ev
    return out
