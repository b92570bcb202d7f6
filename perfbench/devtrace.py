"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
slice of the window, summarised in memory from the raw kineto events (no
chrome trace is written, no ``key_averages``).

  * busy: the union of every device interval (kernels, copies, memsets)
    inside the slice, so two streams that overlap count once;
  * device time by kernel, matched by substrings of the CUDA function
    names (``KERNELS``);
  * the breakdown on the result line: the device operations that took most
    time, and the idle gaps summed by what the host was doing (the
    harness's span, and the innermost host operation running when the
    gap began).
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

# the port's kernels: each entry point's CUDA functions (csrc/*.cu);
# a name is matched as a substring, the paged ones before the plain ones
KERNELS = {
    "paged_decode_attention": ("paged_decode_split_kernel",
                               "paged_decode_merge_kernel"),
    "decode_attention": ("decode_split_kernel", "decode_merge_kernel"),
    "flash_attention": ("flash_attention_kernel",),
    "fused_expert_ffn": ("expert_up_kernel", "expert_down_kernel"),
}
WINDOW = "perfbench.window"
SPAN_PREFIX = "perfbench."


def kernel_of(name: str) -> Optional[str]:
    for op, fns in KERNELS.items():
        if any(f in name for f in fns):
            if op == "decode_attention" and "paged_" in name:
                continue
            return op
    return None


def union_length(intervals: Sequence[Tuple[int, int]]) -> int:
    """Total length covered by half-open [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The idle stretches of [lo, hi) not covered by ``intervals``."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(device: List[Tuple[str, int, int]],
              host: List[Tuple[str, int, int]],
              window: Tuple[int, int], top: int = 10) -> Dict:
    """``device``: (name, start ns, end ns) of every device operation;
    ``host``: the same of host operations and harness spans (names that
    start with ``SPAN_PREFIX``); ``window``: the traced slice in the same
    clock.  Returns busy_s, window_s, kernel_s (by entry point) and the
    breakdown."""
    lo, hi = window
    clipped = [(n, max(s, lo), min(e, hi)) for n, s, e in device
               if e > lo and s < hi]
    iv = [(s, e) for _, s, e in clipped]
    busy = union_length(iv)
    by_name: Dict[str, int] = defaultdict(int)
    kernel_ns: Dict[str, int] = defaultdict(int)
    for n, s, e in clipped:
        by_name[n] += e - s
        k = kernel_of(n)
        if k is not None:
            kernel_ns[k] += e - s
    spans = sorted(((s, e, n) for n, s, e in host
                    if n.startswith(SPAN_PREFIX) and n != WINDOW))
    ops = sorted(((s, e, n) for n, s, e in host
                  if not n.startswith(SPAN_PREFIX)))
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]
    idle: Dict[str, int] = defaultdict(int)
    for a, b in gaps(iv, lo, hi):
        idle[f"{_at(spans, span_starts, a) or 'outside spans'} / "
             f"{_at(ops, op_starts, a) or 'python'}"] += b - a
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
        "breakdown": {
            "device_ops": [[n[:120], v / 1e9] for n, v in rank(by_name)],
            "idle_gaps": [[n[:120], v / 1e9] for n, v in rank(idle)]}}


def _at(events: List[Tuple[int, int, str]], starts: List[int], t: int
        ) -> Optional[str]:
    """The innermost (latest-starting) event running at time t; events
    sorted by start, ``starts`` their starts."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4096, -1), -1):
        if events[j][1] > t:
            return events[j][2]
    return None


class Slice:
    """``with Slice() as sl:`` profiles the block; ``sl.finish()`` reads
    the events once the window has closed (reading them takes seconds of
    host time) and returns the ``summarize`` result, None where the
    profiler saw no device operation.  ``span(name)`` marks a harness
    span inside."""

    def __init__(self, device="cuda"):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self.summary: Optional[Dict] = None

    def _sync(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._win = record_function(WINDOW)
        self._win.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._win.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        return False

    def finish(self) -> Optional[Dict]:
        self.summary = read(self._prof)
        self._prof = None
        return self.summary


def prewarm(device) -> None:
    """Start and stop the profiler once in set-up: its first start (the
    CUDA tracing library's initialisation) takes seconds, which would
    otherwise fall into the traced slice."""
    import torch
    with Slice(device):
        torch.ones(1, device=device).add_(1)


@contextlib.contextmanager
def span(name: str, on: bool):
    """A harness span in the trace (a no-op when the trace is off)."""
    if not on:
        yield
        return
    from torch.profiler import record_function
    with record_function(SPAN_PREFIX + name):
        yield


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver",
              "cuda_sync")


def _kind(e) -> str:
    """kineto's activity type of an event (older PyTorch does not expose
    it: then from the device type and the annotation flag)."""
    f = getattr(e, "activity_type", None)
    if f is not None:
        return f()
    annotation = e.is_user_annotation() or e.name().startswith(SPAN_PREFIX)
    if str(e.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if annotation else "kernel"
    return "user_annotation" if annotation else "cpu_op"


def read(prof) -> Optional[Dict]:
    """The raw events by kineto's activity type: kernels, copies and
    memsets on the device; host operations and the harness's annotations
    on the host (the profiler's device-side mirrors of annotations are
    neither).  The slice is the longest event named ``WINDOW``."""
    device, host, windows = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        s = e.start_ns()
        end = s + e.duration_ns()
        name = e.name()
        if kind in DEVICE_KINDS:
            device.append((name, s, end))
        elif kind not in HOST_KINDS:
            continue
        elif name == WINDOW:
            windows.append((s, end))
        else:
            host.append((name, s, end))
    if not device or not windows:
        return None
    return summarize(device, host, max(windows, key=lambda w: w[1] - w[0]))
