"""The device timeline of a traced window, from ``torch.profiler``.

``traced`` profiles a block (CPU and CUDA activity) and marks it with the
span ``bench/window``; ``Timeline`` reduces the profiler's events to what
the per-layer readers need: the device's operations (kernels, copies and
sets) inside the window, the union of their intervals (busy time), the
longest device operations by name, and the idle gaps labelled with the
innermost host span (the harness's ``bench/*`` spans or the program's own
ranges) that was open when the device went idle.
"""

from __future__ import annotations

import collections
import contextlib
import json
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench/window"
# The profiler's export, read back and deleted at once; inside the checkout.
TRACE_FILE = Path(__file__).resolve().parents[1] / "build" / "bench_trace" / "window.json"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[int, int]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merge intervals (ns) into disjoint, sorted ones."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in union(intervals))


def clip(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Timeline:
    """Events as (activity, name, start_ns, end_ns) tuples."""

    def __init__(self, events: Sequence[Tuple[str, str, int, int]]):
        windows = [(s, e) for a, n, s, e in events if a == "user_annotation" and n == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"expected one {WINDOW!r} span in the trace, found {len(windows)}")
        self.start, self.end = windows[0]
        inside = lambda s, e: e > self.start and s < self.end
        self.device_ops = [(a, n, s, e) for a, n, s, e in events
                           if a in DEVICE_OPS and inside(s, e)]
        self.host_spans = [(n, s, e) for a, n, s, e in events
                           if a == "user_annotation" and n != WINDOW]

    @classmethod
    def from_chrome_trace(cls, path) -> "Timeline":
        """From ``export_chrome_trace``'s file: its complete events' category,
        name, start and end (microseconds there)."""
        with open(path) as f:
            trace = json.load(f)
        events = []
        for e in trace["traceEvents"]:
            if e.get("ph") == "X" and "cat" in e:
                start = round(float(e["ts"]) * 1000)
                events.append((e["cat"], e["name"], start, start + round(float(e["dur"]) * 1000)))
        return cls(events)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def kernels(self, names: Optional[Sequence[str]] = None) -> List[Tuple[str, int, int]]:
        """Kernels in the window, those whose name holds one of ``names``
        when given."""
        return [(n, s, e) for a, n, s, e in self.device_ops if a == "kernel"
                and (names is None or any(k in n for k in names))]

    def busy_intervals(self) -> List[Interval]:
        return union(clip(((s, e) for _, _, s, e in self.device_ops), self.start, self.end))

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_busy_s(self) -> float:
        spans = clip(((s, e) for _, s, e in self.kernels()), self.start, self.end)
        return covered(spans) / 1e9

    def top_device_ops(self, n: int = 10) -> List[list]:
        total = collections.Counter()
        for _, name, s, e in self.device_ops:
            total[name[:200]] += e - s
        return [[name, ns / 1e9] for name, ns in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds inside the window summed by the innermost host span
        open at each gap's start, the largest ``n``."""
        busy = self.busy_intervals()
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.end:
            gaps.append((t, self.end))
        spans = sorted(self.host_spans, key=lambda x: x[1])
        total = collections.Counter()
        for gs, ge in gaps:
            label, width = "no host span", None
            for name, s, e in spans:
                if s > gs:
                    break
                if e > gs and (width is None or e - s < width):
                    label, width = name, e - s
            total[label] += ge - gs
        return [[name, ns / 1e9] for name, ns in total.most_common(n)]


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled`` and yield a holder whose
    ``timeline`` is set after it; the block runs inside ``bench/window``
    either way."""
    holder = type("Traced", (), {"timeline": None})()
    if not enabled:
        with record_function(WINDOW):
            yield holder
        return
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield holder
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    try:
        prof.export_chrome_trace(str(TRACE_FILE))
        holder.timeline = Timeline.from_chrome_trace(TRACE_FILE)
    finally:
        TRACE_FILE.unlink(missing_ok=True)
