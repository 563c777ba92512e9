"""The benchmark's own spans and the reduction of a device trace.

Spans are recorded from the benchmark's files, around its calls into the
program's layers, on a monotonic clock; while the profiler runs each span
is also a ``record_function`` range, so the device trace can name what
the host was doing in each idle gap.  A reader of ``layers/`` takes its
metric from the :class:`TraceData` of a ``--trace 1`` run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["TraceData", "Spans", "DeviceWindow", "union_seconds", "idle_pct"]


@dataclasses.dataclass
class TraceData:
    """Everything a ``layers/`` reader may read."""

    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    phases: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    spans: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    #: device kernels of the profiled window: (name, start_s, end_s)
    kernels: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    #: system-specific readings (counts, shapes, FLOPs) by name
    extras: Dict[str, object] = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, part: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``part``."""
        ds = [e - s for n, s, e in self.kernels if part in n]
        return sum(ds), len(ds)


class Spans:
    """Named host intervals on ``time.perf_counter``; ``enabled=False``
    records nothing and costs one branch."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: List[Tuple[str, float, float]] = []
        self.open: List[str] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        self.open.append(name)
        try:
            if self.profiling:
                import torch

                with torch.profiler.record_function(f"span:{name}"):
                    yield
            else:
                yield
        finally:
            self.open.pop()
        self.items.append((name, t0, time.perf_counter()))

    def wrap(self, owner, attr: str, name: str):
        """Replace ``owner.attr`` by a spanned call of itself; returns the
        undo."""
        orig = getattr(owner, attr)
        spans = self

        def spanned(*a, **kw):
            with spans.span(name):
                return orig(*a, **kw)

        setattr(owner, attr, spanned)
        return lambda: setattr(owner, attr, orig)


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class DeviceWindow:
    """A ``torch.profiler`` window over the device: started and stopped
    by the system module (inside the round loop, at a chosen launch),
    then reduced to kernels, busy seconds and the idle gaps by the span
    open during each."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = None
        self._ranges: List = []

    def start(self) -> None:
        import torch

        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            # the spans already open when the window starts, as ranges
            for name in self.spans.open:
                r = torch.profiler.record_function(f"span:{name}")
                r.__enter__()
                self._ranges.append(r)
            self.spans.profiling = True
            self.t0 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def stop(self) -> None:
        import torch

        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            while self._ranges:
                self._ranges.pop().__exit__(None, None, None)
            self.prof.stop()
            self.spans.profiling = False
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def reduce(self, data: TraceData, n_ops: int = 10, n_gaps: int = 10) -> Dict[str, list]:
        """Fill ``data``'s kernels, busy and window seconds; return the
        breakdown: device time by operation, and the longest idle gaps
        named by the innermost span open across each."""
        from torch.autograd import DeviceType

        kernels, ranges = [], []
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.name.startswith("span:"):
                # a span's range (the profiler also mirrors it on the
                # device's timeline, where it is no operation)
                if ev.device_type != DeviceType.CUDA:
                    ranges.append((ev.name[5:], tr.start * 1e-6, tr.end * 1e-6))
            elif ev.device_type == DeviceType.CUDA:
                kernels.append((ev.name, tr.start * 1e-6, tr.end * 1e-6))
        kernels.sort(key=lambda k: k[1])
        data.kernels = kernels
        data.window_s = self.t1 - self.t0
        data.busy_s = union_seconds([(s, e) for _n, s, e in kernels])
        by_op: Dict[str, float] = {}
        for n, s, e in kernels:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:n_ops]
        gaps = []
        end = kernels[0][2] if kernels else None
        for n, s, e in kernels[1:]:
            if s > end:
                mid = 0.5 * (s + end)
                open_ = [r for r in ranges if r[1] <= mid <= r[2]]
                label = min(open_, key=lambda r: r[2] - r[1])[0] if open_ else "outside spans"
                gaps.append((label, s - end))
            end = max(end, e)
        longest = sorted(gaps, key=lambda g: -g[1])[:n_gaps]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[label, g] for label, g in longest]}


def idle_pct(t: TraceData) -> Optional[float]:
    """Share of the profiled window with no device operation running, in
    %; None without a profiled window that ran something."""
    if not t or not t.window_s or not t.busy_s:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
