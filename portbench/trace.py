"""Reading a ``torch.profiler`` trace of the measured window: the device
operations (kernels, copies, sets) with their times, the benchmark's host
ranges (``portbench.*``), the device's busy time as the union of its
operations' intervals, and the idle gaps named by the innermost host
range they fall in."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "portbench.window"


@dataclass
class Trace:
    window: tuple                       # (start_ns, end_ns)
    device_ops: list = field(default_factory=list)    # (name, start, dur)
    ranges: list = field(default_factory=list)        # (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _clipped(self):
        lo, hi = self.window
        out = []
        for name, s, d in self.device_ops:
            a, b = max(s, lo), min(s + d, hi)
            if b > a:
                out.append((a, b))
        return sorted(out)

    def busy_intervals(self):
        merged = []
        for a, b in self._clipped():
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, pattern) -> tuple:
        """(launches, seconds) of the device operations whose name matches
        the compiled regex ``pattern``."""
        hits = [d for name, s, d in self.device_ops
                if s >= self.window[0] and s < self.window[1]
                and pattern.search(name)]
        return len(hits), sum(hits) * 1e-9

    def top_ops(self, k=10):
        by = defaultdict(int)
        for name, s, d in self.device_ops:
            if self.window[0] <= s < self.window[1]:
                by[name[:120]] += d
        return [[n, v * 1e-9] for n, v in
                sorted(by.items(), key=lambda t: -t[1])[:k]]

    def idle_by_range(self, k=10):
        """Idle device seconds in the window, summed by the innermost
        benchmark host range open at each gap's middle."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        ranges = sorted((r for r in self.ranges if r[0] != WINDOW),
                        key=lambda r: r[1])
        by = defaultdict(int)
        for a, b in gaps:
            mid = (a + b) // 2
            inner = None
            for name, s, e in ranges:
                if s > mid:
                    break
                if e >= mid and (inner is None or s >= inner[1]):
                    inner = (name, s)
            by[inner[0] if inner else "outside portbench ranges"] += b - a
        return [[n, v * 1e-9] for n, v in
                sorted(by.items(), key=lambda t: -t[1])[:k]]


def read(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``: device events
    are those on a CUDA device, less the device copies of the benchmark's
    own ranges; host ranges the CPU events named ``portbench.*``."""
    ops, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = "CUDA" in str(e.device_type())
        mine = name.startswith("portbench.")
        if on_device and not mine:
            ops.append((name, e.start_ns(), e.duration_ns()))
        elif mine and not on_device:
            ranges.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    window = [r for r in ranges if r[0] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no portbench.window range")
    return Trace(window=(window[0][1], window[0][2]), device_ops=ops,
                 ranges=ranges)
