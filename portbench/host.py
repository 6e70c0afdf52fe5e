"""Readings of the host during the measured window, printed on standard
error beside each run's result, to tell a slower host from slower work:

* ``probe_us``: the time of a fixed pure-Python loop of 10,000 additions,
  taken between requests at most once a second; it follows the speed
  that one host core gives this process;
* ``cpu_pct``: this process's CPU time over the wall between readings;
* the garbage collector's collections and seconds in the window."""

from __future__ import annotations

import gc
import time


def _probe() -> float:
    t0 = time.perf_counter()
    x = 0
    for i in range(10_000):
        x += i
    return time.perf_counter() - t0


class HostWatch:
    def __init__(self):
        self.samples = []
        self.gc_n = 0
        self.gc_s = 0.0
        self._gc_t0 = None

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_n += 1
            self.gc_s += time.perf_counter() - self._gc_t0

    def _take(self, t: float) -> None:
        self.samples.append((t, time.process_time(), _probe()))

    def start(self) -> None:
        gc.callbacks.append(self._gc)
        self._take(time.perf_counter())

    def tick(self, t: float) -> None:
        """Called between requests: a reading at most once a second."""
        if t - self.samples[-1][0] >= 1.0:
            self._take(t)

    def stop(self) -> None:
        self._take(time.perf_counter())
        gc.callbacks.remove(self._gc)

    def lines(self) -> list:
        pairs = list(zip(self.samples, self.samples[1:]))
        probe = [1e6 * p1 for _, (_, _, p1) in pairs]
        cpu = [100 * (c1 - c0) / (t1 - t0)
               for (t0, c0, _), (t1, c1, _) in pairs]
        return ["host probe_us: " + " ".join(f"{v:.3g}" for v in probe),
                "host cpu_pct: " + " ".join(f"{v:.3g}" for v in cpu),
                f"host gc in the window: {self.gc_n} collections, "
                f"{self.gc_s:.4g} s"]
