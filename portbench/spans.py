"""The benchmark's own spans and counters around the calls into each layer
of the program: a ``torch.profiler.record_function`` range named
``portbench.<layer>`` (so the device trace can name what the host did),
the host seconds and calls per layer, plain counters, and the kernel
launches each wrapped call makes with their batch sizes (for the
rooflines)."""

from __future__ import annotations

import time
from collections import defaultdict
from types import SimpleNamespace

from torch.profiler import record_function


class Recorder:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.counters = defaultdict(int)
        self.launches = []          # (kernel, batch) of each wrapped call

    def snapshot(self):
        """What has been recorded since the last reset."""
        return SimpleNamespace(seconds=dict(self.seconds),
                               calls=dict(self.calls),
                               counters=dict(self.counters),
                               launches=list(self.launches))

    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] += k

    def timed(self, layer: str, fn, *, calls: str = None, launches=None):
        """``fn`` inside the span ``portbench.<layer>``; its host seconds
        and calls add up under ``layer``. ``launches`` = (kernel, batch):
        the one launch each call makes. ``fn`` returns host values, so its
        wall includes the device work it waits for."""
        name = f"portbench.{layer}"

        def wrapped(*args, **kwargs):
            with record_function(name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.seconds[layer] += time.perf_counter() - t0
            self.calls[layer] += 1
            if calls:
                self.counters[calls] += 1
            if launches:
                self.launches.append(launches)
            return out
        return wrapped
