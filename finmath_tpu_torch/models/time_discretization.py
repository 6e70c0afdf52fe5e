"""Time discretization: an immutable, sorted grid of model times.

Equivalent of finmath-lib's ``TimeDiscretizationFromArray``, copied
unchanged from ``finmath_tpu.models.time_discretization`` (host-side Python;
the tests hold the two bit for bit). Times are plain
Python floats — filtration bookkeeping never touches the device — with a
tick-size rounding rule so that times produced by different arithmetic agree
exactly (finmath uses the same trick with a default tick of 1/(365*24)... we
use a configurable decimal tick, default 1e-8).
"""

from __future__ import annotations

import bisect
from typing import Iterable, Sequence

import numpy as np

DEFAULT_TICK = 1e-8


class TimeDiscretization:
    """Immutable strictly-increasing sequence of times."""

    __slots__ = ("_times", "_tick")

    def __init__(self, times: Iterable[float] = None, *, initial: float = None,
                 num_steps: int = None, step: float = None, tick: float = DEFAULT_TICK):
        self._tick = tick
        if times is None:
            if initial is None or num_steps is None or step is None:
                raise ValueError(
                    "provide either times or (initial, num_steps, step)"
                )
            times = [initial + i * step for i in range(num_steps + 1)]
        rounded = sorted({self._round(t) for t in times})
        self._times = tuple(rounded)

    def _round(self, t: float) -> float:
        return round(t / self._tick) * self._tick

    # ------------------------------------------------------------------
    def get_number_of_times(self) -> int:
        return len(self._times)

    def get_number_of_time_steps(self) -> int:
        return len(self._times) - 1

    def get_time(self, index: int) -> float:
        return self._times[index]

    def get_time_step(self, index: int) -> float:
        return self._times[index + 1] - self._times[index]

    def get_time_index(self, time: float) -> int:
        """Index of `time`; negative insertion-point encoding (like
        java.util.Arrays.binarySearch) when absent."""
        t = self._round(time)
        i = bisect.bisect_left(self._times, t)
        if i < len(self._times) and self._times[i] == t:
            return i
        return -i - 1

    def get_time_index_nearest_less_or_equal(self, time: float) -> int:
        t = self._round(time)
        i = bisect.bisect_right(self._times, t) - 1
        return max(i, 0)

    def get_time_index_nearest_greater_or_equal(self, time: float) -> int:
        t = self._round(time)
        i = bisect.bisect_left(self._times, t)
        return min(i, len(self._times) - 1)

    def get_first_time(self) -> float:
        return self._times[0]

    def get_last_time(self) -> float:
        return self._times[-1]

    def as_array(self) -> np.ndarray:
        return np.asarray(self._times, dtype=np.float64)

    def get_step_sizes(self) -> np.ndarray:
        a = self.as_array()
        return a[1:] - a[:-1]

    def union(self, other: "TimeDiscretization") -> "TimeDiscretization":
        return TimeDiscretization(list(self._times) + list(other._times), tick=min(self._tick, other._tick))

    def intersection(self, other: "TimeDiscretization") -> "TimeDiscretization":
        common = set(self._times) & set(other._times)
        return TimeDiscretization(sorted(common), tick=min(self._tick, other._tick))

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._times)

    def __iter__(self):
        return iter(self._times)

    def __getitem__(self, i):
        return self._times[i]

    def __contains__(self, t):
        return self.get_time_index(t) >= 0

    def __eq__(self, other):
        return isinstance(other, TimeDiscretization) and self._times == other._times

    def __hash__(self):
        return hash(self._times)

    def __repr__(self):
        if len(self._times) > 6:
            head = ", ".join(f"{t:g}" for t in self._times[:3])
            return f"TimeDiscretization([{head}, ..., {self._times[-1]:g}], n={len(self._times)})"
        return f"TimeDiscretization({list(self._times)})"

    # finmath-style aliases
    getNumberOfTimes = get_number_of_times
    getNumberOfTimeSteps = get_number_of_time_steps
    getTime = get_time
    getTimeStep = get_time_step
    getTimeIndex = get_time_index
    getFirstTime = get_first_time
    getLastTime = get_last_time
