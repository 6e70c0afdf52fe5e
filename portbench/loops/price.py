"""A closed loop of one client whose requests are single prices, each
with a fresh 64-bit kernel seed derived from the run's seed and fetched
to the host before the next is issued; any request may end the window.

End to end: ``price_ms``, the window over the prices in it, and
``price_p95_ms``, the 95th percentile of every price's latency."""

from __future__ import annotations

import math

from seeds import ORDER, seed_words

_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Loop:
    def __init__(self, target, traffic: dict, seed):
        self.target = target
        self.base = seed_words(seed)[ORDER]

    def request(self, k: int) -> dict:
        """Request k (k < 0: warm-up requests, seeds of their own)."""
        return self.target.request((self.base + (k + 1024) * _GOLDEN)
                                   & _MASK64)

    def ends_window(self, k: int) -> bool:
        return True

    @staticmethod
    def end_to_end(window_s: float, latencies: list) -> dict:
        return {"price_ms": (1e3 * window_s / len(latencies), "ms"),
                "price_p95_ms": (1e3 * percentile(latencies, 95.0), "ms")}
