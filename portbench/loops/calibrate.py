"""A closed loop of one client whose requests are whole calibrations.

The target (``systems/<system>/calibrate.py``) holds ``realizations``
fixed input sets; each cycle of requests visits every set once, in an
order drawn from the run's seed, and the window ends with a cycle, so
that every seed does the same calibrations in another order (the work of
one calibration depends on its inputs). A request ``k < 0`` is a warm-up
on set 0.

End to end: ``calibration_s``, the window over the calibrations in it."""

from __future__ import annotations

import numpy as np

from seeds import ORDER, seed_words


class Loop:
    def __init__(self, target, traffic: dict, seed):
        self.target = target
        self.sets = int(traffic["realizations"])
        self.rng = np.random.default_rng(seed_words(seed)[ORDER])
        self.order = []

    def request(self, k: int) -> dict:
        if k < 0:
            return self.target.request(0)
        while len(self.order) <= k:
            self.order.extend(self.rng.permutation(self.sets).tolist())
        return self.target.request(self.order[k])

    def ends_window(self, k: int) -> bool:
        return (k + 1) % self.sets == 0

    @staticmethod
    def end_to_end(window_s: float, latencies: list) -> dict:
        return {"calibration_s": (window_s / len(latencies), "s")}
