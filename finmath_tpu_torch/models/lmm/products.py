"""Interest-rate products on the LMM beyond the calibration swaptions.

Counterpart of ``finmath_tpu.models.lmm.products``. A caplet is a
single-period payer swaption (payoff delta P(T_e, T_{e+1}) max(L - K, 0)
= max(1 - P - K delta P, 0)), so caps compose directly on the valuation
engine; a floor comes from cap/floor parity (floor = cap - swap), the
swap leg valued on the curves.
"""

from __future__ import annotations

import numpy as np

from .model import LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct


class CapFloor:
    """Cap (or floor) over consecutive periods [first_index, last_index) of
    the model tenor grid, strike K, unit notional. The engine simulates on
    ``device`` (default ``select_device()``)."""

    def __init__(self, model: LIBORMarketModelTorch, first_index: int,
                 last_index: int, strike: float, is_cap: bool = True,
                 num_paths: int = 10_000, num_factors: int = None,
                 seed: int = 31415, *, device=None):
        if not (1 <= first_index < last_index <= model.num_libors):
            raise ValueError("invalid period range")
        if num_factors is None:
            # the engine rejects a factor count other than the covariance's
            num_factors = getattr(model.covariance, "num_factors", 1)
        self.model = model
        self.first_index = int(first_index)
        self.last_index = int(last_index)
        self.strike = float(strike)
        self.is_cap = is_cap
        caplets = [
            SwaptionProduct(e, 1, self.strike, 0.0, value_unit="VALUE")
            for e in range(self.first_index, self.last_index)
        ]
        self._engine = LMMValuationEngine(
            model, caplets, num_paths, num_factors, seed, device=device)

    def get_value(self, params) -> float:
        cap_value = float(np.sum(self._engine.values(params)))
        if self.is_cap:
            return cap_value
        # floor = cap - swap (parity); the swap leg is deterministic on the
        # curves: sum delta (f_e - K) df(T_{e+1})
        dc = self.model.discount_curve
        fc = self.model.forward_curve
        tenor = self.model.tenor_times
        deltas = self.model.deltas
        swap = 0.0
        for e in range(self.first_index, self.last_index):
            f = float(fc.get_forward(tenor[e]))
            swap += deltas[e] * (f - self.strike) * float(
                dc.get_discount_factor(tenor[e + 1]))
        return cap_value - swap

    getValue = get_value
