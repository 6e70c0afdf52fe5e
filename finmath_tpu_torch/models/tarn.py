"""Target-redemption note (TARN) on the exact Hull-White simulation: a
float64 loop over the coupon schedule carrying (alive, cumulative coupon)
per path, discounted by the exact pathwise numeraire.

Counterpart of ``finmath_tpu.models.tarn`` (finmath-lib prices TARNs as
``TermStructureMonteCarloProduct`` compositions: coupon legs and trigger
logic through the RandomVariable API). Inverse-floater coupons, target
accrual, knock-out redemption and discounting run as one pass over the
``[paths]`` tensors of the simulation's device and give one packed
(value, standard error).

The two market-standard target caps:

* ``cap_mode="exact"``: the breaching coupon is truncated so the paid
  total equals the target exactly;
* ``cap_mode="full"``: the breaching coupon is paid in full.

Oracle: with ``target=inf`` the TARN is a portfolio of floorlets
(put-call parity on the Hull-White analytic caplet) plus the redemption
zero bond, :func:`inverse_floater_value`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE
from ..parallel.mesh import path_sum
from .hull_white import HullWhiteModel, HullWhiteSimulation


# ---------------------------------------------------------------------------
# analytic oracle: the uncapped inverse floater
# ---------------------------------------------------------------------------

def inverse_floater_value(model: HullWhiteModel,
                          fixing_times: Sequence[float],
                          payment_times: Sequence[float],
                          strike: float, multiplier: float = 1.0,
                          notional: float = 1.0) -> float:
    """Closed-form value of the uncapped inverse floater plus the notional
    redemption at the last payment: each coupon delta_i max(K - m L_i, 0)
    is m floorlets struck at K/m, valued by put-call parity off the
    Hull-White analytic caplet (floorlet = caplet - P(0,fix) + (1 +
    delta K') P(0,pay)). The ``target = inf`` limit of the TARN."""
    k_eff = strike / multiplier
    total = 0.0
    for tf, tp in zip(fixing_times, payment_times):
        delta = tp - tf
        cap = model.caplet(float(tf), float(tp), k_eff)
        floor = (cap - float(model.df(tf))
                 + (1.0 + delta * k_eff) * float(model.df(tp)))
        total += multiplier * floor
    total += float(model.df(payment_times[-1]))
    return notional * total


# ---------------------------------------------------------------------------
# pathwise sweep
# ---------------------------------------------------------------------------

def _tarn_kernel(xs_fix, ys_pay, a_int_pay, leads, bbs, deltas,
                 strike: float, multiplier: float, target: float,
                 cap_full: bool, notional: float, mesh=None) -> torch.Tensor:
    """``[dates, paths]`` pathwise sweep in float64: the libor from the
    affine bond reconstitution, the coupon, target and knock logic without
    branches, discounting by the exact pathwise numeraire; ``[2]`` (value,
    standard error over n - 1). Under a ``mesh`` the paths are this rank's
    block, and the sum and the squared deviations from the global mean
    are summed over the ranks. A plain torch function: the JAX package's
    ``_tarn_kernel`` is a ``jax.jit`` function in jnp, not a Pallas
    kernel."""
    paths = xs_fix.shape[1]
    dev = xs_fix.device
    alive = torch.ones(paths, dtype=ACC_DTYPE, device=dev)
    cum = torch.zeros(paths, dtype=ACC_DTYPE, device=dev)
    acc = torch.zeros(paths, dtype=ACC_DTYPE, device=dev)
    for j in range(xs_fix.shape[0]):
        xa = xs_fix[j].to(ACC_DTYPE)
        p_fp = leads[j] * torch.exp(-bbs[j] * xa)      # P(t_fix, t_pay; x)
        libor = (1.0 / p_fp - 1.0) / deltas[j]
        coupon_raw = deltas[j] * torch.clamp_min(strike - multiplier * libor,
                                                 0.0)
        room = torch.clamp_min(target - cum, 0.0)
        paid = coupon_raw if cap_full else torch.minimum(coupon_raw, room)
        knock = (cum + coupon_raw >= target).to(ACC_DTYPE)
        inv_n = torch.exp(-ys_pay[j].to(ACC_DTYPE) - a_int_pay[j])
        acc = acc + inv_n * alive * (paid + knock)
        cum = cum + alive * coupon_raw
        alive = alive * (1.0 - knock)
    # never knocked: notional back at the last payment date
    inv_n_last = torch.exp(-ys_pay[-1].to(ACC_DTYPE) - a_int_pay[-1])
    pay = (acc + alive * inv_n_last) * notional
    n = paths * (1 if mesh is None else mesh.world_size)
    mean = path_sum(pay, mesh) / n
    var = path_sum((pay - mean) ** 2, mesh) / (n - 1)
    return torch.stack([mean, torch.sqrt(var / n)])


# ---------------------------------------------------------------------------
# product
# ---------------------------------------------------------------------------

class TargetRedemptionNote:
    """TARN paying inverse-floater coupons
    ``delta_i * max(strike - multiplier * L(t_i, t_i, t_{i+1}), 0)``
    at each payment date until the cumulative coupon reaches ``target``,
    at which point the note redeems the notional (breaching coupon per
    ``cap_mode``); notional back at the final payment if never
    triggered."""

    def __init__(self, fixing_times: Sequence[float],
                 payment_times: Sequence[float], strike: float,
                 target: float, multiplier: float = 1.0,
                 cap_mode: str = "exact", notional: float = 1.0):
        if cap_mode not in ("exact", "full"):
            raise ValueError("cap_mode must be 'exact' or 'full'")
        ft = [float(t) for t in fixing_times]
        pt = [float(t) for t in payment_times]
        if len(ft) != len(pt) or not ft:
            raise ValueError("need matching, non-empty fixing/payment times")
        for tf, tp in zip(ft, pt):
            if not 0.0 <= tf < tp:
                raise ValueError("each fixing must precede its payment")
        if sorted(ft) != ft:
            raise ValueError("fixing_times must be ascending")
        self.fixing_times = ft
        self.payment_times = pt
        self.strike = float(strike)
        self.target = float(target)
        self.multiplier = float(multiplier)
        self.cap_mode = cap_mode
        self.notional = float(notional)

    def packed_value_and_error(self, sim: HullWhiteSimulation) -> torch.Tensor:
        """``[2]`` (value, standard error) float64 on the simulation's
        device, without a host transfer."""
        n = len(self.fixing_times)
        fix_idx = [sim._index(t) for t in self.fixing_times]
        pay_idx = [sim._index(t) for t in self.payment_times]
        leads = np.empty(n)
        bbs = np.empty(n)
        for j, (i, tp) in enumerate(zip(fix_idx, self.payment_times)):
            lead, bb = sim._bond_coeffs(i, tp)
            leads[j], bbs[j] = lead[0], bb[0]
        deltas = np.asarray(self.payment_times) - np.asarray(
            self.fixing_times)
        dev = sim.device
        return _tarn_kernel(
            sim._xs[torch.as_tensor(fix_idx, device=dev)],
            sim._ys[torch.as_tensor(pay_idx, device=dev)],
            sim._f64(sim._a_int[np.asarray(pay_idx)]),
            sim._f64(leads), sim._f64(bbs), sim._f64(deltas),
            self.strike, self.multiplier, self.target,
            self.cap_mode == "full", self.notional, sim.mesh)

    def get_value_and_error(self, sim: HullWhiteSimulation) -> tuple:
        out = self.packed_value_and_error(sim).cpu().numpy()
        return float(out[0]), float(out[1])

    def get_value(self, sim: HullWhiteSimulation) -> float:
        return self.get_value_and_error(sim)[0]

    getValue = get_value
