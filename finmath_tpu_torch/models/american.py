"""American/Bermudan options on equity models by Longstaff-Schwartz: a
backward loop over the exercise dates on the facade's device.

Counterpart of ``finmath_tpu.models.american`` (finmath-lib's
``assetderivativevaluation.products.BermudanOption``, lower-bound
Longstaff-Schwartz with a regression conditional-expectation estimator).
It reads the ``[dates, paths]`` asset matrix of any facade with a
deterministic numeraire (``MonteCarloBlackScholesModel``, ...).

Method (lower-bound LS, the finmath estimator):

* backward induction over the exercise dates; at each date regress the
  DISCOUNTED continuation value on a monomial basis of the normalized
  asset, restricted to in-the-money paths by a zero-weight mask;
* exercise where intrinsic > regressed continuation (the regression
  enters only the decision, the realized cashflow is carried);
* ``foresight_bias="split"``: fit the policy on the even paths, value it
  on the odd ones.

Precision, the JAX package's split: the basis and the masked
``[B, paths] @ [paths, B]`` Gram are float32 (``torch.matmul`` with TF32
off, the counterpart of ``Precision.HIGHEST``); the Gram is then float64
plus ``1e-10 * I``; the right-hand side, the solve
(``ops.conditional_expectation._cholesky_solve_small``) and the cash carry
are float64; the continuation is ``float32(beta) @ basis``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.conditional_expectation import _cholesky_solve_small
from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..parallel.mesh import sharded_unsupported
from ..utils.config import to_device
from .equity_products import _f32, _mesh_of


def _integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** k by binary exponentiation, the products in the order of
    ``lax.integer_pow`` (x^3 = x * x^2, x^4 = (x^2)^2)."""
    if k == 0:
        return torch.ones_like(x)
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _ls_step(s, intrinsic_i, ex, cash, fit_mask, degree: int):
    """One exercise date of the backward induction: the regression of
    ``cash`` on the normalized in-the-money asset ``s`` (fitted on
    ``fit_mask``) and the new cash, ``ex`` where exercising beats the
    regressed continuation."""
    itm = intrinsic_i > 0.0
    w = (itm & fit_mask).to(FLOAT_DTYPE)
    nw = torch.clamp_min(torch.sum(w.to(ACC_DTYPE)), 1.0)
    mu = torch.sum((s * w).to(ACC_DTYPE)) / nw
    centred = s - mu.to(FLOAT_DTYPE)
    sd = torch.sqrt(torch.clamp_min(
        torch.sum((centred ** 2 * w).to(ACC_DTYPE)) / nw, 1e-12))
    xn = centred / sd.to(FLOAT_DTYPE)
    basis = torch.stack([_integer_pow(xn, k)
                         for k in range(degree + 1)])          # [B, P]
    bw = basis * w[None, :]
    eye = torch.eye(degree + 1, dtype=ACC_DTYPE, device=s.device)
    gram = torch.matmul(bw, basis.T).to(ACC_DTYPE) + 1e-10 * eye
    rhs = torch.sum(bw.to(ACC_DTYPE) * cash[None, :], dim=1)
    beta = _cholesky_solve_small(gram, rhs)
    cont = beta.to(FLOAT_DTYPE) @ basis                        # [P]
    exercise = itm & (ex > cont.to(ACC_DTYPE))
    return torch.where(exercise, ex, cash)


def _ls_cashflows(asset, dfs, strike, is_call: bool, degree: int,
                  split: bool):
    """The policy's discounted cashflow of every path, [paths] float64.
    asset: [E, paths] float32 asset values at the exercise dates
    (ascending); dfs: [E, 1] float64 discount factors N(0)/N(t_i) on the
    device (or pathwise [E, paths]); strike a float32 0-dim tensor. With
    ``split`` the policy is fitted on the even paths."""
    e_n, paths = asset.shape
    sign = 1.0 if is_call else -1.0
    intrinsic = torch.clamp_min(sign * (asset - strike), 0.0)    # [E, P]
    disc = intrinsic.to(ACC_DTYPE) * dfs
    if split:
        fit_mask = torch.arange(paths, device=asset.device) % 2 == 0
    else:
        fit_mask = torch.ones(paths, dtype=torch.bool, device=asset.device)
    cash = disc[e_n - 1]
    for i in range(e_n - 2, -1, -1):
        cash = _ls_step(asset[i], intrinsic[i], disc[i], cash, fit_mask,
                        degree)
    return cash


def _ls_kernel(asset, dfs, strike, is_call: bool, degree: int,
               split: bool):
    """[2] float64 (value, stderr) of ``_ls_cashflows``; with ``split`` the
    mean and error of the odd paths."""
    cash = _ls_cashflows(asset, dfs, strike, is_call, degree, split)
    paths = cash.shape[0]
    value_mask = torch.ones(paths, dtype=ACC_DTYPE, device=cash.device)
    if split:
        value_mask[0::2] = 0.0
    n = torch.sum(value_mask)
    mean = torch.sum(cash * value_mask) / n
    var = torch.sum((cash - mean) ** 2 * value_mask) / n
    return torch.stack([mean, torch.sqrt(var / n)])


class BermudanOption:
    """Bermudan (or dense-grid American) call/put on a simulated asset,
    priced by Longstaff-Schwartz. ``exercise_times`` must lie on the
    simulation grid. Works with any facade exposing ``get_asset_value(t)``
    / ``get_numeraire(t)`` with a deterministic numeraire."""

    def __init__(self, exercise_times: Sequence[float], strike: float,
                 is_call: bool = False, basis_degree: int = 3,
                 foresight_bias: str = "split"):
        self.exercise_times = [float(t) for t in exercise_times]
        if len(self.exercise_times) < 1 or \
                sorted(self.exercise_times) != self.exercise_times:
            raise ValueError("exercise_times must be ascending, nonempty")
        if basis_degree < 1:
            raise ValueError("basis_degree must be >= 1")
        if foresight_bias not in ("split", "insample"):
            raise ValueError("foresight_bias must be 'split' or 'insample'")
        self.strike = float(strike)
        self.is_call = bool(is_call)
        self.basis_degree = int(basis_degree)
        self.foresight_bias = foresight_bias

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device; a meshed
        facade raises (the regressions and the mean are local)."""
        sharded_unsupported(_mesh_of(model), "BermudanOption")
        if hasattr(model, "get_asset_values"):
            assets = model.get_asset_values(self.exercise_times)
        else:
            assets = torch.stack([model.get_asset_value(t).values
                                  for t in self.exercise_times])
        n0 = model.get_numeraire(0.0)
        dfs = []
        for t in self.exercise_times:
            nt = model.get_numeraire(t)
            if not (nt.is_deterministic() and n0.is_deterministic()):
                raise NotImplementedError(
                    "BermudanOption needs a deterministic numeraire "
                    "(equity models); use the LMM BermudanSwaptionPricer "
                    "for stochastic-rates exercise")
            dfs.append(float(n0.get_average() / nt.get_average()))
        return _ls_kernel(
            assets, to_device(np.asarray(dfs)[:, None], ACC_DTYPE,
                              assets.device),
            _f32(self.strike, assets), self.is_call, self.basis_degree,
            self.foresight_bias == "split")

    def get_value_and_error(self, model) -> tuple:
        """(value, MC standard error): one host copy."""
        out = self.packed_value_and_error(model).cpu().numpy()
        return float(out[0]), float(out[1])

    def get_value(self, model) -> float:
        return self.get_value_and_error(model)[0]

    getValue = get_value


def crr_american_price(s0: float, r: float, sigma: float, maturity: float,
                       strike: float, is_call: bool = False,
                       num_steps: int = 2000,
                       dividend_yield: float = 0.0) -> float:
    """Cox-Ross-Rubinstein binomial American price (host NumPy float64):
    the independent oracle for the LS pricer under Black-Scholes."""
    dt = maturity / num_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-r * dt)
    p = (np.exp((r - dividend_yield) * dt) - d) / (u - d)
    if not 0.0 < p < 1.0:
        raise ValueError("CRR tree unstable: decrease dt")
    j = np.arange(num_steps + 1)
    st = s0 * u ** (num_steps - j) * d ** j
    sign = 1.0 if is_call else -1.0
    v = np.maximum(sign * (st - strike), 0.0)
    for n in range(num_steps - 1, -1, -1):
        st = st[: n + 1] * d
        v = disc * (p * v[: n + 1] + (1.0 - p) * v[1: n + 2])
        v = np.maximum(v, sign * (st - strike))
    return float(v[0])
