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

Under a meshed facade (its ``mesh``, a ``parallel.PathMesh``) the asset
matrix is this rank's block of the paths, as in the meshed Hull-White
Bermudan (``hw_bermudan._hw_ls_kernel``): the split takes the parity of
the global path index, every date sums the weighted count and sum, then
the centred second moment, then the Gram matrix with its right-hand side
over the ranks (three all-reduces), and the value's count and sums are
global, so every rank fits the same policy and returns the same ``[2]``.

Precision: the basis is float32, as in the JAX package; the masked
``[B, paths] @ [paths, B]`` Gram multiplies the float32 basis in float64
(every product exact, the sums float64), where the JAX package sums a
float32 product (``Precision.HIGHEST``): with 50 exercise dates a float32
Gram summed in another order (one block a rank) moves a few boundary
decisions, and each moved decision cascades through the later
regressions (``tests/test_torch_american.py``), so a meshed run could not
reproduce the unsharded one; in float64 the blocks' Grams sum to the same
matrix within 1e-16. The Gram then gets ``1e-10 * I``; the right-hand
side, the solve (``ops.conditional_expectation._cholesky_solve_small``)
and the cash carry are float64; the continuation is
``float32(beta) @ basis``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.conditional_expectation import _cholesky_solve_small
from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..utils.config import to_device
from .equity_products import _f32, _mesh_of, _over_ranks


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


def _global_parity(paths: int, device, mesh) -> torch.Tensor:
    """[paths] bool: whether each of this rank's paths has an even GLOBAL
    index (rank r's block starts at r * paths)."""
    first = 0 if mesh is None else mesh.rank * paths
    return torch.arange(first, first + paths, device=device) % 2 == 0


def _ls_step(s, intrinsic_i, ex, cash, fit_mask, degree: int, mesh=None):
    """One exercise date of the backward induction: the regression of
    ``cash`` on the normalized in-the-money asset ``s`` (fitted on
    ``fit_mask``) and the new cash, ``ex`` where exercising beats the
    regressed continuation. Under ``mesh`` the moments and the normal
    equations are summed over the ranks."""
    over = _over_ranks(mesh)
    itm = intrinsic_i > 0.0
    w = (itm & fit_mask).to(FLOAT_DTYPE)
    sums = over(torch.stack([torch.sum(w.to(ACC_DTYPE)),
                             torch.sum((s * w).to(ACC_DTYPE))]))
    nw = torch.clamp_min(sums[0], 1.0)
    mu = sums[1] / nw
    centred = s - mu.to(FLOAT_DTYPE)
    sd = torch.sqrt(torch.clamp_min(
        over(torch.sum((centred ** 2 * w).to(ACC_DTYPE))) / nw, 1e-12))
    xn = centred / sd.to(FLOAT_DTYPE)
    basis = torch.stack([_integer_pow(xn, k)
                         for k in range(degree + 1)])          # [B, P]
    bw = basis * w[None, :]
    eye = torch.eye(degree + 1, dtype=ACC_DTYPE, device=s.device)
    both = over(torch.cat(
        [torch.matmul(bw.to(ACC_DTYPE), basis.T.to(ACC_DTYPE)),
         torch.sum(bw.to(ACC_DTYPE) * cash[None, :], dim=1)[:, None]],
        dim=1))
    gram, rhs = both[:, :-1] + 1e-10 * eye, both[:, -1]
    beta = _cholesky_solve_small(gram, rhs)
    cont = beta.to(FLOAT_DTYPE) @ basis                        # [P]
    exercise = itm & (ex > cont.to(ACC_DTYPE))
    return torch.where(exercise, ex, cash)


def _ls_cashflows(asset, dfs, strike, is_call: bool, degree: int,
                  split: bool, mesh=None):
    """The policy's discounted cashflow of every path, [paths] float64.
    asset: [E, paths] float32 asset values at the exercise dates
    (ascending); dfs: [E, 1] float64 discount factors N(0)/N(t_i) on the
    device (or pathwise [E, paths]); strike a float32 0-dim tensor. With
    ``split`` the policy is fitted on the paths of even global index."""
    e_n, paths = asset.shape
    sign = 1.0 if is_call else -1.0
    intrinsic = torch.clamp_min(sign * (asset - strike), 0.0)    # [E, P]
    disc = intrinsic.to(ACC_DTYPE) * dfs
    if split:
        fit_mask = _global_parity(paths, asset.device, mesh)
    else:
        fit_mask = torch.ones(paths, dtype=torch.bool, device=asset.device)
    cash = disc[e_n - 1]
    for i in range(e_n - 2, -1, -1):
        cash = _ls_step(asset[i], intrinsic[i], disc[i], cash, fit_mask,
                        degree, mesh)
    return cash


def _ls_kernel(asset, dfs, strike, is_call: bool, degree: int,
               split: bool, mesh=None):
    """[2] float64 (value, stderr) of ``_ls_cashflows``; with ``split`` the
    mean and error of the paths of odd global index."""
    over = _over_ranks(mesh)
    cash = _ls_cashflows(asset, dfs, strike, is_call, degree, split, mesh)
    paths = cash.shape[0]
    if split:
        value_mask = (~_global_parity(paths, cash.device, mesh)).to(
            ACC_DTYPE)
    else:
        value_mask = torch.ones(paths, dtype=ACC_DTYPE, device=cash.device)
    sums = over(torch.stack([torch.sum(value_mask),
                             torch.sum(cash * value_mask)]))
    n = sums[0]
    mean = sums[1] / n
    var = over(torch.sum((cash - mean) ** 2 * value_mask)) / n
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
        """[2] float64 (value, stderr) on the facade's device; on a meshed
        facade the regressions and the statistics are global and every
        rank returns the same tensor."""
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
            self.foresight_bias == "split", _mesh_of(model))

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
