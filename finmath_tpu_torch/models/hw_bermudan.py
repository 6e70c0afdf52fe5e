"""Bermudan swaptions on the Hull-White model: Longstaff-Schwartz over the
exact simulation, with an independent Crank-Nicolson PDE oracle.

Counterpart of ``finmath_tpu.models.hw_bermudan`` (finmath-lib's
``montecarlo.interestrate.products.BermudanSwaption`` on a short-rate
simulation). Co-terminal payer or receiver Bermudan: exercise dates
T_0 < ... < T_{E-1}; exercising at T_i enters the remaining swap
(payments strictly after T_i, coupons K delta, the redemption +1 on the
last date, the coupon-bond form of ``HullWhiteSimulation.mc_swaption_price``).

* The pathwise exercise value in today's money, ev_i = sign (1 - sum_k
  c_ik P(T_i, t_k; x_i)) / N(T_i), of every date from one float64
  ``[E, K, paths]`` contraction (the ragged coupon stacks zero-padded).
* The regression state is the single Gaussian factor x(T_i) (the model
  is one-factor Markov): a degree-3 polynomial in normalized x, fitted on
  the in-the-money paths, optionally on even paths and valued on odd ones
  (``foresight_bias="split"``, the low-biased estimator).

Oracle: a host Crank-Nicolson solve of the pricing PDE in x (OU drift
-a x, vol sigma(t), short rate x + alpha(t)), applying max(V, ev) at the
exercise dates; with one exercise date it must match the Jamshidian
closed form.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..ops.conditional_expectation import _cholesky_solve_small
from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from .hull_white import HullWhiteModel, HullWhiteSimulation


def _hw_ls_kernel(xs, ys, a_int, cl, bb, sign: float, degree: int,
                  split: bool, mesh=None) -> torch.Tensor:
    """Longstaff-Schwartz backward induction on the exercise dates.

    ``xs``, ``ys``: ``[E, paths]`` float32 state and integrated rate at the
    exercise dates; ``a_int``: ``[E]``; ``cl``: ``[E, K]`` coupon * lead
    (zero-padded); ``bb``: ``[E, K]`` (all float64); returns ``[2]`` (value,
    standard error over n) in today's money. A plain torch function: the
    JAX package's ``_hw_ls_kernel`` of the same name is a ``jax.jit``
    function in jnp, not a Pallas kernel, and this follows its order of
    operations (float32 basis and Gram product, float64 sums, the Gram's
    1e-10 jitter).

    Under a ``mesh`` the paths are this rank's block: the split takes the
    global path index's parity, and the weighted moments, the Gram matrix
    with its right-hand side and the value's sums are summed over the
    ranks (three all-reduces a date and two for the value), so every rank
    fits the same policy."""
    e_n, paths = xs.shape
    dev = xs.device

    def over_ranks(local):
        return local if mesh is None else mesh.all_reduce(local)
    xa = xs.to(ACC_DTYPE)
    cb = torch.sum(cl[:, :, None] * torch.exp(-bb[:, :, None] * xa[:, None, :]),
                   dim=1)                                    # [E, paths]
    inv_n = torch.exp(-ys.to(ACC_DTYPE) - a_int[:, None])
    ev = sign * (1.0 - cb) * inv_n                           # [E, paths]
    if split:
        first = 0 if mesh is None else mesh.rank * paths
        fit_mask = torch.arange(first, first + paths, device=dev) % 2 == 0
    else:
        fit_mask = torch.ones(paths, dtype=torch.bool, device=dev)
    eye = torch.eye(degree + 1, dtype=ACC_DTYPE, device=dev)

    cash = torch.clamp_min(ev[e_n - 1], 0.0)
    for i in range(e_n - 2, -1, -1):
        s = xs[i].to(FLOAT_DTYPE)
        itm = ev[i] > 0.0
        w = (itm & fit_mask).to(FLOAT_DTYPE)
        sums = over_ranks(torch.stack([torch.sum(w.to(ACC_DTYPE)),
                                       torch.sum((s * w).to(ACC_DTYPE))]))
        nw = torch.clamp_min(sums[0], 1.0)
        mu = sums[1] / nw
        sd = torch.sqrt(torch.clamp_min(over_ranks(
            torch.sum(((s - mu.to(FLOAT_DTYPE)) ** 2 * w).to(ACC_DTYPE)))
            / nw, 1e-12))
        xn = (s - mu.to(FLOAT_DTYPE)) / sd.to(FLOAT_DTYPE)
        basis = torch.stack([xn ** k for k in range(degree + 1)])
        bw = basis * w[None, :]
        both = over_ranks(torch.cat(
            [torch.matmul(bw, basis.T).to(ACC_DTYPE),
             torch.sum(bw.to(ACC_DTYPE) * cash[None, :], dim=1)[:, None]],
            dim=1))
        gram, rhs = both[:, :-1] + 1e-10 * eye, both[:, -1]
        beta = _cholesky_solve_small(gram, rhs)
        cont = (beta.to(FLOAT_DTYPE) @ basis).to(ACC_DTYPE)
        exercise = itm & (ev[i] > cont)
        cash = torch.where(exercise, ev[i], cash)

    value_mask = ((~fit_mask) if split else
                  torch.ones(paths, dtype=torch.bool, device=dev)).to(ACC_DTYPE)
    sums = over_ranks(torch.stack([torch.sum(value_mask),
                                   torch.sum(cash * value_mask)]))
    n = sums[0]
    mean = sums[1] / n
    var = over_ranks(torch.sum((cash - mean) ** 2 * value_mask)) / n
    return torch.stack([mean, torch.sqrt(var / n)])


class BermudanSwaption:
    """Co-terminal Bermudan swaption on a HullWhiteSimulation: exercise
    into the remaining swap at any ``exercise_times`` entry; the swap pays
    on the exercise schedule shifted by one period plus
    ``final_maturity``."""

    def __init__(self, exercise_times: Sequence[float],
                 final_maturity: float, strike: float,
                 payer: bool = True, basis_degree: int = 3,
                 foresight_bias: str = "split"):
        self.exercise_times = [float(t) for t in exercise_times]
        if (not self.exercise_times
                or sorted(self.exercise_times) != self.exercise_times):
            raise ValueError("exercise_times must be ascending, nonempty")
        if final_maturity <= self.exercise_times[-1]:
            raise ValueError("final_maturity must follow the last "
                             "exercise date")
        if foresight_bias not in ("split", "insample"):
            raise ValueError("foresight_bias must be 'split' or "
                             "'insample'")
        self.final_maturity = float(final_maturity)
        self.strike = float(strike)
        self.payer = bool(payer)
        self.basis_degree = int(basis_degree)
        self.foresight_bias = foresight_bias

    def payment_schedule(self) -> np.ndarray:
        return np.asarray(self.exercise_times[1:] + [self.final_maturity],
                          dtype=np.float64)

    def remaining_payments(self, i: int) -> np.ndarray:
        """Payment times of the swap entered at exercise_times[i]."""
        sched = self.payment_schedule()
        return sched[i:]

    def _coupons(self, i: int) -> tuple:
        t0 = self.exercise_times[i]
        pt = self.remaining_payments(i)
        deltas = np.diff(np.concatenate([[t0], pt]))
        coupons = self.strike * deltas
        coupons[-1] += 1.0
        return pt, coupons

    def packed_value_and_error(self, sim: HullWhiteSimulation) -> torch.Tensor:
        """``[2]`` (value, standard error) float64 on the simulation's
        device, without a host transfer."""
        e_n = len(self.exercise_times)
        kmax = e_n  # remaining payments at the first date
        cl = np.zeros((e_n, kmax))
        bb = np.zeros((e_n, kmax))
        idx = []
        for i, t in enumerate(self.exercise_times):
            ti = sim._index(t)
            idx.append(ti)
            pt, coupons = self._coupons(i)
            leads, bbs = sim._bond_coeffs(ti, pt)
            cl[i, :len(pt)] = coupons * leads
            bb[i, :len(pt)] = bbs
        ii = torch.as_tensor(idx, device=sim.device)
        return _hw_ls_kernel(
            sim._xs[ii], sim._ys[ii], sim._f64(sim._a_int[np.asarray(idx)]),
            sim._f64(cl), sim._f64(bb), 1.0 if self.payer else -1.0,
            self.basis_degree, self.foresight_bias == "split", sim.mesh)

    def get_value_and_error(self, sim: HullWhiteSimulation) -> tuple:
        out = self.packed_value_and_error(sim).cpu().numpy()
        return float(out[0]), float(out[1])

    def get_value(self, sim: HullWhiteSimulation) -> float:
        return self.get_value_and_error(sim)[0]

    getValue = get_value


# ---------------------------------------------------------------------------
# Crank-Nicolson PDE oracle (host NumPy float64)
# ---------------------------------------------------------------------------

def _thomas(lo, di, up, rhs):
    """Tridiagonal solve (Thomas algorithm), all [n] arrays
    (lo[0] and up[-1] unused)."""
    n = di.size
    c = np.empty(n)
    d = np.empty(n)
    c[0] = up[0] / di[0]
    d[0] = rhs[0] / di[0]
    for k in range(1, n):
        m = di[k] - lo[k] * c[k - 1]
        c[k] = up[k] / m
        d[k] = (rhs[k] - lo[k] * d[k - 1]) / m
    x = np.empty(n)
    x[-1] = d[-1]
    for k in range(n - 2, -1, -1):
        x[k] = d[k] - c[k] * x[k + 1]
    return x


def hw_bermudan_swaption_pde(model: HullWhiteModel,
                             exercise_times: Sequence[float],
                             final_maturity: float, strike: float,
                             payer: bool = True, nx: int = 801,
                             steps_per_year: int = 200,
                             stddevs: float = 7.0) -> float:
    """Bermudan swaption value at t=0 by Crank-Nicolson on
    V_t = a x V_x - 1/2 sigma(t)^2 V_xx + (x + alpha(t)) V (backward),
    alpha(t) = f(0,t) + C(t), with max(V, exercise) applied at each
    exercise date. Independent of the Monte-Carlo path; the single-date
    case reproduces the Jamshidian closed form."""
    prod = BermudanSwaption(exercise_times, final_maturity, strike,
                            payer)
    ex = list(prod.exercise_times)
    a = model.a
    sign = 1.0 if payer else -1.0

    # grid wide enough for the largest x variance on the horizon
    phi_max = max(model.gaussian_state(t)[0] for t in ex)
    xw = stddevs * math.sqrt(phi_max)
    x = np.linspace(-xw, xw, nx)
    dx = x[1] - x[0]

    def exercise_value(i):
        t0 = ex[i]
        pt, coupons = prod._coupons(i)
        cb = np.zeros_like(x)
        for tk, ck in zip(pt, coupons):
            cb += ck * model._bond_at_x(t0, float(tk), x)
        return sign * (1.0 - cb)

    v = np.maximum(exercise_value(len(ex) - 1), 0.0)
    # backward over [0, T_last] with exercise updates
    for i in range(len(ex) - 1, -1, -1):
        t_hi = ex[i]
        t_lo = ex[i - 1] if i > 0 else 0.0
        if i < len(ex) - 1:
            v = np.maximum(v, exercise_value(i))
        nsteps = max(int(round((t_hi - t_lo) * steps_per_year)), 2)
        dt = (t_hi - t_lo) / nsteps
        for k in range(nsteps):
            t_mid = t_hi - (k + 0.5) * dt
            sig = model.sigma_at(t_mid)
            phi, c, _ = model.gaussian_state(t_mid)
            alpha = model.forward_rate(t_mid) + c
            r = x + alpha
            # operator L V = -a x V_x + 1/2 sig^2 V_xx - r V
            drift = -a * x
            dcoef = 0.5 * sig * sig
            lo = dcoef / dx**2 - drift / (2 * dx)
            up = dcoef / dx**2 + drift / (2 * dx)
            di = -2.0 * dcoef / dx**2 - r
            # Crank-Nicolson: (I - dt/2 L) v_new = (I + dt/2 L) v_old
            rhs = v.copy()
            rhs[1:-1] = (v[1:-1]
                         + 0.5 * dt * (lo[1:-1] * v[:-2]
                                       + di[1:-1] * v[1:-1]
                                       + up[1:-1] * v[2:]))
            dlo = np.zeros(nx)
            dup = np.zeros(nx)
            ddi = np.ones(nx)
            dlo[1:-1] = -0.5 * dt * lo[1:-1]
            dup[1:-1] = -0.5 * dt * up[1:-1]
            ddi[1:-1] = 1.0 - 0.5 * dt * di[1:-1]
            # boundary rows: V_xx = 0, one-sided first-order drift
            bdrift = -a * x[0]
            ddi[0] = 1.0 + dt * (x[0] + alpha) + dt * bdrift / dx
            dup[0] = -dt * bdrift / dx
            rhs[0] = v[0]
            bdrift = -a * x[-1]
            ddi[-1] = 1.0 + dt * (x[-1] + alpha) - dt * bdrift / dx
            dlo[-1] = dt * bdrift / dx
            rhs[-1] = v[-1]
            v = _thomas(dlo, ddi, dup, rhs)
    # value at x = 0 (x(0) = 0)
    return float(np.interp(0.0, x, v))
