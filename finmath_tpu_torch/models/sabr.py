"""SABR stochastic-volatility smile model: Hagan asymptotic implied vols
(lognormal and normal quotes, with displacement), a Monte-Carlo simulator
of the terminal forward, and smile calibration.

Counterpart of ``finmath_tpu.models.sabr`` (finmath-lib's
``AnalyticFormulas.sabrHaganLognormalBlackVolatilityApproximation`` and
the normal-vol approximations of its swaption-cube machinery). Dynamics,
displacement d, beta in [0, 1]:

    dF = alpha (F + d)^beta dW1,   dalpha = nu alpha dW2,
    d<W1, W2> = rho dt

The Hagan expansions are host float64 on scalars; their torch twin
(:func:`torch_sabr_lognormal_implied_volatility`) takes tensors and is
differentiable by autograd. The simulator (:func:`_sabr_terminal`) is a
step loop over ``[paths]`` float32 tensors on the device: the vol leg
exact (a lognormal with its Ito drift), the forward leg log-Euler in the
displaced coordinate X = F + d with absorption at X = 0, antithetic
mirroring of both normals. Payoff means are float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..utils.config import select_device
from .analytic import bachelier_implied_volatility, black_implied_volatility

__all__ = [
    "SABRParams",
    "sabr_lognormal_implied_volatility",
    "sabr_normal_implied_volatility",
    "torch_sabr_lognormal_implied_volatility",
    "mc_sabr_option_prices",
    "SABRCalibrationResult",
    "calibrate_sabr",
    "mc_sabr_implied_vols",
]


@dataclass(frozen=True)
class SABRParams:
    """alpha: initial vol level; beta: CEV exponent in [0, 1];
    rho: vol-forward correlation; nu: vol-of-vol;
    displacement: shift d >= 0 (displaced/shifted SABR)."""
    alpha: float
    beta: float
    rho: float
    nu: float
    displacement: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.beta <= 1.0:
            raise ValueError("beta must be in [0, 1]")
        if not -1.0 < self.rho < 1.0:
            raise ValueError("rho must be in (-1, 1)")
        if self.alpha <= 0.0 or self.nu < 0.0:
            raise ValueError("alpha > 0 and nu >= 0 required")
        if self.displacement < 0.0:
            raise ValueError("displacement must be >= 0")


def _hagan_lognormal(f: float, k: float, t: float, alpha: float,
                     beta: float, rho: float, nu: float) -> float:
    """Hagan et al. 2002 eq. 2.17a."""
    if f <= 0.0 or k <= 0.0:
        raise ValueError("forward and strike must be positive after "
                         "displacement; increase the displacement")
    omb = 1.0 - beta
    lfk = math.log(f / k)
    fkb = (f * k) ** (0.5 * omb)
    a1 = (omb * alpha) ** 2 / (24.0 * fkb * fkb)
    a2 = rho * beta * nu * alpha / (4.0 * fkb)
    a3 = (2.0 - 3.0 * rho * rho) * nu * nu / 24.0
    term_t = 1.0 + (a1 + a2 + a3) * t
    denom = fkb * (1.0 + omb**2 / 24.0 * lfk**2
                   + omb**4 / 1920.0 * lfk**4)
    if nu == 0.0 or abs(lfk) < 1e-14:
        return alpha / denom * term_t      # ATM/CEV limit: z/x(z) -> 1
    z = nu / alpha * fkb * lfk
    x = math.log((math.sqrt(1.0 - 2.0 * rho * z + z * z) + z - rho)
                 / (1.0 - rho))
    return alpha / denom * (z / x) * term_t


def sabr_lognormal_implied_volatility(params: SABRParams, forward: float,
                                      strike: float,
                                      maturity: float) -> float:
    """Black (lognormal) implied vol of the displaced-SABR smile;
    the displacement shifts both forward and strike."""
    d = params.displacement
    return _hagan_lognormal(forward + d, strike + d, maturity,
                            params.alpha, params.beta, params.rho,
                            params.nu)


def sabr_normal_implied_volatility(params: SABRParams, forward: float,
                                   strike: float,
                                   maturity: float) -> float:
    """Bachelier (normal) implied vol of the SABR smile, Hagan et al.
    2002 eq. A.67."""
    d = params.displacement
    f, k = forward + d, strike + d
    if f <= 0.0 or k <= 0.0:
        raise ValueError("forward and strike must be positive after "
                         "displacement")
    alpha, beta, rho, nu = (params.alpha, params.beta, params.rho,
                            params.nu)
    t = maturity
    omb = 1.0 - beta
    lfk = math.log(f / k)
    fkb = (f * k) ** (0.5 * omb)
    num_series = 1.0 + lfk**2 / 24.0 + lfk**4 / 1920.0
    den_series = 1.0 + omb**2 / 24.0 * lfk**2 + omb**4 / 1920.0 * lfk**4
    b1 = -beta * (2.0 - beta) * alpha**2 / (24.0 * fkb * fkb)
    b2 = rho * alpha * nu * beta / (4.0 * fkb)
    b3 = (2.0 - 3.0 * rho**2) * nu**2 / 24.0
    term_t = 1.0 + (b1 + b2 + b3) * t
    lead = alpha * (f * k) ** (0.5 * beta) * num_series / den_series
    if nu == 0.0 or abs(lfk) < 1e-14:
        return lead * term_t
    zeta = nu / alpha * fkb * lfk
    x = math.log((math.sqrt(1.0 - 2.0 * rho * zeta + zeta**2)
                  + zeta - rho) / (1.0 - rho))
    return lead * (zeta / x) * term_t


def torch_sabr_lognormal_implied_volatility(alpha, beta, rho, nu, forward,
                                            strikes, maturity,
                                            displacement=0.0):
    """Torch twin of the Hagan lognormal expansion, elementwise over
    ``strikes`` (floats or tensors that broadcast; a non-tensor strike
    becomes float64), differentiable by autograd.

    Near the money z/x(z) -> 1; for |z| < 1e-6 the series 1 + rho z / 2
    is used, and both branches of the switch see safe operands (z and x
    replaced by 1 there), so the gradient stays finite at the money."""
    if not isinstance(strikes, torch.Tensor):
        strikes = torch.as_tensor(strikes, dtype=torch.float64)
    f = forward + displacement
    k = strikes + displacement
    omb = 1.0 - beta
    lfk = torch.log(f / k)
    fkb = (f * k) ** (0.5 * omb)
    a1 = (omb * alpha) ** 2 / (24.0 * fkb * fkb)
    a2 = rho * beta * nu * alpha / (4.0 * fkb)
    a3 = (2.0 - 3.0 * rho * rho) * nu * nu / 24.0
    term_t = 1.0 + (a1 + a2 + a3) * maturity
    denom = fkb * (1.0 + omb**2 / 24.0 * lfk**2
                   + omb**4 / 1920.0 * lfk**4)
    z = nu / alpha * fkb * lfk
    small = torch.abs(z) < 1e-6
    zsafe = torch.where(small, 1.0, z)
    sq = torch.sqrt(1.0 - 2.0 * rho * zsafe + zsafe * zsafe)
    xsafe = torch.log((sq + zsafe - rho) / (1.0 - rho))
    z_over_x = torch.where(small, 1.0 + 0.5 * rho * z, zsafe / xsafe)
    return alpha / denom * z_over_x * term_t


# ---------------------------------------------------------------------------
# Monte-Carlo simulation
# ---------------------------------------------------------------------------

def _sabr_terminal(seed: int, num_paths: int, num_steps: int, f0, alpha,
                   beta, rho, nu, dt, antithetic: bool, *, normals=None,
                   device=None) -> torch.Tensor:
    """Terminal displaced forward X_T = F_T + d >= 0 (absorbed at 0),
    ``[num_paths]`` float32 on ``device`` (default ``select_device()``).
    Log-Euler on X with the alpha leg exact; antithetic mirrors BOTH
    normals (the payoff is monotone in each). The scalars are rounded to
    float32 and every step is float32, as in the JAX simulator.

    The normals: two ``[num_steps, num_paths / 2]`` float32 blocks from
    ``torch.Generator(device).manual_seed(seed)`` (``num_paths`` of them
    without ``antithetic``), mirrored ``[z, -z]`` along the path axis when
    antithetic; or the caller's ``normals=(z1, z2)``, two ``[num_steps,
    num_paths]`` blocks used as given (the JAX stream can be fed in)."""
    device = torch.device(device) if device is not None else select_device()

    def scalar(v):
        return torch.as_tensor(v, dtype=FLOAT_DTYPE, device=device)

    f0, alpha, beta, rho, nu, dt = map(scalar, (f0, alpha, beta, rho, nu, dt))
    if normals is None:
        half = num_paths // 2 if antithetic else num_paths
        gen = torch.Generator(device=device).manual_seed(int(seed))
        z1, z2 = (torch.randn((num_steps, half), generator=gen,
                              dtype=FLOAT_DTYPE, device=device)
                  for _ in range(2))
        if antithetic:
            z1 = torch.cat([z1, -z1], dim=1)
            z2 = torch.cat([z2, -z2], dim=1)
    else:
        z1, z2 = (torch.as_tensor(z, dtype=FLOAT_DTYPE).to(device)
                  for z in normals)
        if z1.shape != (num_steps, num_paths) or z2.shape != z1.shape:
            raise ValueError(
                f"normals of shapes {tuple(z1.shape)}, {tuple(z2.shape)}; "
                f"need two [{num_steps}, {num_paths}] blocks")
    w2 = rho * z1 + torch.sqrt(1.0 - rho * rho) * z2
    sqdt = torch.sqrt(dt)
    beta_m1 = beta - 1.0
    a_vol, a_drift = nu * sqdt, 0.5 * nu * nu * dt
    x = torch.full((num_paths,), float(f0), dtype=FLOAT_DTYPE, device=device)
    a = torch.full((num_paths,), float(alpha), dtype=FLOAT_DTYPE,
                   device=device)
    for s in range(num_steps):
        # local lognormal step in X: dX = a X^beta dW1 ->
        # dlogX = a X^(beta-1) dW1 - (a X^(beta-1))^2 dt / 2
        alive = x > 0.0
        sig_loc = a * torch.where(alive, x, 1.0) ** beta_m1
        x_new = x * torch.exp(sig_loc * sqdt * z1[s]
                              - 0.5 * sig_loc * sig_loc * dt)
        x = torch.where(alive, x_new, 0.0)            # absorbed
        a = a * torch.exp(a_vol * w2[s] - a_drift)    # exact vol leg
    return x


def mc_sabr_option_prices(params: SABRParams, forward: float,
                          maturity: float, strikes,
                          num_paths: int = 1_000_000,
                          num_steps: int = 64, seed: int = 1234,
                          antithetic: bool = True, *, device=None):
    """Undiscounted European call prices E[(F_T - K)+] under SABR from one
    simulation on ``device`` (default ``select_device()``); returns
    (prices [K] float64 NumPy, Monte-Carlo forward). The payoff means are
    float64 and come to the host in one transfer of [K prices, forward]."""
    d = params.displacement
    x_t = _sabr_terminal(seed, int(num_paths), int(num_steps), forward + d,
                         params.alpha, params.beta, params.rho, params.nu,
                         maturity / num_steps, bool(antithetic),
                         device=device)
    ks = torch.as_tensor(np.asarray(strikes, dtype=np.float64) + d,
                         dtype=ACC_DTYPE, device=x_t.device)
    xa = x_t.to(ACC_DTYPE)
    pay = torch.clamp_min(xa[None, :] - ks[:, None], 0.0)
    out = torch.cat([pay.mean(dim=1), xa.mean()[None]]).cpu().numpy()
    return out[:-1], float(out[-1] - d)


@dataclass
class SABRCalibrationResult:
    params: SABRParams
    rms_vol_error: float
    iterations: int
    converged: bool


def calibrate_sabr(forward: float, maturity: float, strikes,
                   vols, quote_type: str = "lognormal",
                   beta: float = 0.5, displacement: float = 0.0,
                   x0: Optional[SABRParams] = None,
                   max_iterations: int = 200,
                   accuracy: float = 1e-10) -> SABRCalibrationResult:
    """Fit (alpha, rho, nu) at fixed beta and displacement to one smile of
    implied vols (the market convention: beta is chosen, not fitted), by
    Levenberg-Marquardt in the unconstrained chart (log alpha, atanh rho,
    log nu) on the Hagan expansion with a central-difference Jacobian.
    quote_type: 'lognormal' (Black) or 'normal' (Bachelier)."""
    from .calibration import LevenbergMarquardt

    if quote_type not in ("lognormal", "normal"):
        raise ValueError("quote_type must be 'lognormal' or 'normal'")
    ks = np.asarray(strikes, dtype=np.float64)
    target = np.asarray(vols, dtype=np.float64)
    if ks.shape != target.shape or ks.size < 3:
        raise ValueError("need >= 3 (strike, vol) pairs of equal length")
    fn = (sabr_lognormal_implied_volatility if quote_type == "lognormal"
          else sabr_normal_implied_volatility)

    def unpack(y):
        return SABRParams(alpha=math.exp(y[0]), beta=beta,
                          rho=math.tanh(y[1]), nu=math.exp(y[2]),
                          displacement=displacement)

    def residuals(y):
        p = unpack(y)
        return np.asarray([fn(p, forward, k, maturity) for k in ks]) \
            - target

    def jacobian(y):
        h = 1e-7
        cols = []
        for i in range(3):
            yp, ym = y.copy(), y.copy()
            yp[i] += h
            ym[i] -= h
            cols.append((residuals(yp) - residuals(ym)) / (2 * h))
        return np.stack(cols, axis=1)

    if x0 is None:
        # alpha from the ATM quote's leading term
        atm = float(np.interp(forward, ks, target))
        fpd = forward + displacement
        alpha0 = (atm * fpd ** (1.0 - beta) if quote_type == "lognormal"
                  else atm / fpd ** beta)
        x0 = SABRParams(alpha=max(alpha0, 1e-6), beta=beta, rho=0.0,
                        nu=0.5, displacement=displacement)
    y0 = np.array([math.log(x0.alpha), math.atanh(x0.rho),
                   math.log(max(x0.nu, 1e-8))])
    lm = LevenbergMarquardt(residuals, jacobian,
                            max_iterations=max_iterations,
                            accuracy=accuracy,
                            lower_bound=-np.inf, upper_bound=np.inf)
    res = lm.run(y0)
    p = unpack(res.parameters)
    return SABRCalibrationResult(
        params=p,
        rms_vol_error=float(
            np.sqrt(np.mean(residuals(res.parameters) ** 2))),
        iterations=res.iterations, converged=res.converged)


def mc_sabr_implied_vols(params: SABRParams, forward: float,
                         maturity: float, strikes,
                         quote_type: str = "lognormal",
                         **mc_kwargs):
    """Monte-Carlo smile in the requested quote convention (the validation
    hook for the Hagan expansion); ``mc_kwargs`` go to
    :func:`mc_sabr_option_prices` (``device=`` among them)."""
    prices, _ = mc_sabr_option_prices(params, forward, maturity, strikes,
                                      **mc_kwargs)
    inv = (black_implied_volatility if quote_type == "lognormal"
           else bachelier_implied_volatility)
    d = params.displacement if quote_type == "lognormal" else 0.0
    out = []
    for k, p in zip(np.asarray(strikes, dtype=np.float64), prices):
        if quote_type == "lognormal":
            # displaced quotes invert on the shifted pair
            out.append(inv(forward + d, k + d, maturity, float(p)))
        else:
            out.append(inv(forward, k, maturity, float(p)))
    return np.asarray(out)
