"""Plain reference of the LIBOR market model configurations.

Written from the configuration files (market data, grids, covariance
forms) and the published descriptions of finmath-lib's
LIBORMarketModelCalibrationATMTest and LIBORMarketModelCalibrationTest:
the discount and forward curves, the calibration swaptions, the
covariance, an Euler simulation of the spot-measure NORMAL LMM on given
sqrt(dt)-scaled Brownian increments, the swaption values and their
implied volatilities. Plain NumPy and PyTorch, no kernels; it imports
nothing of the program and takes nothing the program made.

``dtype`` is the type of the path state (the forwards, loadings, drift
and diffusion) and ``collect`` that of the bond curve, annuity, payoff,
numeraire and path sums. The reference runs at float64 / float64; the
control at one precision below what the configurations state (float32
paths, float64 sums): bfloat16 / float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import brentq
from scipy.special import ndtr

FIXED_CLAMP = 1e3          # forwards are held inside +-1e3
V_CAP = 1e6                # the stochastic-volatility scale is capped here


# ---------------------------------------------------------------------------
# curves (host, float64)
# ---------------------------------------------------------------------------

class DiscountCurve:
    """Discount factors interpolated linearly in their logarithm, held
    constant beyond the last pillar."""

    def __init__(self, times, factors):
        self.times = np.asarray(times, dtype=np.float64)
        self.log_factors = np.log(np.asarray(factors, dtype=np.float64))

    def df(self, t):
        return np.exp(np.interp(np.asarray(t, dtype=np.float64), self.times,
                                self.log_factors))


def bootstrap_par_swaps(maturities, rates, fixed_period=1.0) -> DiscountCurve:
    """Single-curve bootstrap: each pillar's discount factor makes its par
    swap (annual fixed leg, a stub below one year; the floating leg
    telescoped to 1 - df(T)) worth zero."""
    order = np.argsort(maturities)
    times, factors = [0.0], [1.0]
    for T, c in zip(np.asarray(maturities, float)[order],
                    np.asarray(rates, float)[order]):
        if T < fixed_period:
            pay, acc = np.asarray([T]), np.asarray([T])
        else:
            k = int(round(T / fixed_period))
            pay = fixed_period * np.arange(1, k + 1, dtype=np.float64)
            pay[-1] = T
            acc = np.full(k, fixed_period)

        def value(x):
            curve = DiscountCurve(times + [T], factors + [x])
            return c * float(np.sum(acc * curve.df(pay))) - (1.0 - x)

        x = brentq(value, 1e-4, 2.0, xtol=1e-16, rtol=1e-15, maxiter=500)
        times.append(float(T))
        factors.append(x)
    return DiscountCurve(times, factors)


def curve_from_forwards(fixings, forwards, period, horizon) -> DiscountCurve:
    """Discount factors on the fixing grid implied by simply compounded
    forwards (linear in the fixing time, constant outside)."""
    n = int(round(horizon / period))
    t = period * np.arange(n + 1, dtype=np.float64)
    f = np.interp(t[:-1], fixings, forwards)
    return DiscountCurve(t, np.concatenate([[1.0], np.cumprod(
        1.0 / (1.0 + period * f))]))


def _years(code: str) -> float:
    return int(code[:-1]) / 12.0 if code[-1] == "M" else float(code[:-1])


# ---------------------------------------------------------------------------
# the model of one configuration
# ---------------------------------------------------------------------------

class Model:
    """What a configuration file defines: the tenor grid, the curve, the
    products in the order of the residual rows, and the covariance as a
    function of the parameter vector."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.kind = cfg["kind"]
        dt = self.dt = float(cfg["dt"])
        n = self.n = int(cfg["num_libors"])
        self.F = int(cfg["num_factors"])
        self.T = dt * np.arange(n + 1, dtype=np.float64)
        self.deltas = np.full(n, dt)
        m = cfg["market"]
        if self.kind == "atm":
            self.curve = bootstrap_par_swaps(m["swap_maturities"],
                                             m["swap_rates"])
        else:
            self.curve = curve_from_forwards(
                np.asarray(m["fixing_times"]), np.asarray(m["forwards"]),
                dt, float(m["horizon"]))
        dfs = self.curve.df(self.T)
        self.df_tenor = dfs
        if self.kind == "atm":
            self.L0 = (dfs[:-1] / self.curve.df(self.T[:-1] + dt) - 1.0) / dt
        else:
            self.L0 = np.interp(self.T[:-1], m["fixing_times"], m["forwards"])
        self.products = self._products()

    @property
    def stoch_vol(self) -> bool:
        return self.kind != "atm"

    def initial(self) -> np.ndarray:
        """The published initial parameters (the pricers' point)."""
        if "initial_parameters" in self.cfg:
            return np.asarray(self.cfg["initial_parameters"], np.float64)
        return np.full(self.n_params(), float(self.cfg["initial_volatility"]))

    def start(self) -> np.ndarray:
        """Where a calibration starts."""
        if "start" in self.cfg:
            return np.asarray(self.cfg["start"], np.float64)
        return self.initial()

    # -- products ------------------------------------------------------
    def par_rate(self, e: int, m: int) -> float:
        """Forward swap rate over periods e .. e + m - 1 on the forward
        curve the model starts from."""
        d = self.deltas[e:e + m]
        df_pay = self.df_tenor[e + 1:e + m + 1]
        fwd = self._curve_forward(self.T[e:e + m])
        return float(np.sum(d * fwd * df_pay) / np.sum(d * df_pay))

    def _curve_forward(self, t):
        if self.kind == "atm":
            return (self.curve.df(t) / self.curve.df(t + self.dt) - 1.0) \
                / self.dt
        m = self.cfg["market"]
        return np.interp(t, m["fixing_times"], m["forwards"])

    def _products(self):
        """(e, m, strike, target) sorted by (e, m), as the residual rows."""
        cfg, dt, n = self.cfg, self.dt, self.n
        out = []
        if self.kind == "atm":
            m = cfg["market"]
            for ex, te, vol in zip(m["atm_expiries"], m["atm_tenors"],
                                   m["atm_normal_vols"]):
                x = round(_years(ex) / 0.25) * 0.25
                y = round(_years(te) / 0.25) * 0.25
                if x < cfg["min_expiry"] or x + y > cfg["last_time"]:
                    continue
                e, k = int(round(x / dt)), int(round(y / dt))
                out.append((e, k, self.par_rate(e, k), vol))
        else:
            m = cfg["market"]
            periods = int(m["num_periods"])
            quotes = [(m["smile_expiry"], mo, v) for mo, v in
                      zip(m["smile_moneyness"], m["smile_vols"])]
            quotes += [(t, 0.0, v) for t, v in
                       zip(m["atm_maturities"], m["atm_vols"])]
            for x, mo, vol in quotes:
                e = int(round(x / dt))
                if e + periods > n:
                    continue
                out.append((e, periods, mo + self.par_rate(e, periods), vol))
        out = [p for p in out if p[0] >= 1 and p[0] + p[1] <= n]
        return sorted(out, key=lambda p: (p[0], p[1]))

    # -- covariance ------------------------------------------------------
    def vol_table(self, x) -> np.ndarray:
        """sigma_i(t_s), ``[n steps, n libors]``, 0 once libor i has
        fixed."""
        n, T = self.n, self.T
        t = T[:n, None]
        ttm = T[None, :n] - t
        alive = ttm > 0
        if self.kind == "atm":
            grid = np.asarray(self.cfg["vol_buckets"], dtype=np.float64)
            table = np.zeros((n, n))
            ids = {}
            for s in range(n):
                for i in range(n):
                    if not alive[s, i]:
                        continue
                    key = (self._bucket(grid, T[s]), self._bucket(grid,
                                                                  ttm[s, i]))
                    ids.setdefault(key, len(ids))
                    table[s, i] = x[ids[key]]
            return table
        a, b, c, d = x[:4]
        vol = (a + b * ttm) * np.exp(-c * ttm) + d
        return np.where(alive, np.maximum(vol, 0.0), 0.0)

    @staticmethod
    def _bucket(grid, t):
        return int(np.clip(np.searchsorted(grid, t + 1e-12) - 1, 0,
                           len(grid) - 1))

    def n_params(self) -> int:
        if self.kind == "atm":
            n, T = self.n, self.T
            grid = np.asarray(self.cfg["vol_buckets"], dtype=np.float64)
            return len({(self._bucket(grid, T[s]),
                         self._bucket(grid, T[i] - T[s]))
                        for s in range(n) for i in range(n) if T[i] > T[s]})
        return 8

    def factors(self, x) -> np.ndarray:
        """``[n, F]``: the leading eigenvectors of rho_ij = exp(-a |T_i -
        T_j|), scaled by the roots of their eigenvalues, rows of unit
        norm. The stoch-vol configuration fixes each column's sign by its
        first row (``factor_signs``); the ATM one keeps LAPACK's signs."""
        T = self.T[:self.n]
        a = (self.cfg["correlation_decay"] if self.kind == "atm"
             else abs(float(x[4])))
        w, v = np.linalg.eigh(np.exp(-a * np.abs(T[:, None] - T[None, :])))
        top = np.argsort(w)[::-1][:self.F]
        R = v[:, top] * np.sqrt(np.maximum(w[top], 0.0))[None, :]
        R = R / np.linalg.norm(R, axis=1, keepdims=True)
        if self.kind != "atm":
            signs = np.asarray(self.cfg["factor_signs"][:self.F])
            R = R * np.where(R[:1] * signs < 0, -1.0, 1.0)
        return R

    def scalars(self, x):
        """(blend, nu, rho) of the stoch-vol form, None for the ATM one."""
        if self.kind == "atm":
            return None
        return float(x[5]), float(x[6]), float(x[7])


# ---------------------------------------------------------------------------
# simulation and valuation
# ---------------------------------------------------------------------------

def path_sums(model: Model, x, increments: torch.Tensor, events, *,
              dtype=torch.float64, collect=torch.float64):
    """Euler sweep of the spot-measure NORMAL LMM over ``increments``
    ``[S, F (+1), paths]`` (sqrt(dt)-scaled; the last row drives the
    stochastic volatility): for every exercise step e of ``events`` ({e:
    [(m, strike), ...]}), the path sums of max(1 - P(T_e, T_e+m) - K A,
    0) / N(T_e) per product and of 1 / N(T_e)."""
    dev = increments.device
    n, F, dt = model.n, model.F, model.dt
    vol = torch.as_tensor(model.vol_table(x), dtype=dtype, device=dev)
    R = torch.as_tensor(model.factors(x), dtype=dtype, device=dev)
    d = torch.as_tensor(model.deltas, dtype=dtype, device=dev)
    d_c = torch.as_tensor(model.deltas, dtype=collect, device=dev)
    L0 = torch.as_tensor(model.L0, dtype=dtype, device=dev)
    paths = increments.shape[2]
    L = L0[:, None].repeat(1, paths)
    N = torch.ones(paths, dtype=collect, device=dev)
    sv = model.scalars(x)
    if sv is not None:
        blend, nu, rho = sv
        somega = math.sqrt(max(1.0 - rho * rho, 1e-12))
        V = torch.ones(paths, dtype=collect, device=dev)
    out = {}
    last = max(events)
    for s in range(last + 1):
        if s in events:
            Lc = L.to(collect)
            N_inv = 1.0 / N
            sums = []
            for m, strike in events[s]:
                disc = torch.cumprod(1.0 / (1.0 + d_c[s:s + m, None]
                                            * Lc[s:s + m]), dim=0)
                annuity = torch.sum(d_c[s:s + m, None] * disc, dim=0)
                payoff = torch.clamp_min(1.0 - disc[-1] - strike * annuity,
                                         0.0)
                c = payoff * N_inv
                sums.append(torch.where(torch.isfinite(c), c, 0.0).sum())
            inv = torch.where(torch.isfinite(N_inv), N_inv, 0.0).sum()
            out[s] = (torch.stack(sums), inv)
        if s == last:
            break
        dw = increments[s].to(dtype)
        N = N * (1.0 + d[s] * L[s]).to(collect)
        a = s + 1
        La = L[a:]
        lam = vol[s, a:, None].expand(n - a, paths)
        if sv is not None:
            lam = lam * ((1.0 - blend) * La + blend * L0[a:, None])
            lam = lam * torch.sqrt(V.to(dtype))
        lam = lam[:, None, :] * R[a:, :, None]                 # [n', F, P]
        mt = d[a:, None] / (1.0 + d[a:, None] * La)
        acc = torch.cumsum(mt[:, None, :] * lam, dim=0)
        mu = torch.sum(lam * acc, dim=1)
        diffusion = torch.sum(lam * dw[None, :F], dim=1)
        L = torch.cat([L[:a], torch.clamp(La + mu * dt + diffusion,
                                          -FIXED_CLAMP, FIXED_CLAMP)])
        if sv is not None:
            dwv = rho * dw[0].to(collect) + somega * dw[F].to(collect)
            V = torch.clamp_max(V * torch.exp(nu * dwv - 0.5 * nu * nu * dt),
                                V_CAP)
    return out


def _events(products):
    ev = {}
    for e, m, strike, _ in products:
        ev.setdefault(e, []).append((m, strike))
    return ev


def swaption_values(model: Model, x, increments, *, dtype=torch.float64,
                    collect=torch.float64) -> np.ndarray:
    """Monte-Carlo values of the calibration products (residual order),
    with the numeraire adjustment df(T_e) / E[1 / N(T_e)] where the
    configuration asks for it."""
    events = _events(model.products)
    paths = increments.shape[2]
    sums = path_sums(model, x, increments, events, dtype=dtype,
                     collect=collect)
    values = []
    for e in sorted(events):
        raw = np.atleast_1d(sums[e][0].double().cpu().numpy()) / paths
        if model.cfg["numeraire_adjustment"]:
            mean_inv = float(sums[e][1]) / paths
            raw = raw * (model.df_tenor[e] / mean_inv if mean_inv > 0
                         else 0.0)
        values.extend(raw.tolist())
    return np.asarray(values)


def _quote_inputs(model: Model):
    P = model.products
    e = np.asarray([p[0] for p in P])
    m = np.asarray([p[1] for p in P])
    ann = np.asarray([np.sum(model.deltas[a:a + b]
                             * model.df_tenor[a + 1:a + b + 1])
                      for a, b in zip(e, m)])
    fwd = np.asarray([model.par_rate(a, b) for a, b in zip(e, m)])
    strike = np.asarray([p[2] for p in P])
    return fwd, strike, model.T[e], ann


def _bisect(f, lo, hi, like, iters=200):
    """Vectorised bisection for an increasing ``f``: the root of each
    element, shaped ``like``."""
    lo, hi = np.full_like(like, lo), np.full_like(like, hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        up = f(mid) > 0
        hi = np.where(up, mid, hi)
        lo = np.where(up, lo, mid)
    return 0.5 * (lo + hi)


def normal_implied_vol(value, fwd, strike, texp, ann) -> np.ndarray:
    """Bachelier volatility of a payer swaption's value per unit annuity."""
    p = np.maximum(value / ann, 1e-14)
    rt = np.sqrt(texp)

    def g(s):
        d = (fwd - strike) / (s * rt)
        return ((fwd - strike) * ndtr(d) + s * rt * np.exp(-0.5 * d * d)
                / math.sqrt(2.0 * math.pi) - p)
    return _bisect(g, 1e-12, 10.0, p)


def black_implied_vol(value, fwd, strike, texp, ann) -> np.ndarray:
    """Black volatility, from the out-of-the-money twin's time value; 0
    where the value is at or below intrinsic."""
    p = value / ann
    tv = p - np.maximum(fwd - strike, 0.0)
    rt = np.sqrt(texp)
    lk = np.log(fwd / strike)
    itm = fwd >= strike

    def g(s):
        v = s * rt
        d1, d2 = lk / v + 0.5 * v, lk / v - 0.5 * v
        call = fwd * ndtr(d1) - strike * ndtr(d2)
        put = strike * ndtr(-d2) - fwd * ndtr(-d1)
        return np.where(itm, put, call) - np.maximum(tv, 1e-300)
    sigma = _bisect(g, 1e-8, 10.0, p)
    return np.where(tv <= 1e-12 * fwd, 0.0, sigma)


def residuals(model: Model, x, increments, **kw) -> np.ndarray:
    """Model quote minus target per calibration product (unit weights)."""
    values = swaption_values(model, np.asarray(x, np.float64), increments,
                             **kw)
    invert = (normal_implied_vol if model.kind == "atm"
              else black_implied_vol)
    quotes = invert(values, *_quote_inputs(model))
    return quotes - np.asarray([p[3] for p in model.products])


# ---------------------------------------------------------------------------
# the single-swaption pricer
# ---------------------------------------------------------------------------

def swaption_price(model: Model, x, exercise: int, periods: int,
                   strike: float, normals_of, paths: int, *,
                   dtype=torch.float64, collect=torch.float64,
                   block: int = 1 << 19, device="cpu") -> float:
    """E[max(1 - P - K A, 0) / N(T_e)] without numeraire adjustment, the
    paths in blocks: ``normals_of(lo, hi)`` gives the standard normals
    ``[S, F (+1), hi - lo]`` of paths lo .. hi - 1."""
    total = 0.0
    for lo in range(0, paths, block):
        hi = min(paths, lo + block)
        z = normals_of(lo, hi).to(device=device, dtype=torch.float64)
        inc = z * math.sqrt(model.dt)
        part = path_sums(model, x, inc, {exercise: [(periods, strike)]},
                         dtype=dtype, collect=collect)
        total += float(part[exercise][0].double().sum())
    return total / paths
