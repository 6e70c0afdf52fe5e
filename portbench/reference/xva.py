"""Plain reference of a netting set's exposure profile on the spot-measure
NORMAL LIBOR market model with blended local and stochastic volatility.

Written from the published conventions of the exposure layer (finmath-lib's
``ExposureEstimator`` over swaps, European and Bermudan swaptions, and the
conventions stated in the port's exposure module's docstrings), not from
its code. Plain NumPy and PyTorch, no kernels; it imports nothing of the
program and takes nothing the program made but the standard normals, which
it draws itself from the request's seed with torch's generator on the
given device (``normals``), as the port's ``brownian_motion`` documents.

Conventions:

* the Euler step of the LMM on sqrt(dt)-scaled increments ``[S, F + 1,
  paths]`` (the last row drives the stochastic volatility): loadings
  ``sigma_i(t) ((1 - b) L_i + b L_i(0)) sqrt(V) R_i``, the spot drift over
  the live forwards ``j <= i``, forwards held inside +-1e3, ``V`` a
  lognormal martingale capped at 1e6; the spot numeraire accrues at each
  tenor date at the just-fixed forward;
* an observation at tenor index ``e`` is taken at the step's start, before
  its accrual: a swap's remaining periods are ``[max(e, first), last)``,
  valued on the simulated curve ``P(T_e, T_j) = prod 1 / (1 + delta L)``
  as ``sum delta_j (L_j - K) P(T_e, T_{j+1})`` in time-e money;
* a path whose values at a date are not all finite counts zero there;
* a European swaption's close-out value before expiry is the regression
  of its discounted payoff on (1, s, s^2), s the underlying's par rate,
  floored at 0 (the normal
  equations carry the estimator's published Tikhonov jitter, 1e-12
  trace(G)); at expiry its payoff; after it (physical settlement) the
  swap on the paths that exercised (value > 0);
* a Bermudan: Longstaff-Schwartz backward induction on all paths,
  exercise iff in the money and above the regressed continuation; every
  path stops at its first exercise; before the first exercise date the
  close-out value is the regression of the policy's stopped payoff on
  all paths, between exercise dates on the alive paths only (masked
  normal equations), at an exercise date the continuation; exercised
  paths carry the underlying swap (physical), each value floored at 0 on
  the alive paths;
* the CSA: the requirement from the netted value ``margin_lag`` dates
  before, two thresholds, the minimum transfer amount applied date by
  date, the independent amount; exposure is the value less the balance;
* EE, ENE: means of the positive and negative parts of the discounted
  residual exposure; forward value: the mean discounted netted value;
  standalone EE: the mean of the sum of the trades' discounted positive
  parts; gross EE and ENE: those of the netted value before margin; PFE:
  quantiles (linear between order statistics) of the undiscounted
  residual exposure.

``dtype`` is the type of the path state (forwards, loadings, drift,
diffusion), ``collect`` that of everything after it: the curve, the
values, the regressions' sums and the means. The reference runs at
float64 / float64; the control at float32 paths, one precision below
what the configuration states (float64 paths), and float64 sums.
The paths run in blocks; the regressions sum their normal equations over
the blocks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

FIXED_CLAMP = 1e3          # forwards are held inside +-1e3
V_CAP = 1e6                # the stochastic-volatility scale is capped here
BLOCK = 1 << 17            # paths per block


@dataclass
class Market:
    """The model's inputs at one parameter vector, float64 NumPy:
    ``vol`` ``[steps, n]``, ``factors`` ``[n, F]``, ``L0``, ``deltas``
    ``[n]``; ``blend``, ``nu``, ``rho``; ``dt`` the step."""

    vol: np.ndarray
    factors: np.ndarray
    L0: np.ndarray
    deltas: np.ndarray
    blend: float
    nu: float
    rho: float
    dt: float

    @property
    def n(self) -> int:
        return int(self.L0.shape[0])

    @property
    def F(self) -> int:
        return int(self.factors.shape[1])


def normals(seed: int, steps: int, rows: int, paths: int,
            device) -> torch.Tensor:
    """``[steps, rows, paths]`` float32 standard normals from torch's
    generator of ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((steps, rows, paths), generator=gen,
                       dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the netting set
# ---------------------------------------------------------------------------

def par_rate(L0, deltas, first: int, last: int) -> float:
    """The forward swap rate over periods ``first .. last - 1`` on the
    initial curve."""
    P = np.concatenate([[1.0], np.cumprod(1.0 / (1.0 + deltas * L0))])
    d = deltas[first:last]
    return float(np.sum(d * L0[first:last] * P[first + 1:last + 1])
                 / np.sum(d * P[first + 1:last + 1]))


def draw_trades(L0, deltas, seed: int, swaps: int = 160,
                europeans: int = 24, bermudans: int = 16) -> dict:
    """A netting set drawn from ``seed`` on the tenor grid (``n`` periods
    of ``dt``): swaps, a quarter forward-starting (first period 1-10Y),
    the rest from the first tenor date, maturities to 20Y, payer and
    receiver half each, strikes par +- up to 150 bp, notionals lognormal
    (sigma 0.5); European payer swaptions, expiries 1-10Y, tenors 1-10Y
    inside the grid, strikes par +- up to 100 bp, long and short half each;
    Bermudan payer swaptions, first exercise 1-5Y, annual exercises to a
    final maturity up to 20Y, strikes par +- up to 100 bp, long and short
    half each, all physically settled. The last swap runs to the end of
    the grid."""
    rng = np.random.default_rng(seed)
    n = len(L0)
    per_year = int(round(1.0 / float(deltas[0])))
    out = {"swaps": [], "europeans": [], "bermudans": []}
    for k in range(swaps):
        first = (int(rng.integers(per_year, 10 * per_year + 1))
                 if k % 4 == 3 else 1)
        last = (n if k == swaps - 1
                else int(rng.integers(first + 1, n + 1)))
        strike = par_rate(L0, deltas, first, last) + float(
            rng.uniform(-0.015, 0.015))
        out["swaps"].append(dict(
            first=first, last=last, strike=round(strike, 6),
            payer=bool(k % 2 == 0),
            notional=round(float(np.exp(0.5 * rng.standard_normal())), 6)))
    for k in range(europeans):
        x = int(rng.integers(per_year, 10 * per_year + 1))
        m = int(rng.integers(per_year, min(10 * per_year, n - x) + 1))
        strike = par_rate(L0, deltas, x, x + m) + float(
            rng.uniform(-0.01, 0.01))
        size = float(np.exp(0.5 * rng.standard_normal()))
        out["europeans"].append(dict(
            exercise=x, periods=m, strike=round(strike, 6),
            notional=round(size if k % 2 == 0 else -size, 6)))
    for k in range(bermudans):
        x = int(rng.integers(per_year, 5 * per_year + 1))
        last = int(rng.integers(x + 2 * per_year, n + 1))
        strike = par_rate(L0, deltas, x, last) + float(
            rng.uniform(-0.01, 0.01))
        size = float(np.exp(0.5 * rng.standard_normal()))
        out["bermudans"].append(dict(
            exercises=list(range(x, last, per_year)), last=last,
            strike=round(strike, 6),
            notional=round(size if k % 2 == 0 else -size, 6)))
    return out


# ---------------------------------------------------------------------------
# simulation and collection
# ---------------------------------------------------------------------------

def _swap_matrices(trades, obs, n, deltas):
    """Per observation ordinal, ``[T, n]`` float64 masks: delta_j on the
    remaining periods of each swap-like trade ``(first, last, strike)``."""
    out = np.zeros((len(obs), len(trades), n))
    for ev, e in enumerate(obs):
        for t, (first, last, _) in enumerate(trades):
            lo = max(e, first)
            if lo < last:
                out[ev, t, lo:last] = deltas[lo:last]
    return out


def _collect_block(mk: Market, inc: torch.Tensor, obs, tables, dtype,
                   collect, out, lo: int) -> None:
    """One block of paths, written into ``out`` at paths ``lo ..``: per
    observation date the netted swap value, the standalone positive-part
    sum and 1/N ``[E, paths]``, the underlyings' values and par rates
    ``[E, K, paths]``, in ``collect``, zeroed where the date's values are
    not all finite."""
    dev = inc.device
    n, F, dt = mk.n, mk.F, mk.dt
    paths = inc.shape[2]
    hi = lo + paths
    vol = torch.as_tensor(mk.vol, dtype=dtype, device=dev)
    R = torch.as_tensor(mk.factors, dtype=dtype, device=dev)
    d = torch.as_tensor(mk.deltas, dtype=dtype, device=dev)
    d_c = torch.as_tensor(mk.deltas, dtype=collect, device=dev)
    L0 = torch.as_tensor(mk.L0, dtype=dtype, device=dev)
    somega = math.sqrt(max(1.0 - mk.rho * mk.rho, 1e-12))
    s_mask, s_strike, s_coef, u_mask, u_strike = tables
    L = L0[:, None].repeat(1, paths)
    N = torch.ones(paths, dtype=collect, device=dev)
    V = torch.ones(paths, dtype=collect, device=dev)
    at = {e: ev for ev, e in enumerate(obs)}
    for s in range(max(obs) + 1):
        if s in at:
            ev = at[s]
            Lc = L.to(collect)
            # P(T_e, T_{j+1}) for j >= e, zero below e
            pay = torch.zeros((n, paths), dtype=collect, device=dev)
            pay[s:] = torch.cumprod(1.0 / (1.0 + d_c[s:, None] * Lc[s:]),
                                    dim=0)
            float_leg = Lc * pay                       # L_j P(T_e, T_j+1)
            inv_n = 1.0 / N
            v_trade = s_coef[:, None] * (s_mask[ev] @ float_leg
                                         - s_strike[:, None]
                                         * (s_mask[ev] @ pay))
            v_net = v_trade.sum(0)
            s_plus = torch.clamp_min(v_trade, 0.0).sum(0)
            fl_u = u_mask[ev] @ float_leg
            ann_u = u_mask[ev] @ pay
            v_u = fl_u - u_strike[:, None] * ann_u
            srate = fl_u / torch.clamp_min(ann_u, 1e-12)
            ok = (torch.isfinite(v_net) & torch.isfinite(s_plus)
                  & torch.isfinite(inv_n)
                  & torch.isfinite(v_u).all(0) & torch.isfinite(srate).all(0))
            for name, a in (("v_net", v_net), ("s_plus", s_plus),
                            ("inv_n", inv_n), ("v_u", v_u),
                            ("srate", srate)):
                out[name][ev, ..., lo:hi] = torch.where(ok, a, 0.0)
        if s == max(obs):
            break
        dw = inc[s].to(dtype)
        N = N * (1.0 + d[s] * L[s]).to(collect)
        a = s + 1
        La = L[a:]
        lam = vol[s, a:, None] * ((1.0 - mk.blend) * La
                                  + mk.blend * L0[a:, None])
        lam = lam * torch.sqrt(V.to(dtype))
        lam = lam[:, None, :] * R[a:, :, None]                 # [n', F, P]
        mt = d[a:, None] / (1.0 + d[a:, None] * La)
        acc = torch.cumsum(mt[:, None, :] * lam, dim=0)
        mu = torch.sum(lam * acc, dim=1)
        diffusion = torch.sum(lam * dw[None, :F], dim=1)
        L = torch.cat([L[:a], torch.clamp(La + mu * dt + diffusion,
                                          -FIXED_CLAMP, FIXED_CLAMP)])
        dwv = mk.rho * dw[0].to(collect) + somega * dw[F].to(collect)
        V = torch.clamp_max(V * torch.exp(mk.nu * dwv
                                          - 0.5 * mk.nu * mk.nu * dt), V_CAP)


# ---------------------------------------------------------------------------
# the regressions
# ---------------------------------------------------------------------------

def _fit_predict(feature, y, weight=None, block: int = BLOCK):
    """E[y | 1, s, s^2] on every path: the normal equations summed over
    blocks of paths (``weight`` 1/0 restricts them to some paths), with
    the published Tikhonov jitter 1e-12 trace(G) on the diagonal, solved
    in float64 (NaN where the sums overflowed or no path is left)."""
    B = 3
    gram = torch.zeros((B, B), dtype=y.dtype, device=y.device)
    rhs = torch.zeros(B, dtype=y.dtype, device=y.device)
    for lo in range(0, y.shape[0], block):
        s = feature[lo:lo + block]
        X = torch.stack([torch.ones_like(s), s, s * s])
        if weight is not None:
            X = X * weight[lo:lo + block]
        gram += X @ X.T
        rhs += X @ y[lo:lo + block]
    g, v = gram.double().cpu().numpy(), rhs.double().cpu().numpy()
    jitter = 1e-12 * np.trace(g)
    if not (np.all(np.isfinite(g)) and np.all(np.isfinite(v))) \
            or not jitter > 0.0:
        # sums beyond the collect type's range, or no path: no fit
        beta = np.full(B, np.nan)
    else:
        beta = np.linalg.solve(g + jitter * np.eye(B), v)
    b = torch.as_tensor(beta, dtype=y.dtype, device=y.device)
    return b[0] + b[1] * feature + b[2] * feature * feature


# ---------------------------------------------------------------------------
# the profile
# ---------------------------------------------------------------------------

def profile(mk: Market, trades: dict, obs, z: torch.Tensor, csa=None,
            quantiles=(0.95, 0.99), numeraire_df=None, *,
            dtype=torch.float64, collect=torch.float64,
            block: int = BLOCK) -> dict:
    """The netting set's profile on the standard normals ``z`` ``[S, F +
    1, paths]`` (scaled here by sqrt(dt)): a dict of ``[E]`` float64
    arrays ``ee``, ``ene``, ``forward_value``, ``ee_standalone`` (and
    ``ee_gross``, ``ene_gross`` with a ``csa``) and ``pfe`` {q: [E]}.

    ``trades``: ``draw_trades``' layout. ``csa``: a dict of
    ``threshold``, ``threshold_own``, ``mta``, ``independent_amount``,
    ``margin_lag``. ``numeraire_df``: discount factors at the observation
    dates for the numeraire adjustment df(T) / E[1/N(T)], None without
    it."""
    obs = list(obs)
    E = len(obs)
    swaps = [(t["first"], t["last"], t["strike"],
              (1.0 if t["payer"] else -1.0) * t["notional"])
             for t in trades["swaps"]]
    eur = trades["europeans"]
    ber = trades["bermudans"]
    unders = ([(t["exercise"], t["exercise"] + t["periods"], t["strike"])
               for t in eur]
              + [(t["exercises"][0], t["last"], t["strike"]) for t in ber])
    K = len(unders)
    dev = z.device
    paths = z.shape[2]

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=collect, device=dev)
    tables = (t(_swap_matrices([s[:3] for s in swaps], obs, mk.n,
                               mk.deltas)),
              t([s[2] for s in swaps]), t([s[3] for s in swaps]),
              t(_swap_matrices(unders, obs, mk.n, mk.deltas)),
              t([u[2] for u in unders]))
    cols = {name: torch.empty(shape, dtype=collect, device=dev)
            for name, shape in (("v_net", (E, paths)), ("s_plus", (E, paths)),
                                ("inv_n", (E, paths)),
                                ("v_u", (E, K, paths)),
                                ("srate", (E, K, paths)))}
    sq = math.sqrt(mk.dt)
    for lo in range(0, paths, block):
        inc = z[:, :, lo:lo + block].to(torch.float64) * sq
        _collect_block(mk, inc, obs, tables, dtype, collect, cols, lo)
    v_net, s_plus, inv_n, v_u, srate = (cols[k] for k in (
        "v_net", "s_plus", "inv_n", "v_u", "srate"))
    if numeraire_df is not None:
        mean_inv = inv_n.mean(1)
        adj = torch.where(mean_inv > 0, torch.as_tensor(
            numeraire_df, dtype=collect, device=z.device) / mean_inv, 0.0)
    else:
        adj = torch.ones(E, dtype=collect, device=z.device)
    disc = inv_n * adj[:, None]
    v_disc = v_net * disc
    s_plus_disc = s_plus * disc
    v_t = v_net.clone()

    def add(c):
        nonlocal v_disc, s_plus_disc, v_t
        v_disc = v_disc + c
        s_plus_disc = s_plus_disc + torch.clamp_min(c, 0.0)
        v_t = v_t + torch.where(disc > 0, c / disc, 0.0)

    for k, t in enumerate(eur):
        ex = obs.index(t["exercise"])
        h = torch.clamp_min(v_u[ex, k], 0.0) * disc[ex]
        exercised = v_u[ex, k] > 0
        rows = torch.zeros((E, paths), dtype=collect, device=z.device)
        for ev in range(ex):
            rows[ev] = torch.clamp_min(
                _fit_predict(srate[ev, k], h, block=block), 0.0)
        rows[ex] = h
        for ev in range(ex + 1, E):
            rows[ev] = torch.where(exercised, v_u[ev, k] * disc[ev], 0.0)
        add(t["notional"] * rows)
    for kb, t in enumerate(ber):
        u = len(eur) + kb
        xs = [obs.index(x) for x in t["exercises"]]
        M = len(xs)
        pay = [v_u[xs[m], u] * disc[xs[m]] for m in range(M)]
        # backward induction: exercise iff in the money and above the
        # continuation; the stopped payoff from each exercise date on
        stopped = torch.clamp_min(pay[M - 1], 0.0)
        cont = [None] * M
        ex_at = [None] * M
        cont[M - 1] = torch.zeros_like(stopped)
        ex_at[M - 1] = pay[M - 1] > 0
        after = [None] * M
        after[M - 1] = stopped
        for m in range(M - 2, -1, -1):
            cont[m] = _fit_predict(srate[xs[m], u], after[m + 1],
                                   block=block)
            ex_at[m] = (pay[m] > 0) & (pay[m] > cont[m])
            after[m] = torch.where(ex_at[m], pay[m], after[m + 1])
        # first exercise ordinal per path (E: never)
        stop = torch.full((paths,), E, dtype=torch.long, device=z.device)
        for m in range(M - 1, -1, -1):
            stop = torch.where(ex_at[m], xs[m], stop)
        rows = torch.zeros((E, paths), dtype=collect, device=z.device)
        for ev in range(E):
            exercised = torch.where(stop <= ev, v_u[ev, u] * disc[ev], 0.0)
            later = [m for m in range(M) if xs[m] >= ev]
            if not later:
                alive = torch.zeros_like(exercised)
            elif xs[later[0]] == ev:
                alive = torch.clamp_min(cont[later[0]], 0.0)
            elif later[0] == 0:
                alive = torch.clamp_min(_fit_predict(
                    srate[ev, u], after[0], block=block), 0.0)
            else:
                w = (stop > ev).to(collect)
                alive = torch.clamp_min(_fit_predict(
                    srate[ev, u], after[later[0]] * w, weight=w,
                    block=block), 0.0)
            rows[ev] = exercised + torch.where(stop > ev, alive, 0.0)
        add(t["notional"] * rows)
    out = {}
    if csa is not None:
        lag = int(csa["margin_lag"])
        v_lag = (torch.cat([torch.zeros_like(v_t[:lag]), v_t[:-lag]])
                 if lag else v_t)
        req = (torch.clamp_min(v_lag - csa["threshold"], 0.0)
               - torch.clamp_min(-v_lag - csa["threshold_own"], 0.0))
        held = torch.zeros_like(req)
        bal = torch.zeros_like(req[0])
        for ev in range(E):
            bal = torch.where(torch.abs(req[ev] - bal) >= csa["mta"],
                              req[ev], bal)
            held[ev] = bal
        resid = v_t - held - csa["independent_amount"]
        out["ee_gross"] = torch.clamp_min(v_disc, 0.0).mean(1)
        out["ene_gross"] = torch.clamp_max(v_disc, 0.0).mean(1)
    else:
        resid = v_t
    r_disc = resid * disc
    out["ee"] = torch.clamp_min(r_disc, 0.0).mean(1)
    out["ene"] = torch.clamp_max(r_disc, 0.0).mean(1)
    out["forward_value"] = v_disc.mean(1)
    out["ee_standalone"] = s_plus_disc.mean(1)
    qs = torch.as_tensor(quantiles, dtype=collect, device=z.device)
    out = {k: v.double().cpu().numpy() for k, v in out.items()}
    out["pfe"] = {q: np.asarray([float(torch.quantile(resid[ev], qs[i]))
                                 for ev in range(E)])
                  for i, q in enumerate(quantiles)}
    return out
