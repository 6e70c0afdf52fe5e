"""Market risk: VaR / expected shortfall on a derivatives book with FULL
revaluation per scenario on the device, Euler component allocation, and
the Kupiec backtest.

Counterpart of ``finmath_tpu.models.risk``. Three estimators share one
revaluation core:

* parametric Monte-Carlo scenarios from a factor covariance (log-normal
  shocks),
* historical simulation (a returns matrix applied to today's factors),
* delta-normal (no revaluation; the analytic control the full
  revaluation is tested against for small horizons).

The book is revalued for ALL scenarios at once: instruments are columns
(strike/expiry/vol/notional vectors), scenarios are rows, so the
[scenarios, instruments] revaluation is one float64 broadcast through the
vectorised Black-Scholes formula (``torch_norm_cdf``), and the
quantile/ES/allocation statistics are computed on the device from one
sort and packed into one host copy. The scenarios are float64, as the
JAX package draws them under ``jax_enable_x64``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..native.host_rng import inverse_normal_cdf_as241
from ..ops.random_variable import ACC_DTYPE
from ..parallel.mesh import check_mesh, gather_paths, mesh_device
from .analytic import torch_norm_cdf


@dataclass(frozen=True)
class RiskReport:
    """One horizon's risk numbers (losses positive).
    ``component_es`` is the Euler/Acerbi-Tasche allocation
    -E[pnl_i | portfolio in the q-tail]: it sums EXACTLY to the
    expected shortfall (the coherent allocation identity, tested)."""
    var: float
    expected_shortfall: float
    quantile: float
    horizon: float
    mean_pnl: float
    component_es: np.ndarray
    stderr_var: float             # asymptotic quantile stderr


def _check_quantile(q: float):
    if not 0.5 < q < 1.0:
        raise ValueError("quantile must be in (0.5, 1) — e.g. 0.99")


def value_at_risk(pnl, quantile: float = 0.99) -> float:
    """VaR_q = -q-quantile of the P&L distribution (loss positive).
    Host helper for externally produced P&L samples."""
    _check_quantile(quantile)
    return float(-np.quantile(np.asarray(pnl), 1.0 - quantile))


def expected_shortfall(pnl, quantile: float = 0.99) -> float:
    """ES_q = -E[pnl | pnl <= VaR threshold]."""
    _check_quantile(quantile)
    pnl = np.asarray(pnl)
    thr = np.quantile(pnl, 1.0 - quantile)
    tail = pnl[pnl <= thr]
    return float(-np.mean(tail))


def kupiec_pvalue(num_breaches: int, num_days: int,
                  quantile: float = 0.99) -> float:
    """Kupiec POF likelihood-ratio test of VaR coverage: p-value of
    LR = -2 ln[(1-p)^{n-x} p^x / ((1-x/n)^{n-x} (x/n)^x)] ~ chi2(1).
    Small p-value = reject the model's coverage."""
    _check_quantile(quantile)
    p = 1.0 - quantile
    x, n = int(num_breaches), int(num_days)
    if not 0 <= x <= n or n <= 0:
        raise ValueError("need 0 <= breaches <= days")
    if x == 0:
        lr = -2.0 * (n * math.log(1 - p))
    elif x == n:
        lr = -2.0 * (n * math.log(p))
    else:
        f = x / n
        lr = -2.0 * ((n - x) * math.log((1 - p) / (1 - f))
                     + x * math.log(p / f))
    # chi2(1) survival function via the normal tail
    return float(2.0 * (1.0 - 0.5 * (1.0 + math.erf(
        math.sqrt(max(lr, 0.0) / 2.0)))))


# ---------------------------------------------------------------------------
# the option book + revaluation core
# ---------------------------------------------------------------------------

class OptionBook:
    """European option positions on a set of underlyings: arrays over
    instruments — underlying index, strike, expiry, implied vol,
    notional (signed: negative = short), is_call. Underlyings carry
    spot and (flat) rate; vols shock multiplicatively with a per-
    underlying vol-factor scenario."""

    def __init__(self, spots: Sequence[float], rate: float,
                 underlying_index, strikes, expiries, vols, notionals,
                 is_call=True):
        s = np.asarray(spots, dtype=np.float64)
        if s.ndim != 1 or np.any(s <= 0):
            raise ValueError("spots must be positive")
        u = np.asarray(underlying_index, dtype=np.int64)
        k = np.asarray(strikes, dtype=np.float64)
        t = np.asarray(expiries, dtype=np.float64)
        v = np.asarray(vols, dtype=np.float64)
        w = np.asarray(notionals, dtype=np.float64)
        c = np.broadcast_to(np.asarray(is_call), k.shape).copy()
        if not (u.shape == k.shape == t.shape == v.shape == w.shape):
            raise ValueError("instrument arrays must align")
        if np.any((u < 0) | (u >= s.size)):
            raise ValueError("underlying_index out of range")
        if np.any(k <= 0) or np.any(t <= 0) or np.any(v <= 0):
            raise ValueError("strikes, expiries, vols must be positive")
        self.spots = s
        self.rate = float(rate)
        self.idx = u
        self.strikes = k
        self.expiries = t
        self.vols = v
        self.notionals = w
        self.is_call = c.astype(np.float64)   # 1 call, 0 put

    @property
    def num_underlyings(self) -> int:
        return self.spots.size

    @property
    def num_instruments(self) -> int:
        return self.strikes.size


def _book_values(spot_f, vol_f, spots, rate: float, idx, k, t, v, w, call):
    """Values [scenarios, instruments] (float64) of the book under
    multiplicative factor shocks: spot_f/vol_f [scenarios, underlyings]
    (1.0 = today). Expiries are NOT rolled down (instantaneous-shock
    convention)."""
    s = spots[idx][None, :] * spot_f[:, idx]              # [S, I]
    sig = v[None, :] * vol_f[:, idx]
    sq = sig * torch.sqrt(t)[None, :]
    f = s * torch.exp(rate * t)[None, :]
    d1 = (torch.log(f / k[None, :]) + 0.5 * sq * sq) / sq
    d2 = d1 - sq
    df = torch.exp(-rate * t)[None, :]
    callv = df * (f * torch_norm_cdf(d1) - k[None, :] * torch_norm_cdf(d2))
    putv = callv - df * (f - k[None, :])                  # parity
    vals = call[None, :] * callv + (1.0 - call[None, :]) * putv
    return (w[None, :] * vals).to(ACC_DTYPE)


def _risk_stats(pnl_by_inst, q: float) -> torch.Tensor:
    """Packed [4 + I] statistics from per-instrument P&L [S, I]:
    (VaR, ES, mean, stderr_var, component ES by Euler allocation =
    -E[pnl_i | portfolio tail]). The quantile is the sorted P&L at
    floor((1 - q) S), clipped to the sample."""
    pnl = torch.sum(pnl_by_inst, dim=1)                   # [S]
    s = pnl.shape[0]
    srt = torch.sort(pnl).values
    j = min(max(int(math.floor((1.0 - q) * s)), 0), s - 1)
    thr = srt[j]
    var = -thr
    in_tail = (pnl <= thr).to(ACC_DTYPE)
    ntail = torch.clamp_min(torch.sum(in_tail), 1.0)
    es = -torch.sum(pnl * in_tail) / ntail
    comp = -torch.sum(pnl_by_inst * in_tail[:, None], dim=0) / ntail
    # asymptotic quantile stderr: sqrt(q(1-q)/S) / f(x_q); 1/f estimated
    # by the central difference dx/dp of the empirical quantile function
    band = max(int(math.floor(0.002 * s)), 1)
    inv_dens = (srt[min(j + band, s - 1)]
                - srt[max(j - band, 0)]) / (2.0 * band / s)
    se = math.sqrt(q * (1.0 - q) / s) * torch.clamp_min(inv_dens, 0.0)
    return torch.cat([torch.stack([var, es, torch.mean(pnl), se]), comp])


class MarketRiskEngine:
    """VaR/ES by full revaluation of an ``OptionBook`` under factor
    scenarios — parametric MC (lognormal factor shocks from a
    covariance matrix) or historical (a returns matrix). Spot and vol
    factors per underlying: the factor vector is [spots..., vols...].
    ``device`` (``select_device()`` by default) holds the scenarios and
    the revaluation.

    ``mesh``: a ``parallel.PathMesh``; the scenario axis is the sharded
    axis. Every rank makes (or is given) the global scenarios, the
    unmeshed stream, revalues its block of them (a scenario count the
    world size does not divide raises ``ValueError``), and the tail
    statistics run on the gathered P&L, so VaR, ES, the component ES and
    the quantile's error are the unsharded ones on every rank."""

    def __init__(self, book: OptionBook, horizon: float = 1.0 / 252.0,
                 mesh=None, path_axis: str = "paths", *, device=None):
        if horizon <= 0:
            raise ValueError("horizon must be positive")
        self.book = book
        self.horizon = float(horizon)
        self.mesh = check_mesh(mesh)
        self.path_axis = path_axis
        self.device = mesh_device(self.mesh, device)
        b = book
        dev = self.device
        self._consts = (self._f64(b.spots), b.rate,
                        torch.as_tensor(b.idx).to(dev),
                        self._f64(b.strikes), self._f64(b.expiries),
                        self._f64(b.vols), self._f64(b.notionals),
                        self._f64(b.is_call))

    def _f64(self, values) -> torch.Tensor:
        return torch.as_tensor(np.array(values, dtype=np.float64)).to(
            self.device)

    # ------------------------------------------------------------------
    def _report(self, spot_f, vol_f, quantile: float) -> RiskReport:
        mesh = self.mesh
        if mesh is not None:
            # this rank's block of the scenarios [S, underlyings]
            rows = mesh.local_slice(spot_f.shape[0], "scenario count")
            spot_f, vol_f = spot_f[rows], vol_f[rows]
        ones = torch.ones((1, self.book.num_underlyings), dtype=ACC_DTYPE,
                          device=self.device)
        base = _book_values(ones, ones, *self._consts)    # [1, I]
        scen = _book_values(spot_f, vol_f, *self._consts)
        # the tail statistics need every scenario: the P&L [S, I] gathered
        # in rank order (the scenario order of the blocks)
        pnl = gather_paths((scen - base).T, mesh).T.contiguous()
        out = _risk_stats(pnl, float(quantile)).cpu().numpy()
        return RiskReport(var=float(out[0]), expected_shortfall=float(
            out[1]), quantile=float(quantile), horizon=self.horizon,
            mean_pnl=float(out[2]), component_es=out[4:],
            stderr_var=float(out[3]))

    def _scenarios(self, z, chol, diag):
        """exp(z @ chol^T - diag / 2 * horizon) on the device, float64."""
        return torch.exp(z @ self._f64(chol).T
                         - 0.5 * self._f64(diag) * self.horizon)

    def _normals(self, given, gen, half: int, n: int, what: str):
        """A ``[half, underlyings]`` float64 block: the caller's or drawn
        from ``gen``."""
        if given is None:
            return torch.randn((half, n), generator=gen, dtype=ACC_DTYPE,
                               device=self.device)
        z = torch.as_tensor(np.array(given, dtype=np.float64)
                            if not isinstance(given, torch.Tensor)
                            else given, dtype=ACC_DTYPE).to(self.device)
        if tuple(z.shape) != (half, n):
            raise ValueError(f"{what} of shape {tuple(z.shape)}; need "
                             f"[{half}, {n}]")
        return z

    def parametric_mc(self, covariance, num_scenarios: int = 500_000,
                      quantile: float = 0.99, seed: int = 99,
                      vol_covariance=None,
                      antithetic: bool = True, *,
                      normals=None) -> RiskReport:
        """Lognormal spot shocks from the annualized log-return
        ``covariance`` (scaled by the horizon); optional independent
        lognormal vol-factor shocks from ``vol_covariance``.

        The scenario normals: ``normals=(z, zv)``, each ``[half,
        underlyings]`` float64 (``half = num_scenarios / 2`` when
        antithetic; ``zv`` only with ``vol_covariance``, else None), the
        JAX draws; or drawn from ``torch.Generator(device)
        .manual_seed(seed)``. Mirrored ``[z, -z]`` along the scenario
        axis."""
        _check_quantile(quantile)
        n = self.book.num_underlyings
        cov = np.atleast_2d(np.asarray(covariance, dtype=np.float64))
        if cov.shape != (n, n):
            raise ValueError("covariance must be [underlyings]^2")
        chol = np.linalg.cholesky(cov * self.horizon
                                  + 1e-18 * np.eye(n))
        half = num_scenarios // 2 if antithetic else num_scenarios
        z_given, zv_given = (None, None) if normals is None else normals
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def mirrored(z):
            return torch.cat([z, -z], dim=0) if antithetic else z

        z = mirrored(self._normals(z_given, gen, half, n, "normals z"))
        spot_f = self._scenarios(z, chol, np.diag(cov))
        if vol_covariance is not None:
            vcov = np.atleast_2d(np.asarray(vol_covariance,
                                            dtype=np.float64))
            vchol = np.linalg.cholesky(vcov * self.horizon
                                       + 1e-18 * np.eye(n))
            zv = mirrored(self._normals(zv_given, gen, half, n,
                                        "normals zv"))
            vol_f = self._scenarios(zv, vchol, np.diag(vcov))
        else:
            vol_f = torch.ones_like(spot_f)
        return self._report(spot_f, vol_f, quantile)

    def historical(self, spot_returns, vol_returns=None,
                   quantile: float = 0.99) -> RiskReport:
        """Historical simulation: ``spot_returns`` [days, underlyings]
        log-returns applied as factor shocks (each day = one
        scenario)."""
        _check_quantile(quantile)
        r = np.atleast_2d(np.asarray(spot_returns, dtype=np.float64))
        if r.shape[1] != self.book.num_underlyings:
            raise ValueError("returns must be [days, underlyings]")
        spot_f = torch.exp(self._f64(r))
        if vol_returns is not None:
            v = np.atleast_2d(np.asarray(vol_returns, dtype=np.float64))
            if v.shape != r.shape:
                raise ValueError("vol_returns must match spot_returns")
            vol_f = torch.exp(self._f64(v))
        else:
            vol_f = torch.ones_like(spot_f)
        return self._report(spot_f, vol_f, quantile)

    # ------------------------------------------------------------------
    def delta_normal_var(self, covariance, quantile: float = 0.99,
                         eps: float = 1e-5) -> float:
        """Analytic delta-normal VaR (first-order control): deltas by
        central differences of the SAME revaluation core, then
        VaR = z_q sqrt(d' Sigma d) over the horizon."""
        _check_quantile(quantile)
        n = self.book.num_underlyings
        cov = np.atleast_2d(np.asarray(covariance, dtype=np.float64))
        ones = np.ones((1, n))
        deltas = np.zeros(n)
        vol_ones = self._f64(ones)
        for i in range(n):
            up, dn = ones.copy(), ones.copy()
            up[0, i] += eps
            dn[0, i] -= eps
            vu = float(torch.sum(_book_values(self._f64(up), vol_ones,
                                              *self._consts)))
            vd = float(torch.sum(_book_values(self._f64(dn), vol_ones,
                                              *self._consts)))
            deltas[i] = (vu - vd) / (2 * eps)     # dV / d(log-factor)
        sigma = math.sqrt(float(deltas @ (cov * self.horizon) @ deltas))
        z = float(inverse_normal_cdf_as241(np.array([quantile]))[0])
        return z * sigma
