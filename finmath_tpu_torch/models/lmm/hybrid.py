"""Hybrid asset-LMM: equity and FX assets under stochastic LIBOR-market-model
rates, their netted exposure, and an autocallable discounted pathwise.

Counterpart of ``finmath_tpu.models.lmm.hybrid`` (finmath-lib's
``net.finmath.montecarlo.hybridassets``: an asset simulation whose drift
is pinned to the rate model's numeraire, so discounted assets are
martingales under the rate model's measure).

* **The rate sweep is the engine's.** The assets evolve in the
  ``step_hook`` of ``LMMValuationEngine._simulate_collect``, which runs
  after each step's accrual and evolution; every option of the engine
  (measures, state spaces, covariance models, injected increments,
  antithetic paths) composes unchanged.
* **The factor normals are the engine's increments**, read back as
  ``increments[s, :F] / sqrt(dt_s)`` (sqrt(dt) from the float64 grid).
  The idiosyncratic normals come from a second ``torch.Generator``,
  seeded apart from the engine's stream and drawn once at construction
  (``[S, K, paths]`` float32, ``[z, -z]`` halves when antithetic), or
  from the caller's ``equity_normals=`` block.
* **Exact discrete martingale in a float64 log carry.** Per step
  ``logS += log(N_new / N_old) + sigma dW - (sigma^2 / 2 + q) dt``, so
  E[S(T)/N(T)] = S0 e^{-qT} holds by construction at any correlation.

Asset i's Brownian: dW_i = rho_i . dW_factors + sqrt(1 - |rho_i|^2)
(C_eq dZ)_i, with ``rho_i`` the ``[F]`` rate-factor correlation row and
C_eq the Cholesky factor of the idiosyncratic asset-asset correlation.

FX and quanto: an FX rate is a domestic tradable paying the foreign
money-market rate as its dividend (pass the foreign discount curve as
its ``dividend_yields`` entry: E[FX(T)/N(T)] = FX0 df_foreign(T),
covered interest parity). A quanto underlying is not a domestic
tradable: its ``growth_curves`` entry replaces the numeraire growth by
the foreign accrual, and ``quanto_fx_indices`` names its FX asset, whose
drift correction -corr(S, FX) sigma_S sigma_FX dt uses the total
correlation (rate factors plus the idiosyncratic part).

Under a ``parallel.PathMesh`` (``mesh=``) each rank simulates its block of
the paths on streams of its own, as the meshed engine does: the rate
normals from ``rank_seed(seed, rank)`` and the idiosyncratic ones from a
second generator of that seed (the JAX hybrid folds the device index into
both keys). The means, standard errors and regressions reduce over the
ranks, the PFE sorts the gathered ensemble, and every public result is
the same on every rank.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ...ops.conditional_expectation import regression_fit
from ...ops.random_variable import ACC_DTYPE
from ...parallel.mesh import (check_mesh, gather_paths, path_mean,
                              path_means, rank_seed)
from .exposure import ExposureProfile, _linear_quantiles
from .model import LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct

__all__ = [
    "EquityForwardTrade",
    "EquityOptionTrade",
    "HybridAssetLMM",
    "HybridAutocallableNote",
    "HybridExposureEngine",
]


def _mean_and_error(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``[2]`` (mean, std / sqrt(n)) of ``[paths]``, the std over n; under
    a mesh over every rank's paths (the mean, then the mean squared
    deviation from it, each one all-reduce)."""
    if mesh is None:
        return torch.stack([torch.mean(x), torch.std(x, correction=0)
                            / math.sqrt(x.shape[0])])
    m = path_mean(x, mesh)
    var = path_mean((x - m) ** 2, mesh)
    return torch.stack([m, torch.sqrt(var)
                        / math.sqrt(x.shape[0] * mesh.world_size)])


def _floats(pair: torch.Tensor) -> tuple:
    a, b = pair.tolist()
    return float(a), float(b)


class HybridAssetLMM:
    """K equity assets jointly simulated with a LIBOR market model.

    ``rate_correlations``: [K] (correlation of each asset to rate factor
    0) or [K, F]; rows must have |rho| <= 1. ``equity_correlation``:
    [K, K] correlation of the idiosyncratic parts (default identity).
    ``observation_indices``: tenor indices where assets are observed
    (default: every index in [1, n-1]).

    ``dividend_yields``: per-asset continuous yield, a scalar or a
    curve (``get_discount_factor``) whose forward rates are paid out (an
    FX rate's foreign curve). ``growth_curves``: per asset ``None``
    (domestic tradable, grows at the numeraire rate) or a curve (quanto
    underlying, grows at that curve's forward rates).
    ``quanto_fx_indices``: per asset ``None`` or the index of the
    converting FX asset; needs a growth curve on the asset and a
    domestic-tradable FX asset.

    ``increments=``, ``antithetic=`` and ``seed=`` pass through to the
    engine; ``equity_normals``: an ``[S, K, paths]`` block (S at least the
    last observation's step) in place of the idiosyncratic draws.
    ``device`` defaults to ``select_device()``. ``mesh``: a
    ``parallel.PathMesh`` (module docstring); a meshed hybrid draws its
    own streams and refuses ``increments`` and ``equity_normals``, as the
    JAX one refuses ``increments``.

    ``simulate(params)`` -> ``(assets [E, K, paths], numeraires [E,
    paths])`` float64 tensors on the device (under a mesh every rank's
    paths, gathered in rank order)."""

    def __init__(self, model: LIBORMarketModelTorch,
                 equity_initial_values: Sequence[float],
                 equity_volatilities: Sequence[float],
                 rate_correlations=None,
                 equity_correlation=None,
                 dividend_yields=None,
                 growth_curves=None,
                 quanto_fx_indices=None,
                 observation_indices: Optional[Sequence[int]] = None,
                 num_paths: int = 50_000, num_factors: int = 1,
                 seed: int = 31415, antithetic: bool = False,
                 increments=None, mesh=None, path_axis: str = "paths", *,
                 device=None, equity_normals=None):
        mesh = check_mesh(mesh)
        if mesh is not None and (increments is not None
                                 or equity_normals is not None):
            raise NotImplementedError(
                "a meshed hybrid draws its own per-rank streams: injected "
                "increments and equity_normals are single-device only")
        s0 = np.asarray(equity_initial_values, dtype=np.float64)
        sig = np.asarray(equity_volatilities, dtype=np.float64)
        if s0.ndim != 1 or sig.shape != s0.shape:
            raise ValueError("need matching 1-d initial values/volatilities")
        if np.any(s0 <= 0.0) or np.any(sig < 0.0):
            raise ValueError("need positive spots and nonnegative vols")
        K = len(s0)
        F = int(num_factors)
        if rate_correlations is None:
            rho = np.zeros((K, F), dtype=np.float64)
        else:
            rho = np.asarray(rate_correlations, dtype=np.float64)
            if rho.ndim == 1:
                if rho.shape != (K,):
                    raise ValueError("1-d rate_correlations must be [K]")
                rho = np.concatenate(
                    [rho[:, None], np.zeros((K, F - 1))], axis=1)
            if rho.shape != (K, F):
                raise ValueError(f"rate_correlations must be [K]={K} or "
                                 f"[K, F]=[{K}, {F}]")
        rho_sq = np.sum(rho * rho, axis=1)
        if np.any(rho_sq > 1.0 + 1e-12):
            raise ValueError("each asset's |rate correlation| must be <= 1")
        if equity_correlation is None:
            chol = np.eye(K)
        else:
            ceq = np.asarray(equity_correlation, dtype=np.float64)
            if ceq.shape != (K, K):
                raise ValueError("equity_correlation must be [K, K]")
            try:
                chol = np.linalg.cholesky(ceq)
            except np.linalg.LinAlgError:
                raise ValueError("equity_correlation is not positive "
                                 "definite") from None
        if dividend_yields is None:
            dividend_yields = [0.0] * K
        if len(dividend_yields) != K:
            raise ValueError("dividend_yields must have one entry per asset")
        if growth_curves is None:
            growth_curves = [None] * K
        if len(growth_curves) != K:
            raise ValueError("growth_curves must have one entry per asset")
        if quanto_fx_indices is None:
            quanto_fx_indices = [None] * K
        if len(quanto_fx_indices) != K:
            raise ValueError("quanto_fx_indices must have one entry per "
                             "asset")
        for i, fx in enumerate(quanto_fx_indices):
            if fx is None:
                continue
            if not (0 <= int(fx) < K) or int(fx) == i:
                raise ValueError(f"asset {i}: quanto FX index {fx} invalid")
            if growth_curves[i] is None:
                raise ValueError(
                    f"asset {i}: a quanto underlying needs a growth curve "
                    "(it is not a domestic tradable)")
            if growth_curves[int(fx)] is not None:
                raise ValueError(
                    f"asset {i}: its FX asset {fx} must be a domestic "
                    "tradable (growth curve None)")

        n = model.num_libors
        if observation_indices is None:
            observation_indices = range(1, n)
        obs = sorted({int(e) for e in observation_indices})
        if not obs or obs[0] < 1 or obs[-1] > n - 1:
            raise ValueError(f"observation indices must lie in [1, {n - 1}]")
        self.observation_indices = obs
        self.model = model
        self.num_assets = K

        # event scaffolding: placeholder single-period products stop the
        # engine at exactly the observation dates; their payoffs are never
        # evaluated
        products = [SwaptionProduct(e, 1, 0.0, 0.0, value_unit="VALUE")
                    for e in obs]
        self.engine = LMMValuationEngine(
            model, products, num_paths, num_factors, seed=seed,
            device=device, increments=increments, antithetic=antithetic,
            mesh=mesh, path_axis=path_axis)
        eng = self.engine
        self.mesh = mesh
        self.device = dev = eng.device
        self._s0 = s0
        self._sig = sig
        self._rho = rho
        self._c_idio = np.sqrt(np.maximum(1.0 - rho_sq, 0.0))
        self._chol = chol

        sim = model.sim_times
        dts = np.asarray(sim[1:] - sim[:-1], dtype=np.float64)
        self._sqrt_dts = np.sqrt(dts)
        S = len(dts)

        def step_integral(curve):
            """[S] per-step integral of the curve's forward rate,
            log df(t_s) - log df(t_{s+1}), or scalar * dt."""
            if curve is None:
                return np.zeros(S)
            if np.isscalar(curve) or isinstance(curve, (int, float)):
                return float(curve) * dts
            df = np.asarray(curve.get_discount_factor(sim), dtype=np.float64)
            return np.log(df[:-1]) - np.log(df[1:])

        dq_table = np.stack([step_integral(q) for q in dividend_yields])
        carry_table = np.stack([step_integral(g) for g in growth_curves])
        num_mask = np.asarray([1.0 if g is None else 0.0
                               for g in growth_curves])
        # total Brownian correlation between assets: shared rate factors
        # plus the idiosyncratic block
        corr_total = (rho @ rho.T
                      + np.outer(self._c_idio, self._c_idio) * (chol @ chol.T))
        quanto_corr = np.zeros(K)
        for i, fx in enumerate(quanto_fx_indices):
            if fx is not None:
                fx = int(fx)
                quanto_corr[i] = -corr_total[i, fx] * sig[i] * sig[fx]
        # deterministic per-step log-drift: growth-curve accrual, minus
        # dividends, minus the Ito term, plus the quanto correction
        det_table = (carry_table - dq_table
                     + (quanto_corr - 0.5 * sig * sig)[:, None] * dts[None, :])
        self._dq_table = dq_table
        self._num_mask = num_mask
        tables = dict(rho=rho, c=self._c_idio, chol=chol, sig=sig,
                      det=det_table, mask=num_mask, logs0=np.log(s0),
                      deltas=model.deltas)
        self._t = {k: torch.as_tensor(v, dtype=ACC_DTYPE, device=dev)
                   for k, v in tables.items()}

        # the idiosyncratic normals, one block for every evaluation (this
        # rank's, from a second generator of its own seed, under a mesh)
        steps = eng.steps_needed
        paths = eng._local_paths
        if equity_normals is None:
            seed_r = (eng.seed if mesh is None
                      else rank_seed(eng.seed, mesh.rank))
            seq = np.random.SeedSequence((seed_r, 987654321))
            gen = torch.Generator(device=dev).manual_seed(
                int(seq.generate_state(1, np.uint32)[0]))
            if eng.antithetic:
                z = torch.randn((steps, K, paths // 2), generator=gen,
                                dtype=torch.float32, device=dev)
                z = torch.cat([z, -z], dim=2)
            else:
                z = torch.randn((steps, K, paths), generator=gen,
                                dtype=torch.float32, device=dev)
        else:
            z = torch.as_tensor(equity_normals, dtype=torch.float32)
            if (z.dim() != 3 or tuple(z.shape[1:]) != (K, paths)
                    or z.shape[0] < steps):
                raise ValueError(
                    f"equity_normals of shape {tuple(z.shape)}; need "
                    f"[steps >= {steps}, {K}, {paths}]")
            z = z[:steps].to(dev).contiguous()
        self.equity_normals = z

    # ------------------------------------------------------------------
    def _simulate(self, params, bond_maturities=()):
        """One simulation of this rank's paths: ``(assets [E, K, paths],
        numeraires [E, paths])`` and, with ``bond_maturities``, ``bonds [E,
        M, paths]`` float64."""
        eng, t = self.engine, self._t
        obs, K = self.observation_indices, self.num_assets
        F = eng.num_factors
        sqrt_dts = self._sqrt_dts
        logS = t["logs0"][:, None].expand(K, eng._local_paths)

        def hook(s, N_old, N_new, dw):
            nonlocal logS
            z_f = dw[:F].to(ACC_DTYPE) / sqrt_dts[s]           # [F, paths]
            z_e = self.equity_normals[s].to(ACC_DTYPE)         # [K, paths]
            dw_unit = t["rho"] @ z_f + t["c"][:, None] * (t["chol"] @ z_e)
            logS = (logS
                    + t["mask"][:, None] * torch.log(N_new / N_old)[None, :]
                    + t["det"][:, s][:, None]
                    + t["sig"][:, None] * dw_unit * sqrt_dts[s])

        def collect(e, j, L, N):
            out = [torch.exp(logS), N.to(ACC_DTYPE)]
            if bond_maturities:
                # P(T_e, T_m) from the live block (L[0] is forward e)
                row = []
                for m in bond_maturities:
                    if m <= e:
                        row.append(torch.ones_like(out[1]))
                    else:
                        acc = 1.0 + (t["deltas"][e:m, None]
                                     * L[:m - e].to(ACC_DTYPE))
                        row.append(torch.prod(1.0 / acc, dim=0))
                out.append(torch.stack(row))
            return out

        with torch.no_grad():
            outs = eng._simulate_collect(eng._params(params), collect,
                                         step_hook=hook)
        return tuple(torch.stack(col) for col in zip(*outs))

    def simulate(self, params):
        """(assets [E, K, paths], numeraires [E, paths]); observation e
        sees the state at tenor time T_{obs[e]}, before that date's
        accrual (the engine's collection convention)."""
        return tuple(gather_paths(a, self.mesh)
                     for a in self._simulate(params))

    def simulate_with_bonds(self, params, bond_maturity_indices):
        """Like :meth:`simulate` plus ``bonds [E, M, paths]``: the model
        zero bonds P(T_obs, T_m) for each requested tenor index m, from
        the live forwards at every observation (1.0 once matured)."""
        return tuple(gather_paths(a, self.mesh) for a in self._simulate(
            params, tuple(int(m) for m in bond_maturity_indices)))

    def dividend_discount_between(self, e_from: int, e_to: int) -> np.ndarray:
        """[K] exp(-integral of dividends) over [T_{e_from}, T_{e_to}]
        (both tenor indices; the step sums match the collection
        convention)."""
        sim = np.asarray([float(t) for t in self.model.sim_times])
        s0 = int(np.searchsorted(sim, self.model.tenor_times[e_from]))
        s1 = int(np.searchsorted(sim, self.model.tenor_times[e_to]))
        return np.exp(-np.sum(self._dq_table[:, s0:s1], axis=1))

    def _discount_adjustments(self, numeraires):
        """finmath's deterministic numeraire adjustment E[1/N] -> df per
        observation date (ones when the model disables it)."""
        obs_times = np.asarray(
            [self.model.tenor_times[e] for e in self.observation_indices])
        dfs = np.asarray(
            self.model.discount_curve.get_discount_factor(obs_times))
        inv_n = path_mean(1.0 / numeraires, self.mesh)         # [E]
        if self.model.use_numeraire_adjustment:
            return torch.as_tensor(dfs, device=inv_n.device) / inv_n
        return torch.ones_like(inv_n)

    def european_option_value(self, params, expiry_index: int, strike: float,
                              asset_index: int = 0, is_call: bool = True):
        """(value, standard error) of a European equity option under
        stochastic rates: N(0) E[(S - K)^+ / N(T)], with the model's
        numeraire adjustment."""
        ev = self.observation_indices.index(int(expiry_index))
        assets, numeraires = self._simulate(params)
        adj = self._discount_adjustments(numeraires)
        s_t = assets[ev, asset_index]
        if is_call:
            pay = torch.clamp_min(s_t - strike, 0.0)
        else:
            pay = torch.clamp_min(strike - s_t, 0.0)
        return _floats(_mean_and_error(pay / numeraires[ev] * adj[ev],
                                       self.mesh))

    def _dividend_discount(self, ev: int) -> np.ndarray:
        """[K] exp(-cumulative dividend) at observation ordinal ``ev``
        (the steps strictly before the event step)."""
        s_e = int(self.engine._event_steps[ev])
        return np.exp(-np.sum(self._dq_table[:, :s_e], axis=1))

    def forward_value(self, params, expiry_index: int, asset_index: int = 0):
        """Raw E[S(T)/N(T)]: the exact-martingale diagnostic of a domestic
        tradable, S0 df_dividend(T) by construction (FX0 df_foreign(T),
        covered interest parity, for an FX rate). No numeraire
        adjustment."""
        ev = self.observation_indices.index(int(expiry_index))
        assets, numeraires = self._simulate(params)
        return _floats(_mean_and_error(assets[ev, asset_index]
                                       / numeraires[ev], self.mesh))

    def martingale_errors(self, params) -> np.ndarray:
        """[E, K] relative deviations of E[S/N] from the exact target
        S0 df_dividend(T). Quanto (growth-curve) assets are NaN columns:
        S/N is not a martingale for them by design."""
        assets, numeraires = self._simulate(params)
        disc = path_mean(assets / numeraires[:, None, :],
                         self.mesh).cpu().numpy()              # [E, K]
        out = np.full_like(disc, np.nan)
        for ev in range(disc.shape[0]):
            target = self._s0 * self._dividend_discount(ev)
            row = disc[ev] / target - 1.0
            out[ev] = np.where(self._num_mask > 0, row, np.nan)
        return out


# ---------------------------------------------------------------------------
# exposure on the hybrid: equity and FX portfolios under stochastic rates
# ---------------------------------------------------------------------------

class EquityForwardTrade:
    """Forward on hybrid asset ``asset_index``: pays
    ``notional * (S(T_m) - strike)`` at tenor index ``maturity_index``.
    The close-out at an earlier observation T_e is exact in the simulated
    state, ``notional * (S_e df_div(T_e, T_m) - strike P(T_e, T_m))`` with
    the model bond from the live forwards. An FX forward is this trade on
    an FX asset."""

    def __init__(self, asset_index: int, maturity_index: int, strike: float,
                 notional: float = 1.0):
        self.asset_index = int(asset_index)
        self.maturity_index = int(maturity_index)
        self.strike = float(strike)
        self.notional = float(notional)


class EquityOptionTrade:
    """European option on a hybrid asset. Close-out values before expiry
    are Longstaff-Schwartz conditional expectations of the discounted
    payoff regressed on (1, s, ..., s^d, p, s p), s = S_e / strike and
    p = P(T_e, T_m); the constant in the basis preserves the mean, so the
    profile's ``forward_value`` stays a martingale diagnostic."""

    def __init__(self, asset_index: int, maturity_index: int, strike: float,
                 is_call: bool = True, notional: float = 1.0,
                 basis_degree: int = 2):
        if basis_degree < 1:
            raise ValueError("basis_degree must be >= 1")
        self.asset_index = int(asset_index)
        self.maturity_index = int(maturity_index)
        self.strike = float(strike)
        self.is_call = is_call
        self.notional = float(notional)
        self.basis_degree = int(basis_degree)


class HybridExposureEngine:
    """Netted EE/ENE/PFE profile of an equity/FX portfolio under
    stochastic rates, with wrong-way risk through the equity-rate
    correlation. Conventions of ``lmm/exposure.py``: ``ee``/``ene``
    discounted to today with the model's numeraire adjustment, ``pfe``
    quantiles of the undiscounted time-t netted value, ``forward_value``
    the martingale diagnostic E[V(t)/N(t)]."""

    def __init__(self, hybrid: HybridAssetLMM, trades,
                 quantiles=(0.95,)):
        trades = list(trades)
        if not trades:
            raise ValueError("need at least one trade")
        obs = hybrid.observation_indices
        for tr in trades:
            if not isinstance(tr, (EquityForwardTrade, EquityOptionTrade)):
                raise TypeError(f"unsupported trade {type(tr).__name__}")
            if tr.maturity_index not in obs:
                raise ValueError(
                    f"trade maturity index {tr.maturity_index} must be an "
                    "observation date of the hybrid")
            if not (0 <= tr.asset_index < hybrid.num_assets):
                raise ValueError(f"asset index {tr.asset_index} out of range")
            if hybrid._num_mask[tr.asset_index] == 0.0:
                raise ValueError(
                    "exposure trades must reference domestic tradables "
                    f"(asset {tr.asset_index} is a quanto underlying)")
        self.hybrid = hybrid
        self.trades = trades
        self.quantiles = tuple(float(q) for q in quantiles)
        self._maturities = tuple(sorted({tr.maturity_index
                                         for tr in trades}))
        self._qs = torch.as_tensor(self.quantiles, dtype=ACC_DTYPE,
                                   device=hybrid.device)

    def _profile_rows(self, params) -> torch.Tensor:
        """One simulation, every trade's pathwise close-out, netted and
        reduced to ``[4 + Q, E]``: EE, ENE, forward value, E[1/N] and the
        PFE quantiles, before the numeraire adjustment."""
        h = self.hybrid
        obs = h.observation_indices
        m_col = {m: j for j, m in enumerate(self._maturities)}
        assets, numeraires, bonds = h._simulate(params, self._maturities)
        netted = torch.zeros_like(numeraires)                  # [E, paths]
        for tr in self.trades:
            m_ev = obs.index(tr.maturity_index)
            a, col = tr.asset_index, m_col[tr.maturity_index]
            if isinstance(tr, EquityForwardTrade):
                for ev, e in enumerate(obs):
                    if e > tr.maturity_index:
                        continue  # settled
                    dq = float(h.dividend_discount_between(
                        e, tr.maturity_index)[a])
                    netted[ev] += tr.notional * (assets[ev, a] * dq
                                                 - tr.strike * bonds[ev, col])
                continue
            s_m = assets[m_ev, a]
            if tr.is_call:
                pay = torch.clamp_min(s_m - tr.strike, 0.0)
            else:
                pay = torch.clamp_min(tr.strike - s_m, 0.0)
            y = pay / numeraires[m_ev]                          # discounted
            netted[m_ev] += tr.notional * pay
            for ev, e in enumerate(obs):
                if e >= tr.maturity_index:
                    continue
                s_e = assets[ev, a] / tr.strike
                p_e = bonds[ev, col]
                X = torch.stack([torch.ones_like(s_e)]
                                + [s_e ** d for d in
                                   range(1, tr.basis_degree + 1)]
                                + [p_e, s_e * p_e])             # [B, paths]
                beta = regression_fit(X, y, mesh=h.mesh)
                cond = beta @ X.to(beta.dtype)
                netted[ev] += tr.notional * cond * numeraires[ev]
        disc = netted / numeraires
        stats = torch.stack(path_means([
            torch.clamp_min(disc, 0.0), torch.clamp_max(disc, 0.0), disc,
            1.0 / numeraires], h.mesh))                        # [4, E]
        return torch.cat([stats, _linear_quantiles(
            gather_paths(netted, h.mesh), self._qs)])

    def profile(self, params) -> ExposureProfile:
        """The dated profile: one simulation, one transfer to the host."""
        h = self.hybrid
        with torch.no_grad():
            packed = self._profile_rows(params).cpu().numpy()
        ee_raw, ene_raw, fv_raw, inv_n = packed[:4]
        times = np.asarray([h.model.tenor_times[e]
                            for e in h.observation_indices])
        if h.model.use_numeraire_adjustment:
            dfs = np.asarray(
                h.model.discount_curve.get_discount_factor(times))
            adj = dfs / inv_n
        else:
            adj = np.ones_like(inv_n)
        pfe = {q: packed[4 + j] for j, q in enumerate(self.quantiles)}
        return ExposureProfile(times=times, ee=adj * ee_raw,
                               ene=adj * ene_raw,
                               forward_value=adj * fv_raw, pfe=pfe)


class HybridAutocallableNote:
    """Autocallable certificate on a hybrid asset, discounted pathwise by
    the stochastic numeraire, so the note carries rate-vol and
    equity-rate-correlation risk. Payoff conventions of
    ``models.structured_products.AutocallableNote``, with dates given as
    tenor indices on the hybrid's observation grid and the model's
    deterministic numeraire adjustment applied per payment date."""

    def __init__(self, hybrid: HybridAssetLMM,
                 observation_indices: Sequence[int],
                 autocall_levels: Sequence[float],
                 coupons: Sequence[float],
                 protection_level: float,
                 coupon_levels: Optional[Sequence[float]] = None,
                 reference_level: Optional[float] = None,
                 memory: bool = False, notional: float = 1.0,
                 asset_index: int = 0):
        evs = [int(e) for e in observation_indices]
        if sorted(evs) != evs or len(evs) < 2:
            raise ValueError("need >= 2 ascending observation indices")
        missing = [e for e in evs if e not in hybrid.observation_indices]
        if missing:
            raise ValueError(
                f"indices {missing} are not hybrid observation dates")
        m = len(evs)
        ac = [float(x) for x in autocall_levels]
        cp = [float(x) for x in coupons]
        cl = ([float(x) for x in coupon_levels]
              if coupon_levels is not None else list(ac))
        if not (len(ac) == len(cp) == len(cl) == m):
            raise ValueError("schedule arrays must match the dates")
        if not (0 <= int(asset_index) < hybrid.num_assets):
            raise ValueError("asset index out of range")
        if hybrid._num_mask[int(asset_index)] == 0.0:
            raise ValueError("the underlying must be a domestic tradable")
        self.hybrid = hybrid
        self._ref = (float(reference_level) if reference_level is not None
                     else float(hybrid._s0[int(asset_index)]))
        times = np.asarray([hybrid.model.tenor_times[e] for e in evs])
        self._dfs = np.asarray(
            hybrid.model.discount_curve.get_discount_factor(times))
        row_of = {e: i for i, e in enumerate(hybrid.observation_indices)}
        self._rows = [row_of[e] for e in evs]
        self._ac, self._cp, self._cl = ac, cp, cl
        self._asset = int(asset_index)
        self._protection = float(protection_level)
        self._notional = float(notional)
        self._memory = bool(memory)

    def packed_value_and_error(self, params) -> torch.Tensor:
        """``[2]`` (value, standard error over n) float64 on the device."""
        mesh = self.hybrid.mesh
        assets, numeraires = self.hybrid._simulate(params)
        use_adj = self.hybrid.model.use_numeraire_adjustment
        ai, rows = self._asset, self._rows
        alive = torch.ones_like(numeraires[0])
        mem = torch.zeros_like(alive)
        acc = torch.zeros_like(alive)
        for i, r in enumerate(rows):
            s_i = assets[r, ai]
            n_i = numeraires[r]
            adj = (self._dfs[i] / path_mean(1.0 / n_i, mesh)) if use_adj \
                else 1.0
            coup_hit = (s_i >= self._cl[i]).to(ACC_DTYPE)
            pay_c = alive * coup_hit * (self._cp[i] + mem)
            if self._memory:
                mem = torch.where(coup_hit > 0.0, 0.0, mem + self._cp[i])
            if i < len(rows) - 1:
                call_hit = (s_i >= self._ac[i]).to(ACC_DTYPE)
                pay = pay_c + alive * call_hit
                alive = alive * (1.0 - call_hit)
            else:
                principal = torch.where(s_i >= self._protection, 1.0,
                                        s_i / self._ref)
                pay = pay_c + alive * principal
            acc = acc + adj * pay / n_i
        return _mean_and_error(acc * self._notional, mesh)

    def get_value_and_error(self, params) -> tuple:
        return _floats(self.packed_value_and_error(params))

    def get_value(self, params) -> float:
        return self.get_value_and_error(params)[0]

    getValue = get_value
