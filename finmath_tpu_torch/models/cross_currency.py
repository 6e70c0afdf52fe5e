"""Cross-currency model: two Hull-White economies and a lognormal FX rate,
simulated exactly under the domestic risk-neutral measure, with the
closed-form stochastic-rates FX option as oracle.

Counterpart of ``finmath_tpu.models.cross_currency`` (finmath-lib's
cross-currency usage of its hybrid-assets package; Brigo-Mercurio ch. 14):

  dx_d = -a_d x_d dt + sigma_d dW_d
  dx_f = (-a_f x_f - rho_fx sigma_f sigma_x) dt + sigma_f dW_f
  dX/X = (r_d - r_f) dt + sigma_x dW_x

* The per-step shocks of (x_d, Y_d, x_f, Y_f, Z_x), both OU shocks, both
  integrated-OU shocks and the FX log's Brownian part, are Gaussian with a
  closed-form covariance; its Cholesky factor and the decay pairs are
  formed on the host in float64 (``[steps, 5, 6]``) and rounded to float32
  on the device. The simulation is a float32 step loop of a ``[5, 5] @
  [5, paths]`` product (TF32 off) and five state updates, exact in
  distribution at any step size.
* The foreign measure change enters as the exact host float64 shifts m(t)
  = E^d[x_f(t)] and M(t) = int_0^t m; the FX spot recomposes at a date from
  the simulated integrated rates: ln X(t) = ln X0 + (Y_d + A_d) - (Y_f + M
  + A_f) - 1/2 int sigma_x^2 + Z_x.
* Each Monte-Carlo pricer is one float64 function over the history with
  one packed transfer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..parallel.mesh import (check_mesh, gather_paths, mesh_device,
                             path_block, path_means)
from .analytic import _norm_cdf
from .hull_white import HullWhiteModel, _b, _f64, _injected, _normal_block
from .lmm.exposure import ExposureProfile, _linear_quantiles, cva_from_profile
from .time_discretization import TimeDiscretization


# ---------------------------------------------------------------------------
# closed-form step moments (host float64)
# ---------------------------------------------------------------------------

def _int_e(a: float, dt: float) -> float:
    """int_0^dt e^{-a u} du = B_a(dt)."""
    return float(_b(a, dt))


def _int_ee(a1: float, a2: float, dt: float) -> float:
    """int_0^dt e^{-(a1+a2) u} du."""
    return float(_b(a1 + a2, dt))


def _int_b(a: float, dt: float) -> float:
    """int_0^dt B_a(u) du = (dt - B_a(dt)) / a."""
    return (dt - float(_b(a, dt))) / a


def _int_eb(a1: float, a2: float, dt: float) -> float:
    """int_0^dt e^{-a1 u} B_{a2}(u) du = (B_{a1}(dt) - B_{a1+a2}(dt))/a2."""
    return (float(_b(a1, dt)) - float(_b(a1 + a2, dt))) / a2


def _int_bb(a1: float, a2: float, dt: float) -> float:
    """int_0^dt B_{a1}(u) B_{a2}(u) du."""
    return (dt - float(_b(a1, dt)) - float(_b(a2, dt))
            + float(_b(a1 + a2, dt))) / (a1 * a2)


def _step_cov5(a_d: float, a_f: float, s_d: float, s_f: float, s_x: float,
               rho_df: float, rho_dx: float, rho_fx: float,
               dt: float) -> np.ndarray:
    """Covariance of (eps_d, eta_d, eps_f, eta_f, zeta) over one step:
    eps_i = s_i int e^{-a_i(dt-s)} dW_i, eta_i = s_i int B_i(dt-s) dW_i,
    zeta = s_x int dW_x, every entry an elementary integral above."""
    c = np.zeros((5, 5))
    # within-economy blocks (hull_white._step_cov's)
    for k, (a, s) in enumerate(((a_d, s_d), (a_f, s_f))):
        i = 2 * k
        c[i, i] = s * s * _int_ee(a, a, dt)
        c[i + 1, i + 1] = s * s * _int_bb(a, a, dt)
        c[i, i + 1] = c[i + 1, i] = s * s * _int_eb(a, a, dt)
    # domestic-foreign cross block
    sdf = rho_df * s_d * s_f
    c[0, 2] = c[2, 0] = sdf * _int_ee(a_d, a_f, dt)
    c[0, 3] = c[3, 0] = sdf * _int_eb(a_d, a_f, dt)
    c[1, 2] = c[2, 1] = sdf * _int_eb(a_f, a_d, dt)
    c[1, 3] = c[3, 1] = sdf * _int_bb(a_d, a_f, dt)
    # FX column
    c[4, 4] = s_x * s_x * dt
    c[0, 4] = c[4, 0] = rho_dx * s_d * s_x * _int_e(a_d, dt)
    c[1, 4] = c[4, 1] = rho_dx * s_d * s_x * _int_b(a_d, dt)
    c[2, 4] = c[4, 2] = rho_fx * s_f * s_x * _int_e(a_f, dt)
    c[3, 4] = c[4, 3] = rho_fx * s_f * s_x * _int_b(a_f, dt)
    return c


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class CrossCurrencyModel:
    """Two Hull-White economies and a lognormal FX rate under the domestic
    risk-neutral measure. ``fx_vol`` may be piecewise-constant on
    ``fx_vol_times`` (Hull-White's volatility convention); the correlations
    are the instantaneous Brownian correlations of (d, f, x)."""

    def __init__(self, domestic: HullWhiteModel, foreign: HullWhiteModel,
                 fx_spot: float, fx_vol, rho_df: float, rho_dx: float,
                 rho_fx: float, fx_vol_times=None):
        if fx_spot <= 0:
            raise ValueError("fx_spot must be positive")
        corr = np.array([[1.0, rho_df, rho_dx],
                         [rho_df, 1.0, rho_fx],
                         [rho_dx, rho_fx, 1.0]])
        if np.min(np.linalg.eigvalsh(corr)) < -1e-12:
            raise ValueError("correlation matrix (d, f, x) is not PSD")
        sig = np.atleast_1d(np.asarray(fx_vol, dtype=np.float64))
        if np.any(sig <= 0):
            raise ValueError("fx_vol must be positive")
        if fx_vol_times is None:
            if sig.size != 1:
                raise ValueError("fx_vol_times required for piecewise vol")
            fx_vol_times = [0.0]
        vt = np.asarray(fx_vol_times, dtype=np.float64)
        if vt.size != sig.size or vt[0] != 0.0 or np.any(np.diff(vt) <= 0):
            raise ValueError("fx_vol_times must start at 0, increase, and "
                             "align with fx_vol")
        self.domestic = domestic
        self.foreign = foreign
        self.fx_spot = float(fx_spot)
        self.fx_vols = sig
        self.fx_vol_times = vt
        self.rho_df = float(rho_df)
        self.rho_dx = float(rho_dx)
        self.rho_fx = float(rho_fx)

    def fx_vol_at(self, t: float) -> float:
        i = int(np.searchsorted(self.fx_vol_times, t, side="right") - 1)
        return float(self.fx_vols[max(i, 0)])

    def _breakpoints(self) -> np.ndarray:
        return np.unique(np.concatenate([
            self.domestic.vol_times, self.foreign.vol_times,
            self.fx_vol_times]))

    def fx_forward(self, t) -> np.ndarray:
        """F(0, t) = X0 P_f(0,t) / P_d(0,t)."""
        return (self.fx_spot * self.foreign.df(t) / self.domestic.df(t))

    def fx_forward_variance(self, expiry: float) -> float:
        """Integrated lognormal variance of F(t, T) at t = T:
        v^2 = int_0^T |sigma_x e_x + sigma_d B_d(T-s) e_d
        - sigma_f B_f(T-s) e_f|^2 ds, by 32-node Gauss-Legendre on each
        segment between the union of the volatility breakpoints."""
        if expiry <= 0:
            raise ValueError("expiry must be positive")
        a_d, a_f = self.domestic.a, self.foreign.a
        nodes, weights = np.polynomial.legendre.leggauss(32)
        bps = self._breakpoints()
        seg = np.unique(np.concatenate([[0.0, expiry],
                                        bps[bps < expiry]]))
        total = 0.0
        for s0, s1 in zip(seg[:-1], seg[1:]):
            s = 0.5 * (s1 - s0) * nodes + 0.5 * (s0 + s1)
            w = 0.5 * (s1 - s0) * weights
            sd = np.array([self.domestic.sigma_at(u) for u in s])
            sf = np.array([self.foreign.sigma_at(u) for u in s])
            sx = np.array([self.fx_vol_at(u) for u in s])
            bd = _b(a_d, expiry - s)
            bf = _b(a_f, expiry - s)
            integrand = (sx * sx + sd * sd * bd * bd + sf * sf * bf * bf
                         + 2.0 * self.rho_dx * sd * sx * bd
                         - 2.0 * self.rho_fx * sf * sx * bf
                         - 2.0 * self.rho_df * sd * sf * bd * bf)
            total += float(np.sum(w * integrand))
        return total

    def fx_option(self, expiry: float, strike: float,
                  is_call: bool = True) -> float:
        """European FX option under both stochastic rates: Black-76 on the
        lognormal FX forward with the integrated variance above."""
        f = float(self.fx_forward(expiry))
        v2 = self.fx_forward_variance(expiry)
        df = float(self.domestic.df(expiry))
        sp = math.sqrt(max(v2, 0.0))
        if sp < 1e-14:
            intrinsic = (f - strike) if is_call else (strike - f)
            return df * max(intrinsic, 0.0)
        d1 = (math.log(f / strike) + 0.5 * v2) / sp
        d2 = d1 - sp
        if is_call:
            return df * (f * _norm_cdf(d1) - strike * _norm_cdf(d2))
        return df * (strike * _norm_cdf(-d2) - f * _norm_cdf(-d1))


# ---------------------------------------------------------------------------
# exact joint simulation
# ---------------------------------------------------------------------------

def _xccy_paths(z: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The exact joint transition, step by step in float32. ``z``: ``[steps,
    5, paths]`` normals; ``table``: ``[steps, 5, 6]`` float32, the step's
    lower Cholesky factor with the decays e^{-a dt} (rows 0, 2) and B(dt)
    (rows 1, 3) in the last column. Per step ``shocks = low @ z``, then
    ``Y_d += x_d B_d + shocks[1]``, ``x_d = x_d e_d + shocks[0]``, the
    foreign pair alike and ``Z_x += shocks[4]``. Returns the history
    ``[steps + 1, 5, paths]`` of (x_d, Y_d, x_f, Y_f, Z_x)."""
    steps, _, paths = z.shape
    hist = torch.zeros((steps + 1, 5, paths), dtype=FLOAT_DTYPE,
                       device=z.device)
    x_d, y_d, x_f, y_f, z_x = hist[0]
    for s in range(steps):
        mat = table[s]
        shocks = torch.matmul(mat[:, :5], z[s])               # [5, paths]
        y_d = y_d + x_d * mat[1, 5] + shocks[1]
        x_d = x_d * mat[0, 5] + shocks[0]
        y_f = y_f + x_f * mat[3, 5] + shocks[3]
        x_f = x_f * mat[2, 5] + shocks[2]
        z_x = z_x + shocks[4]
        hist[s + 1] = torch.stack([x_d, y_d, x_f, y_f, z_x])
    return hist


def _xccy_diag_core(h, lnx_det, a_int_d, lead_d, bb_d, lead_f, bb_f,
                    mesh=None):
    """Martingale diagnostics at one date ``h`` ``[5, paths]``, packed:
    [E[1/N_d], E[X/N_d], E[X P_f(t,T)/N_d], E[P_d(t,T)/N_d]] (float64).
    The cores below take ``mesh``: the paths are then this rank's block
    and the means are all-reduced, one all-reduce a core."""
    x_d, y_d, x_f, y_f, z_x = h.to(ACC_DTYPE)
    inv_n = torch.exp(-y_d - a_int_d)
    x_spot = torch.exp(lnx_det + (y_d + a_int_d) + z_x - y_f)
    p_f = lead_f * torch.exp(-bb_f * x_f)
    p_d = lead_d * torch.exp(-bb_d * x_d)
    return torch.stack(path_means([inv_n, x_spot * inv_n,
                                   x_spot * p_f * inv_n, p_d * inv_n], mesh))


def _xccy_fx_option_core(h, lnx_det, a_int_d, strikes, signs, mesh=None):
    """FX option prices and standard errors at one expiry for a strike
    vector, with E[X/N_d], packed ``[1 + 2K]`` (float64)."""
    y_d, y_f, z_x = h[[1, 3, 4]].to(ACC_DTYPE)
    inv_n = torch.exp(-y_d - a_int_d)
    x_spot = torch.exp(lnx_det + (y_d + a_int_d) + z_x - y_f)
    pay = torch.clamp_min(signs[:, None] * (x_spot[None, :]
                                            - strikes[:, None]), 0.0) \
        * inv_n[None, :]
    fwd, prices, second = path_means([x_spot * inv_n, pay, pay * pay], mesh)
    n = pay.shape[1] * (1 if mesh is None else mesh.world_size)
    stderr = torch.sqrt(torch.clamp_min(second - prices * prices, 0.0) / n)
    return torch.cat([fwd[None], prices, stderr])


def _xccy_ccs_core(h_prev, h_pay, lnx_det_pay, a_int_d_pay, lead_d, bb_d,
                   lead_f, bb_f, m_prev, mesh=None):
    """Both float legs of a cross-currency swap. ``h_prev``, ``h_pay``: ``[J,
    5, paths]`` states at the fixing and payment dates. Coupon j pays
    (1/P(t_{j-1}, t_j) - 1) of its currency at t_j, the foreign one
    converted at X(t_j); final notionals appended. Returns [domestic_leg,
    foreign_leg] (float64, domestic currency)."""
    y_pay = h_pay[:, 1].to(ACC_DTYPE) + a_int_d_pay[:, None]
    inv_n = torch.exp(-y_pay)                                  # [J, paths]
    x_d = h_prev[:, 0].to(ACC_DTYPE)
    inv_pd = torch.exp(bb_d[:, None] * x_d) / lead_d[:, None]
    x_f = h_prev[:, 2].to(ACC_DTYPE) + m_prev[:, None]
    inv_pf = torch.exp(bb_f[:, None] * x_f) / lead_f[:, None]
    x_spot = torch.exp(lnx_det_pay[:, None] + y_pay
                       + h_pay[:, 4].to(ACC_DTYPE)
                       - h_pay[:, 3].to(ACC_DTYPE))
    dom, fgn, dom_end, fgn_end = path_means(
        [(inv_pd - 1.0) * inv_n, x_spot * (inv_pf - 1.0) * inv_n, inv_n[-1],
         x_spot[-1] * inv_n[-1]], mesh)
    dom_leg = torch.sum(dom) + dom_end
    fgn_leg = torch.sum(fgn) + fgn_end
    return torch.stack([dom_leg, fgn_leg])


class CrossCurrencySimulation:
    """Exact Monte-Carlo simulation of the cross-currency model on a time
    grid: pathwise FX spot, domestic and foreign bonds and the exact
    domestic bank-account numeraire as ``RandomVariableTorch``, with
    Monte-Carlo pricers.

    The normals: one ``[steps, 5, num_paths / 2]`` float32 block from
    ``torch.Generator(device).manual_seed(seed)`` (``num_paths`` without
    ``antithetic``), mirrored ``[z, -z]`` along the path axis when
    antithetic; or the caller's ``normals=`` ``[steps, 5, num_paths]``.
    ``device`` defaults to ``select_device()``.

    ``mesh``: a ``parallel.PathMesh``. Every rank draws (or is given) the
    global block above, the unmeshed stream, and keeps its block of the
    paths (``num_paths`` divisible by the world size); the history is the
    block's, the variables carry the mesh, and the pricers and the
    exposure engine reduce over the ranks (its PFE sorts the gathered
    values). Every rank returns the same results."""

    def __init__(self, model: CrossCurrencyModel,
                 time_discretization: TimeDiscretization, num_paths: int,
                 seed: int = 1618, antithetic: bool = False,
                 mesh=None, path_axis: str = "paths", *, device=None,
                 normals=None):
        self.mesh = check_mesh(mesh)
        self.path_axis = path_axis
        if antithetic and num_paths % 2:
            raise ValueError("antithetic needs an even num_paths")
        if self.mesh is not None:
            self.mesh.local_count(num_paths)
        self.model = model
        self.td = time_discretization
        self.num_paths = int(num_paths)
        self.seed = int(seed)
        self.antithetic = bool(antithetic)
        self.device = mesh_device(self.mesh, device)
        times = time_discretization.as_array()
        if times[0] != 0.0:
            raise ValueError("simulation grid must start at 0")
        for bt in model._breakpoints()[1:]:
            if bt < times[-1] and time_discretization.get_time_index(bt) < 0:
                raise ValueError(
                    f"volatility breakpoint {bt} not on the time grid")
        self._times = times
        dts = np.diff(times)
        a_d, a_f = model.domestic.a, model.foreign.a

        # per-step Cholesky factors and decays (host float64), and the
        # exact deterministic quanto shift recursion:
        #   m' = m e^{-a_f dt} - rho_fx s_f s_x B_f(dt)
        #   M' = M + m B_f(dt) - rho_fx s_f s_x (dt - B_f(dt)) / a_f
        packed = np.zeros((dts.size, 5, 6))
        m = 0.0
        m_hist = np.zeros(times.size)
        big_m = np.zeros(times.size)
        for i, (t, dt) in enumerate(zip(times[:-1], dts)):
            s_d = model.domestic.sigma_at(t)
            s_f = model.foreign.sigma_at(t)
            s_x = model.fx_vol_at(t)
            cov = _step_cov5(a_d, a_f, s_d, s_f, s_x, model.rho_df,
                             model.rho_dx, model.rho_fx, float(dt))
            # a tiny ridge guards the |rho| = 1 corners
            low = np.linalg.cholesky(cov + 1e-30 * np.eye(5))
            packed[i, :, :5] = low
            packed[i, 0, 5] = math.exp(-a_d * dt)
            packed[i, 2, 5] = math.exp(-a_f * dt)
            packed[i, 1, 5] = _int_e(a_d, dt)
            packed[i, 3, 5] = _int_e(a_f, dt)
            drift = model.rho_fx * s_f * s_x
            big_m[i + 1] = (big_m[i] + m * _int_e(a_f, dt)
                            - drift * _int_b(a_f, dt))
            m = m * math.exp(-a_f * dt) - drift * _int_e(a_f, dt)
            m_hist[i + 1] = m
        self._m, self._big_m = m_hist, big_m
        dev, shape = self.device, (dts.size, 5, self.num_paths)
        if normals is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            z = _normal_block(gen, shape, self.antithetic, dev)
        else:
            z = _injected(normals, shape, dev, "normals")
        self._hist = _xccy_paths(path_block(z, self.mesh), torch.as_tensor(
            packed.astype(np.float32), device=dev))

        st_d = np.array([model.domestic.gaussian_state(t) for t in times])
        st_f = np.array([model.foreign.gaussian_state(t) for t in times])
        self._phi_d, self._c_d, v_d = st_d[:, 0], st_d[:, 1], st_d[:, 2]
        self._phi_f, self._c_f, v_f = st_f[:, 0], st_f[:, 1], st_f[:, 2]
        self._a_int_d = -np.log(model.domestic.df(times)) + 0.5 * v_d
        self._a_int_f = -np.log(model.foreign.df(times)) + 0.5 * v_f
        # int_0^t sigma_x^2 (piecewise-exact)
        sx2 = np.array([model.fx_vol_at(t) ** 2 for t in times[:-1]])
        self._vx_int = np.concatenate([[0.0], np.cumsum(sx2 * dts)])
        # the deterministic part of ln X(t): all but the pathwise
        # (Y_d + A_d) - Y_f + Z_x (A_f and M fold in here)
        self._lnx_det = (math.log(model.fx_spot) - self._a_int_f
                         - self._big_m - 0.5 * self._vx_int)

    # ------------------------------------------------------------------
    def _index(self, time: float) -> int:
        ti = self.td.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return ti

    def _lnx(self, i: int) -> torch.Tensor:
        h = self._hist[i]
        return (float(self._lnx_det[i])
                + (h[1].to(ACC_DTYPE) + float(self._a_int_d[i]))
                + h[4].to(ACC_DTYPE) - h[3].to(ACC_DTYPE))

    def fx(self, time: float) -> RandomVariableTorch:
        """Pathwise FX spot X(t)."""
        i = self._index(time)
        return RandomVariableTorch.of(
            self._times[i], torch.exp(self._lnx(i)).to(FLOAT_DTYPE),
            mesh=self.mesh)

    def numeraire(self, time: float) -> RandomVariableTorch:
        """Domestic bank account N_d(t) (exact in distribution)."""
        i = self._index(time)
        return RandomVariableTorch.of(
            self._times[i],
            torch.exp(self._hist[i][1].to(ACC_DTYPE)
                      + float(self._a_int_d[i])).to(FLOAT_DTYPE),
            mesh=self.mesh)

    def _bond_coeffs(self, leg: str, i: int, maturity: float):
        model = self.model.domestic if leg == "d" else self.model.foreign
        phi = self._phi_d if leg == "d" else self._phi_f
        c = self._c_d if leg == "d" else self._c_f
        t = self._times[i]
        if maturity < t:
            raise ValueError("maturity before observation time")
        bb = float(_b(model.a, maturity - t))
        lead = float(model.df(maturity) / model.df(t)
                     * math.exp(-0.5 * bb * bb * phi[i] - bb * c[i]))
        return lead, bb

    def _state(self, leg: str, i: int) -> torch.Tensor:
        """x_d, or x_f with its quanto mean shift m(t), in float64."""
        if leg == "d":
            return self._hist[i][0].to(ACC_DTYPE)
        return self._hist[i][2].to(ACC_DTYPE) + float(self._m[i])

    def bond(self, time: float, maturity: float,
             foreign: bool = False) -> RandomVariableTorch:
        """P_d(t,T) or P_f(t,T) by affine reconstitution; the foreign state
        enters with its quanto mean shift m(t)."""
        i = self._index(time)
        leg = "f" if foreign else "d"
        lead, bb = self._bond_coeffs(leg, i, maturity)
        return RandomVariableTorch.of(
            self._times[i],
            (lead * torch.exp(-bb * self._state(leg, i))).to(FLOAT_DTYPE),
            mesh=self.mesh)

    def get_number_of_paths(self) -> int:
        return self.num_paths

    # ------------------------------------------------------------------
    def martingale_diagnostics(self, time: float, maturity: float):
        """Exact-martingale checks at ``time``, one transfer: a dict of
        (Monte Carlo, exact) for E[1/N_d] against P_d(0,t), the FX forward
        E[X/N_d] against X0 P_f(0,t), covered interest parity E[X
        P_f(t,T)/N_d] against X0 P_f(0,T), and E[P_d(t,T)/N_d] against
        P_d(0,T)."""
        i = self._index(time)
        lead_d, bb_d = self._bond_coeffs("d", i, maturity)
        lead_f, bb_f = self._bond_coeffs("f", i, maturity)
        # fold the foreign mean shift into the lead (exp(-bb (x + m)))
        lead_f_shift = lead_f * math.exp(-bb_f * self._m[i])
        out = _xccy_diag_core(
            self._hist[i], float(self._lnx_det[i]), float(self._a_int_d[i]),
            lead_d, bb_d, lead_f_shift, bb_f, self.mesh).cpu().numpy()
        model = self.model
        return {
            "bond": (out[0], float(model.domestic.df(time))),
            "fx_forward": (out[1],
                           model.fx_spot * float(model.foreign.df(time))),
            "covered_parity": (out[2], model.fx_spot
                               * float(model.foreign.df(maturity))),
            "domestic_parity": (out[3],
                                float(model.domestic.df(maturity))),
        }

    def mc_fx_option_prices(self, expiry: float, strikes,
                            is_call: bool = True):
        """(forward, prices[K], stderr[K]) for a strike vector at one
        expiry, one packed transfer. The forward is E[X/N_d] / P_d(0, T);
        the oracle is ``CrossCurrencyModel.fx_option``."""
        i = self._index(expiry)
        ks = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
        sign = 1.0 if is_call else -1.0
        out = _xccy_fx_option_core(
            self._hist[i], float(self._lnx_det[i]), float(self._a_int_d[i]),
            _f64(ks, self.device),
            _f64(np.full(ks.shape, sign), self.device),
            self.mesh).cpu().numpy()
        k = ks.size
        fwd = float(out[0]) / float(self.model.domestic.df(expiry))
        return fwd, out[1:1 + k], out[1 + k:]

    def mc_ccs_legs(self, payment_times: Sequence[float]):
        """(domestic_leg, foreign_leg) of a float-float cross-currency swap
        per unit of each currency's notional, both in domestic currency at
        t = 0: floating coupons at each payment date plus the final
        notional, priced pathwise (bonds reconstituted at the fixing, FX
        conversion at the payment, exact numeraire). Both legs are par in
        the model: domestic_leg = 1, foreign_leg = X0."""
        pt = np.asarray(payment_times, dtype=np.float64)
        if pt.ndim != 1 or pt.size < 1 or pt[0] <= 0 \
                or np.any(np.diff(pt) <= 0):
            raise ValueError("payment_times must be positive, increasing")
        grid = np.concatenate([[0.0], pt])
        i_prev = np.array([self._index(t) for t in grid[:-1]])
        i_pay = np.array([self._index(t) for t in grid[1:]])
        J = pt.size
        lead_d = np.zeros(J)
        bb_d = np.zeros(J)
        lead_f = np.zeros(J)
        bb_f = np.zeros(J)
        for j in range(J):
            lead_d[j], bb_d[j] = self._bond_coeffs("d", i_prev[j],
                                                   grid[j + 1])
            lead_f[j], bb_f[j] = self._bond_coeffs("f", i_prev[j],
                                                   grid[j + 1])
        dev = self.device
        out = _xccy_ccs_core(
            self._hist[torch.as_tensor(i_prev, device=dev)],
            self._hist[torch.as_tensor(i_pay, device=dev)],
            _f64(self._lnx_det[i_pay], dev), _f64(self._a_int_d[i_pay], dev),
            _f64(lead_d, dev), _f64(bb_d, dev), _f64(lead_f, dev),
            _f64(bb_f, dev), _f64(self._m[i_prev], dev),
            self.mesh).cpu().numpy()
        return float(out[0]), float(out[1])

    def mc_ccs_value(self, payment_times: Sequence[float],
                     domestic_notional: float = 1.0) -> float:
        """Value of receiving the foreign float leg (notional
        domestic_notional / X0) against paying the domestic float leg,
        final notionals exchanged: the resettable basis swap at zero basis,
        worth zero in the model."""
        dom, fgn = self.mc_ccs_legs(payment_times)
        return domestic_notional * (fgn / self.model.fx_spot - dom)


# ---------------------------------------------------------------------------
# counterparty exposure on cross-currency books
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CCSTrade:
    """Float-float cross-currency swap (constant notionals, final
    exchange): receive the foreign leg (plus an optional ``foreign_basis``
    running spread) on notional domestic_notional / X0, pay the domestic
    leg on domestic_notional. ``receive_foreign=False`` flips the
    direction. Payment times must lie on the simulation grid."""
    payment_times: tuple
    domestic_notional: float = 1.0
    receive_foreign: bool = True
    foreign_basis: float = 0.0


@dataclass(frozen=True)
class FXForwardTrade:
    """Receive notional * (X(T) - strike) at maturity T (domestic)."""
    maturity: float
    strike: float
    notional: float = 1.0


def _xccy_exposure_collect(values, inv_n, standalone_pos, qs, mesh=None):
    """Per-date statistics from netted values ``[O, paths]``, packed: rows
    [ee, ene, forward_value, ee_standalone, pfe_q...] x O (under a
    ``mesh``: the means all-reduced, the quantiles of the gathered
    values)."""
    dpe = torch.clamp_min(values, 0.0) * inv_n
    dne = torch.clamp_max(values, 0.0) * inv_n
    means = path_means([dpe, dne, values * inv_n, standalone_pos * inv_n],
                       mesh)
    pfe = _linear_quantiles(gather_paths(values, mesh), qs)  # [Q, O]
    return torch.cat([torch.stack(means), pfe], dim=0)


class CrossCurrencyExposureEngine:
    """EE/ENE/PFE/CVA of a netting set of cross-currency swaps and FX
    forwards under the two-economy model.

    Every trade value is exact pathwise: a floating leg with its final
    notional at a grid date t in (t_{j-1}, t_j] is P(t, t_j) / P(t_{j-1},
    t_j) of its currency, both bonds affine in the simulated factors; the
    FX conversion and the numeraire come from the same state. A zero-basis
    CCS observed at a reset date is worth N_f X(t) - N_d, so EE(t) = N_f
    fx_option(t, N_d / N_f).

    Observation dates: every simulation grid date in (0, last maturity].
    One packed transfer."""

    def __init__(self, simulation: CrossCurrencySimulation, trades,
                 quantiles=(0.95,)):
        if not trades:
            raise ValueError("need at least one trade")
        self.sim = simulation
        self.trades = list(trades)
        self.quantiles = tuple(float(q) for q in quantiles)
        sim = simulation
        times = sim._times
        last = 0.0
        for tr in self.trades:
            if isinstance(tr, CCSTrade):
                pt = np.asarray(tr.payment_times, dtype=np.float64)
                if pt.ndim != 1 or pt.size < 1 or pt[0] <= 0 \
                        or np.any(np.diff(pt) <= 0):
                    raise ValueError("payment_times must be positive, "
                                     "increasing")
                for t in pt:
                    if sim.td.get_time_index(t) < 0:
                        raise ValueError(f"payment time {t} not on the "
                                         "simulation grid")
                last = max(last, float(pt[-1]))
            elif isinstance(tr, FXForwardTrade):
                if sim.td.get_time_index(tr.maturity) < 0:
                    raise ValueError(f"maturity {tr.maturity} not on "
                                     "the simulation grid")
                last = max(last, float(tr.maturity))
            else:
                raise ValueError(f"unsupported trade type {type(tr)}")
        obs = np.array([i for i, t in enumerate(times)
                        if 0.0 < t <= last + 1e-12], dtype=np.int64)
        if obs.size == 0:
            raise ValueError("no observation dates before the last "
                             "maturity")
        self._obs = obs
        self._times_obs = times[obs]
        self._profile = self._compute()

    # ------------------------------------------------------------------
    def _leg_value(self, leg: str, i_obs: int, pt: np.ndarray,
                   basis: float) -> torch.Tensor:
        """Pathwise leg value (float coupons and final notional, unit
        notional, in the leg's currency) at grid index ``i_obs``; zero once
        the leg has matured."""
        sim = self.sim
        t = sim._times[i_obs]
        if t >= pt[-1] - 1e-12:
            return torch.zeros(sim._hist.shape[-1], dtype=ACC_DTYPE,
                               device=sim.device)
        j = int(np.searchsorted(pt, t + 1e-12))          # next payment
        t_next = float(pt[j])
        t_fix = float(pt[j - 1]) if j > 0 else 0.0
        i_fix = sim._index(t_fix)
        lead_o, bb_o = sim._bond_coeffs(leg, i_obs, t_next)
        lead_f_, bb_f_ = sim._bond_coeffs(leg, i_fix, t_next)
        x_o = sim._state(leg, i_obs)
        x_f = sim._state(leg, i_fix)
        value = (lead_o * torch.exp(-bb_o * x_o)) \
            / (lead_f_ * torch.exp(-bb_f_ * x_f))
        if basis != 0.0:
            # running spread on the remaining accrual periods
            deltas = np.diff(np.concatenate([[t_fix], pt[j:]]))
            ann = torch.zeros(sim._hist.shape[-1], dtype=ACC_DTYPE,
                              device=sim.device)
            for tk, dk in zip(pt[j:], deltas):
                lk, bk = sim._bond_coeffs(leg, i_obs, float(tk))
                ann = ann + dk * lk * torch.exp(-bk * x_o)
            value = value + basis * ann
        return value

    def _compute(self) -> ExposureProfile:
        sim = self.sim
        x0 = sim.model.fx_spot
        rows_net, rows_pos, inv_n_rows = [], [], []
        for i in self._obs:
            i = int(i)
            x_spot = torch.exp(sim._lnx(i))
            inv_n = torch.exp(-(sim._hist[i][1].to(ACC_DTYPE)
                                + float(sim._a_int_d[i])))
            net = torch.zeros(sim._hist.shape[-1], dtype=ACC_DTYPE,
                              device=sim.device)
            pos = torch.zeros_like(net)
            for tr in self.trades:
                if isinstance(tr, CCSTrade):
                    pt = np.asarray(tr.payment_times, dtype=np.float64)
                    dom = self._leg_value("d", i, pt, 0.0)
                    fgn = self._leg_value("f", i, pt, tr.foreign_basis)
                    v = tr.domestic_notional * (x_spot * fgn / x0 - dom)
                    if not tr.receive_foreign:
                        v = -v
                elif sim._times[i] >= tr.maturity - 1e-12:
                    v = torch.zeros_like(net)
                else:
                    lead_f_, bb_f_ = sim._bond_coeffs("f", i, tr.maturity)
                    lead_d_, bb_d_ = sim._bond_coeffs("d", i, tr.maturity)
                    v = tr.notional * (
                        x_spot * lead_f_ * torch.exp(-bb_f_
                                                     * sim._state("f", i))
                        - tr.strike * lead_d_
                        * torch.exp(-bb_d_ * sim._state("d", i)))
                net = net + v
                pos = pos + torch.clamp_min(v, 0.0)
            rows_net.append(net)
            rows_pos.append(pos)
            inv_n_rows.append(inv_n)
        out = _xccy_exposure_collect(
            torch.stack(rows_net), torch.stack(inv_n_rows),
            torch.stack(rows_pos),
            _f64(self.quantiles, sim.device), sim.mesh).cpu().numpy()
        pfe = {q: out[4 + k] for k, q in enumerate(self.quantiles)}
        return ExposureProfile(times=self._times_obs, ee=out[0],
                               ene=out[1], forward_value=out[2],
                               pfe=pfe, ee_standalone=out[3])

    def profile(self) -> ExposureProfile:
        """The netting set's ``ExposureProfile`` (the LMM exposure engine's
        conventions: discounted EE/ENE/forward_value, undiscounted PFE
        quantiles)."""
        return self._profile

    def cva(self, hazard_rate: float = 0.02,
            recovery: float = 0.4) -> float:
        """Unilateral CVA off the profile (deterministic hazard; for
        rate-correlated intensities see ``models.credit``)."""
        return cva_from_profile(self._profile, hazard_rate=hazard_rate,
                                recovery=recovery)
