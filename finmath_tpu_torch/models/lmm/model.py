"""LIBOR Market Model: simulation and swaption valuation as one
differentiable function of the covariance parameters.

Counterpart of ``finmath_tpu.models.lmm.model`` (finmath-lib's
``LIBORMarketModelFromCovarianceModel`` + ``EulerSchemeFromProcessModel`` +
``SwaptionSimple`` as the reference's ATM calibration test drives them,
LIBORMarketModelCalibrationATMTest.java:270-466) and of its stoch-vol
benchmark calibration (LIBORMarketModelCalibrationTest.java:246-306). The
port carries the configurations those calibrations use: spot measure,
NORMAL state space (optionally with a displaced or blended local
volatility, optionally with stochastic volatility), the Euler scheme,
simulation grid equal to the tenor grid, one device, plain Monte Carlo.
Other options raise ``NotImplementedError`` naming the part of the port
that brings them.

One call simulates every path once and values all products from the same
ensemble: path state is float32 ``[libors, paths]``, the spot numeraire,
the stochastic-volatility process and every collection (bond curve,
annuity, payoff) are float64. The time loop is a Python loop; ``jacobian``
is ``torch.func.jacfwd`` of the residual function, exact (not finite
differences), so the loop stays free of in-place updates on tensors that
carry tangents.

Spot-measure drift, NORMAL state space (forwards evolved directly):
  dL_i = lambda_i . (sum_{j=m+1..i} delta_j lambda_j / (1+delta_j L_j)) dt
         + lambda_i . dW
with lambda_{i,f}(t, L) = localFactor(L_i) * sigma_i(t) * V(t)^e * R_{i,f}
(V = 1 without stochastic volatility). Stochastic volatility draws one
more Brownian factor, dW_V = rho dW_0 + sqrt(1-rho^2) dW_F, and steps
V *= exp(nu dW_V - nu^2 dt / 2) (the drift only with the martingale
correction), capped at 1e6; the new V scales the loadings from the next
step on. Numeraire: N(T_m) = prod_{j<m} (1 + delta_j L_j(T_j)), with the
deterministic adjustment E[1/N(T)] -> df(T) applied to the values when the
model asks for it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd

from ...utils.config import select_device
from ..curves import DiscountCurve, ForwardCurve, par_swap_rate
from ..time_discretization import TimeDiscretization

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _ncdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _npdf(x):
    return torch.exp(-0.5 * x * x) / _SQRT_2PI


def bachelier_implied_vol(value, forward, strike, maturity, annuity,
                          num_iter: int = 20):
    """Differentiable Bachelier (normal) implied volatility via Newton from
    the exact-ATM initial guess, elementwise (float64 tensors that
    broadcast together)."""
    sqrt_t = torch.sqrt(maturity)
    p = torch.clamp_min(value / annuity, 1e-14)
    sigma = p * _SQRT_2PI / sqrt_t  # exact at the money
    for _ in range(num_iter):
        d = (forward - strike) / (sigma * sqrt_t)
        val = (forward - strike) * _ncdf(d) + sigma * sqrt_t * _npdf(d)
        vega = sqrt_t * _npdf(d)
        step = (val - p) / torch.clamp_min(vega, 1e-14)
        sigma = torch.clamp(sigma - step, 1e-12, 10.0)
    return sigma


class _BlackImpliedVol(torch.autograd.Function):
    """``black_implied_vol`` with its implicit-function derivative. The
    root solves OTM(sigma; F, K, T) = p - max(F - K, 0), p = value /
    annuity, so with vega = F sqrt(T) phi(d1):
        d sigma = (dp - N(d1) dF + N(d2) dK - vega sigma / (2 T) dT) / vega,
    and 0 where the inversion returned 0 or sits on a bound. The JAX
    package differentiates through its 60 Newton steps, which converge to
    the same derivative; here forward mode costs a few operations instead
    of 60 steps of tangents."""

    generate_vmap_rule = True

    @staticmethod
    def forward(value, forward, strike, maturity, annuity, num_iter):
        sqrt_t = torch.sqrt(maturity)
        p = value / annuity
        intrinsic = torch.clamp_min(forward - strike, 0.0)
        raw_time_value = p - intrinsic
        time_value = torch.clamp_min(raw_time_value, 1e-16)
        # OTM twin: if F >= K invert the put (value = time value), else
        # the call
        is_itm = forward >= strike
        erfc = torch.special.erfc
        inv_sqrt2 = 1.0 / math.sqrt(2.0)
        log_fk = torch.log(forward / strike)
        sigma = torch.clamp_min(
            torch.sqrt(2.0 * torch.abs(log_fk) / maturity), 1e-2)
        for _ in range(num_iter):
            v = torch.clamp_min(sigma, 1e-8) * sqrt_t
            d1 = log_fk / v + 0.5 * v
            d2 = d1 - v
            call = 0.5 * (forward * erfc(-d1 * inv_sqrt2)
                          - strike * erfc(-d2 * inv_sqrt2))
            put = 0.5 * (strike * erfc(d2 * inv_sqrt2)
                         - forward * erfc(d1 * inv_sqrt2))
            vega = forward * sqrt_t * _npdf(d1)
            val = torch.where(is_itm, put, call)
            step = (val - time_value) / torch.clamp_min(vega, 1e-16)
            # damped Newton: cap the multiplicative move
            step = torch.minimum(torch.maximum(step, -0.5 * sigma), 0.5 * sigma)
            sigma = torch.clamp(sigma - step, 1e-8, 10.0)
        return torch.where(raw_time_value <= 1e-12 * forward, 0.0, sigma)

    @staticmethod
    def setup_context(ctx, inputs, output):
        value, forward, strike, maturity, annuity, _ = inputs
        ctx.save_for_forward(value, forward, strike, maturity, annuity,
                             output)

    @staticmethod
    def jvp(ctx, value_dot, forward_dot, strike_dot, maturity_dot,
            annuity_dot, _):
        value, forward, strike, maturity, annuity, sigma = ctx.saved_tensors
        p = value / annuity
        sqrt_t = torch.sqrt(maturity)
        v = sigma * sqrt_t
        d1 = torch.log(forward / strike) / v + 0.5 * v
        vega = forward * sqrt_t * _npdf(d1)
        numerator = torch.zeros_like(sigma)
        if value_dot is not None:
            numerator = numerator + value_dot / annuity
        if annuity_dot is not None:
            numerator = numerator - p * annuity_dot / annuity
        if forward_dot is not None:
            numerator = numerator - _ncdf(d1) * forward_dot
        if strike_dot is not None:
            numerator = numerator + _ncdf(d1 - v) * strike_dot
        if maturity_dot is not None:
            numerator = numerator - vega * sigma / (2.0 * maturity) * maturity_dot
        time_value = p - torch.clamp_min(forward - strike, 0.0)
        live = ((sigma > 1e-8) & (sigma < 10.0) & (time_value > 1e-16)
                & (vega > 1e-16))
        return torch.where(live, numerator / torch.where(live, vega, 1.0),
                           0.0)


def black_implied_vol(value, forward, strike, maturity, annuity,
                      num_iter: int = 60):
    """Differentiable Black (lognormal) implied volatility, elementwise
    (float64 tensors that broadcast together).

    Deep in-the-money options have almost no vega, so the TIME VALUE of
    the out-of-the-money twin is inverted instead (call-put parity: equal
    time value, same vega), by damped Newton from the Manaster-Koehler
    seed sqrt(2|ln(F/K)|/T). The OTM value comes from erfc tail
    probabilities, which keep their relative precision in the tails.
    Quotes at or below intrinsic value return vol 0. Forward-mode
    derivatives are implicit (see ``_BlackImpliedVol``)."""
    return _BlackImpliedVol.apply(value, forward, strike, maturity, annuity,
                                  num_iter)


@dataclass(frozen=True)
class SwaptionProduct:
    """A (payer) swaption on the model tenor grid, quoted in a value unit.

    Equivalent of finmath's SwaptionSimple(swaprate, swapTenor, ValueUnit)
    (ATM test :507-510). ``exercise_index``/``num_periods`` are indices on
    the LIBOR tenor grid.
    """

    exercise_index: int
    num_periods: int
    strike: float
    target: float                 # target in the chosen value unit
    weight: float = 1.0
    value_unit: str = "VOLATILITYNORMAL"  # | VOLATILITYLOGNORMAL | VALUE


class LIBORMarketModelTorch:
    """Static model definition: tenor grid, initial forwards, curves,
    covariance model, measure/state-space conventions — the counterpart of
    ``finmath_tpu``'s ``LIBORMarketModelTPU`` (same arguments and checks).

    ``measure``: "spot" or "terminal"; ``state_space``: "normal" or
    "lognormal"; ``simulation_td``: optional simulation grid refining the
    tenor grid. The valuation engine of this slice takes spot / normal /
    simulation grid == tenor grid."""

    def __init__(self, libor_td: TimeDiscretization,
                 forward_curve: ForwardCurve,
                 discount_curve: DiscountCurve,
                 covariance_model,
                 measure: str = "spot",
                 state_space: str = "normal",
                 use_numeraire_adjustment: bool = True,
                 simulation_td: Optional[TimeDiscretization] = None):
        if measure not in ("spot", "terminal"):
            raise ValueError(f"unknown measure {measure!r}")
        if state_space not in ("normal", "lognormal"):
            raise ValueError(f"unknown state_space {state_space!r}")
        self.measure = measure
        self.state_space = state_space
        self.libor_td = libor_td
        self.simulation_td = simulation_td if simulation_td is not None else libor_td
        self.forward_curve = forward_curve
        self.discount_curve = discount_curve
        self.covariance = covariance_model
        self.use_numeraire_adjustment = use_numeraire_adjustment

        n = libor_td.get_number_of_time_steps()
        self.num_libors = n
        self.tenor_times = np.asarray([libor_td.get_time(i) for i in range(n + 1)])
        self.deltas = self.tenor_times[1:] - self.tenor_times[:-1]
        self.initial_forwards = forward_curve.get_forward(self.tenor_times[:-1])

        s = self.simulation_td.get_number_of_time_steps()
        self.sim_times = np.asarray([self.simulation_td.get_time(i)
                                     for i in range(s + 1)])
        for t in self.tenor_times:
            if t <= self.sim_times[-1] and not np.any(
                    np.isclose(self.sim_times, t, atol=1e-9)):
                raise ValueError(
                    f"tenor point {t} is not on the simulation grid; the "
                    "simulation grid must refine the tenor grid")


class LMMValuationEngine:
    """(model, products, paths, factors, seed) -> ``values`` /
    ``implied_vols`` / ``residuals`` / ``jacobian`` of the covariance
    parameter vector, on one device.

    The Brownian realization is drawn once, at construction, on the
    engine's device and kept there (``increments``, ``[S, F', paths]``
    float32 already scaled by sqrt(dt), ``S`` the last exercise step,
    ``F'`` the factors plus one with stochastic volatility): from
    ``torch.Generator(device).manual_seed(seed)``, or the caller's
    ``increments=`` in the JAX engine's injected format (NumPy or tensor;
    ``injected`` says which). Every evaluation prices the same paths."""

    def __init__(self, model: LIBORMarketModelTorch,
                 products: Sequence[SwaptionProduct],
                 num_paths: int, num_factors: int, seed: int = 31415, *,
                 device=None, increments=None, scheme: str = "euler",
                 dtype: torch.dtype = torch.float32, mesh=None,
                 antithetic: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "path-axis sharding comes with the sharding slice "
                "(torch.distributed)")
        if scheme != "euler":
            raise NotImplementedError(
                f"scheme {scheme!r}: only 'euler' is ported; the "
                "predictor-corrector scheme comes with the rest of the LMM "
                "stack")
        if dtype != torch.float32:
            raise NotImplementedError(
                "path storage is float32; the float64 parity engine comes "
                "with the rest of the LMM stack")
        if antithetic:
            raise NotImplementedError(
                "antithetic sampling comes with the rest of the LMM stack")
        if model.measure != "spot":
            raise NotImplementedError(
                "terminal measure comes with the rest of the LMM stack")
        if model.state_space != "normal":
            raise NotImplementedError(
                "lognormal state space comes with the rest of the LMM stack")
        n = model.num_libors
        if len(model.sim_times) != n + 1 or not np.allclose(
                model.sim_times, model.tenor_times, atol=1e-9):
            raise NotImplementedError(
                "a simulation grid refining the tenor grid comes with the "
                "rest of the LMM stack")
        self.model = model
        self.device = torch.device(device) if device is not None \
            else select_device()
        self.num_paths = int(num_paths)
        self.num_factors = int(num_factors)
        cov_factors = getattr(model.covariance, "num_factors", None)
        if cov_factors is not None and int(cov_factors) != self.num_factors:
            raise ValueError(
                f"engine num_factors={self.num_factors} but the covariance "
                f"model has {cov_factors} factors; they must match (the "
                "factor reduction lives in the correlation model)")
        self.seed = int(seed)

        # keep only products whose payments stay on the tenor grid (the
        # reference's valuation loop skips the others, ATM test :387-401)
        kept = [p for p in products
                if p.exercise_index + p.num_periods <= n and p.exercise_index >= 1]
        if not kept:
            raise ValueError("no products fit on the tenor grid")
        self.products = sorted(kept, key=lambda p: (p.exercise_index, p.num_periods))
        units = {p.value_unit for p in self.products}
        if len(units) > 1:
            raise ValueError(f"mixed value units not supported: {units}")
        self.value_unit = units.pop()
        if self.value_unit not in ("VOLATILITYNORMAL", "VOLATILITYLOGNORMAL",
                                   "VALUE"):
            raise ValueError(f"unknown value unit {self.value_unit}")

        # ---- static packing (host float64, as in the JAX engine) ----------
        deltas = model.deltas
        tenor = model.tenor_times
        dc = model.discount_curve
        fc = model.forward_curve
        self.exercise_indices = sorted({p.exercise_index for p in self.products})
        ev_index = {e: j for j, e in enumerate(self.exercise_indices)}
        self._target = np.asarray([p.target for p in self.products])
        # per product: annuity and par rate at t=0, strike, expiry, target,
        # weight, discount factor at expiry
        rows = []
        for p in self.products:
            e, m = p.exercise_index, p.num_periods
            rows.append((
                float(np.sum(deltas[e:e + m]
                             * dc.get_discount_factor(tenor[e + 1:e + m + 1]))),
                par_swap_rate(fc, dc, tenor[e:e + m + 1]),
                p.strike, float(tenor[e]), p.target, p.weight,
                float(dc.get_discount_factor(float(tenor[e])))))
        per_product = dict(zip(
            ("ann0", "fwd0", "strike", "texp", "target", "weight", "df_ex"),
            np.asarray(rows).T))

        # simulation runs to the last exercise step (collect happens at the
        # START of a step, so nothing after it is ever read)
        self.num_steps = n
        self.steps_needed = self.exercise_indices[-1]
        dev = self.device
        f64, f32 = torch.float64, torch.float32
        self._t = {k: torch.as_tensor(v, dtype=f64, device=dev)
                   for k, v in per_product.items()}
        self._t.update(
            deltas32=torch.as_tensor(deltas, dtype=f32, device=dev),
            deltas64=torch.as_tensor(deltas, dtype=f64, device=dev),
            L0=torch.as_tensor(model.initial_forwards, dtype=f32, device=dev),
            dts=torch.as_tensor(np.diff(model.sim_times), dtype=f32, device=dev),
            ev_of=torch.as_tensor([ev_index[p.exercise_index]
                                   for p in self.products], device=dev),
        )
        # per event: its products' annuity masks over the swap periods
        # (relative to the exercise index), end rows and strikes
        self._events = []
        for e in self.exercise_indices:
            group = [p for p in self.products if p.exercise_index == e]
            width = max(p.num_periods for p in group)
            mask = np.zeros((len(group), width))
            for j, p in enumerate(group):
                mask[j, :p.num_periods] = deltas[e:e + p.num_periods]
            self._events.append(dict(
                e=e, width=width,
                pay_mask=torch.as_tensor(mask, dtype=f64, device=dev),
                end=torch.as_tensor([p.num_periods - 1 for p in group],
                                    device=dev),
                strike=torch.as_tensor([p.strike for p in group],
                                       dtype=f64, device=dev)))

        # stochastic volatility consumes one extra Brownian factor, the
        # driver of V (ref. wires it via a BrownianMotionView on factors
        # {0, extra}, benchmark test :267-269)
        self.stoch_vol = bool(model.covariance.has_stoch_vol)
        rng_factors = self.num_factors + int(self.stoch_vol)
        shape = (self.steps_needed, rng_factors, self.num_paths)
        self.injected = increments is not None
        if increments is not None:
            inc = torch.as_tensor(increments).to(device=dev, dtype=f32)
            if (inc.dim() != 3 or inc.shape[1:] != shape[1:]
                    or not shape[0] <= inc.shape[0] <= self.num_steps):
                raise ValueError(
                    f"injected increments have shape {tuple(inc.shape)}, "
                    f"engine needs [steps in {shape[0]}..{self.num_steps}, "
                    f"factors={rng_factors}, paths={self.num_paths}]")
            self.increments = inc[:shape[0]].contiguous()
        else:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            z = torch.randn(shape, generator=gen, dtype=f32, device=dev)
            self.increments = z * self._t["dts"][:shape[0], None, None].sqrt()

    # ------------------------------------------------------------------
    def _params(self, params) -> torch.Tensor:
        x = torch.as_tensor(params, dtype=torch.float64).to(self.device)
        n_params = int(self.model.covariance.n_params)
        if x.shape != (n_params,):
            raise ValueError(f"params shape {tuple(x.shape)} != ({n_params},)")
        return x

    def _collect(self, ev: dict, L: torch.Tensor, N: torch.Tensor):
        """Path sums of payoff/numeraire for one event's products [m_ev]
        and of 1/numeraire [], float64, non-finite contributions dropped.
        ``L`` holds the forwards from the exercise index on."""
        t = self._t
        e, width = ev["e"], ev["width"]
        Lw = L[:width].to(torch.float64)                           # [w, paths]
        d = t["deltas64"][e:e + width, None]
        cp = torch.cumprod(1.0 / (1.0 + d * Lw), dim=0)           # P(T_e, T_j+1)
        ann = ev["pay_mask"] @ cp                                  # [m_ev, paths]
        p_end = cp[ev["end"]]
        payoff = torch.clamp_min(1.0 - p_end - ev["strike"][:, None] * ann, 0.0)
        inv_n = 1.0 / N
        contrib = payoff * inv_n[None, :]
        contrib = torch.where(torch.isfinite(contrib), contrib, 0.0)
        inv_safe = torch.where(torch.isfinite(inv_n), inv_n, 0.0)
        return contrib.sum(dim=-1), inv_safe.sum()

    def _values(self, params: torch.Tensor) -> torch.Tensor:
        """Monte-Carlo values [P] (numeraire adjustment applied).

        On the tenor grid, forward i evolves during steps s < i only, so at
        step s the state is the live block ``L[s:]``: its first row L_s has
        just fixed (it accrues the numeraire and is read by the step's
        collection), the rest evolve. The block shrinks by one row a step
        and nothing needs the fixed rows again."""
        t = self._t
        cov = self.model.covariance
        n, paths, F = self.model.num_libors, self.num_paths, self.num_factors
        f32, f64 = torch.float32, torch.float64
        prep = cov.prepare(params)
        vol = cov.vol_table(prep).to(f32)                          # [S, n]
        R = cov.factor_matrix(prep).to(f32)                        # [n, F]
        L0 = t["L0"][:, None].expand(n, paths)
        d32 = t["deltas32"][:, None]
        L = L0                                                     # rows s..n-1
        N = torch.ones(paths, dtype=f64, device=self.device)
        if self.stoch_vol:
            # nu and rho enter in the path dtype, V and its step in float64
            # (the JAX engine's choice: one downcast of V per step instead
            # of a float32 product of exponentials)
            nu, rho = (torch.as_tensor(p, dtype=f64, device=self.device)
                       .to(f32).to(f64) for p in cov.stoch_vol_params(prep))
            somega = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 1e-12))
            exponent = getattr(cov, "scaling_exponent", 0.5)
            martingale = getattr(cov, "martingale_correction", True)
            V = torch.ones(paths, dtype=f64, device=self.device)
        raws, invs = [], []
        events = iter(self._events)
        ev = next(events)
        for s in range(self.steps_needed + 1):
            if s == ev["e"]:
                raw, inv = self._collect(ev, L, N)
                raws.append(raw)
                invs.append(inv)
                ev = next(events, None)
                if ev is None:
                    break
            # spot account accrues period s at its fixing L_s
            N = N * (1.0 + t["deltas32"][s] * L[0]).to(f64)
            La = L[1:]                                             # rows s+1..
            lam = vol[s, s + 1:, None]                             # [n', 1]
            if cov.has_local_vol:
                lam = lam * cov.local_factor(prep, La, L0[s + 1:])
            if self.stoch_vol:
                Vc = V.to(f32)
                lam = lam * (Vc if exponent == 1.0 else torch.sqrt(Vc)
                             if exponent == 0.5 else Vc ** exponent)
            lam = lam[:, None, :] * R[s + 1:, :, None]             # [n', F, .]
            d = d32[s + 1:]
            mt = d / (1.0 + d * La)
            acc = torch.cumsum(mt[:, None, :] * lam, dim=0)        # incl. own
            mu = torch.sum(lam * acc, dim=1)
            dw = self.increments[s]                                # [F', paths]
            diffusion = torch.sum(lam * dw[None, :F], dim=1)
            # float32 guard: rates beyond +-1000 carry no price information
            L = torch.clamp(La + mu * t["dts"][s] + diffusion, -1e3, 1e3)
            if self.stoch_vol:
                dw_v = rho * dw[0].to(f64) + somega * dw[F].to(f64)
                arg = nu * dw_v
                if martingale:
                    arg = arg - 0.5 * nu * nu * t["dts"][s].to(f64)
                # the same overflow guard for the scaling process
                V = torch.clamp_max(V * torch.exp(arg), 1e6)
        raw = torch.cat(raws) / paths                              # [P]
        if not self.model.use_numeraire_adjustment:
            return raw
        mean_inv = torch.stack(invs)[t["ev_of"]] / paths           # [P]
        return raw * torch.where(mean_inv > 0.0, t["df_ex"] / mean_inv, 0.0)

    def _quotes(self, values: torch.Tensor) -> torch.Tensor:
        if self.value_unit == "VALUE":
            return values
        t = self._t
        invert = (black_implied_vol if self.value_unit == "VOLATILITYLOGNORMAL"
                  else bachelier_implied_vol)
        return invert(values, t["fwd0"], t["strike"], t["texp"], t["ann0"])

    def _residuals(self, params: torch.Tensor) -> torch.Tensor:
        t = self._t
        return t["weight"] * (self._quotes(self._values(params)) - t["target"])

    # ------------------------------------------------------------------
    # public API: NumPy (or tensor) in, NumPy out
    # ------------------------------------------------------------------
    def values(self, params) -> np.ndarray:
        """Monte-Carlo swaption values (in price units) per product."""
        return self._values(self._params(params)).cpu().numpy()

    def implied_vols(self, params) -> np.ndarray:
        """Model quotes in the product value unit, from the values."""
        return self._quotes(self._values(self._params(params))).cpu().numpy()

    def residuals(self, params) -> np.ndarray:
        return self._residuals(self._params(params)).cpu().numpy()

    def jacobian(self, params) -> np.ndarray:
        """d residuals / d params [P, n_params], forward-mode through the
        whole simulation."""
        return jacfwd(self._residuals)(self._params(params)).cpu().numpy()

    @property
    def targets(self) -> np.ndarray:
        return np.asarray(self._target)
