"""LIBOR Market Model: simulation and swaption valuation as one
differentiable function of the covariance parameters.

Counterpart of ``finmath_tpu.models.lmm.model`` (finmath-lib's
``LIBORMarketModelFromCovarianceModel`` + ``EulerSchemeFromProcessModel`` +
``SwaptionSimple`` as the reference's ATM calibration test drives them,
LIBORMarketModelCalibrationATMTest.java:270-466) and of its stoch-vol
benchmark calibration (LIBORMarketModelCalibrationTest.java:246-306):
spot or terminal measure, NORMAL (optionally with a displaced or blended
local volatility, optionally with stochastic volatility) or LOGNORMAL
state space, the Euler or predictor-corrector scheme, any simulation grid
that refines the tenor grid, float32 or float64 paths, antithetic
sampling; one device, or the path axis split over the ranks of a
``parallel.PathMesh`` (``mesh=``).

One call simulates every path once and values all products from the same
ensemble: path state is ``[libors, paths]`` in the path dtype (float32 by
default), the spot numeraire, the stochastic-volatility process and every
collection (bond curve, annuity, payoff) in the collect dtype (float64 by
default). The time loop is a Python loop; ``jacobian`` is
``torch.func.jacfwd`` of the residual function, exact (not finite
differences), so the loop stays free of in-place updates on tensors that
carry tangents; ``residuals_batched`` / ``jacobian_batched`` are
``torch.func.vmap`` of the same functions, and ``forward_deltas`` reverse
mode through the sweep. Under a mesh each rank simulates its block of the
paths and the expectations are summed over the ranks between two halves:
the local path sums, and the replicated rest (division by the paths,
numeraire adjustment, implied-vol inversion); forward-mode Jacobians are
taken of each half, never through a collective (``parallel.mesh``).

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
from torch.func import jacfwd, vmap

from ...parallel.mesh import (check_mesh, mesh_device, rank_seed,
                              replicated, sum_over_ranks)
from ..brownian_motion import key_for_seed, normal_increments
from ..curves import DiscountCurve, ForwardCurve, par_swap_rate
from ..time_discretization import TimeDiscretization

_SQRT_2PI = math.sqrt(2.0 * math.pi)
#: damped Newton steps of ``black_implied_vol``, a fixed count (no early
#: exit); the stoch-vol kernel backend's CUDA inversion takes the same
BLACK_NEWTON_STEPS = 60


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
                      num_iter: int = BLACK_NEWTON_STEPS):
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

    ``measure``: "spot" (rolling spot account numeraire) or "terminal"
    (zero bond P(., T_n)); ``state_space``: "normal" or "lognormal"
    (log-Euler); ``simulation_td``: optional simulation grid refining the
    tenor grid (every tenor point a simulation point), the tenor grid by
    default."""

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


def adjoint_dead_mask(L, N, deltas_col, spot: bool) -> torch.Tensor:
    """Paths whose bond-ratio scan would poison a reverse-mode adjoint, of a
    live block ``L`` [rows, paths] (the JAX package's ``adjoint_dead_mask``
    on the rows the collection reads): an accrual factor at or past the
    pole, a forward at the +-1e3 clamp or not finite, a contiguous block
    product of the scan leaving float range (the running log-sum's largest
    ascent, and its minimum, within 85), and under the spot measure a
    numeraire outside (1e-12, 1e30). NaN-safe: ``~(x < t)`` is True for a
    NaN. Computed without gradient."""
    with torch.no_grad():
        L, N = L.detach(), N.detach()
        sfac = 1.0 + deltas_col * L
        logs = torch.log(torch.clamp_min(torch.abs(sfac), 1e-30))
        logcum = torch.cumsum(logs, dim=0)
        runmin = torch.cummin(torch.clamp_max(logcum, 0.0), dim=0).values
        ascent = torch.max(logcum - runmin, dim=0).values
        bad = torch.any(~torch.isfinite(L) | (torch.abs(L) >= 999.0)
                        | (sfac <= 1e-6), dim=0)
        if spot:
            bad = bad | ~(N > 1e-12) | ~(N < 1e30)
        return (bad | ~(ascent < 85.0)
                | ~(torch.min(logcum, dim=0).values > -85.0))


class LMMValuationEngine:
    """(model, products, paths, factors, seed) -> ``values`` /
    ``implied_vols`` / ``residuals`` / ``jacobian`` of the covariance
    parameter vector, on one device.

    The Brownian realization is drawn once, at construction, on the
    engine's device and kept there (``increments``, ``[S, F', paths]`` in
    the path dtype, already scaled by sqrt(dt), ``S`` the last exercise
    step, ``F'`` the factors plus one with stochastic volatility): float32
    normals from ``torch.Generator(device).manual_seed(seed)``, upcast for
    the float64 engine (so the float32 and float64 engines price one
    stream), or the caller's ``increments=`` in the JAX engine's injected
    format (NumPy or tensor, copied; ``injected`` says which;
    ``set_increments`` swaps it in place). Every evaluation prices the same
    paths.

    Options, each following the JAX engine's arithmetic:

    * ``dtype``: path storage, float32 (default) or float64 (the parity
      engine); ``collect_dtype``: the collection's (bond curve, annuity,
      payoff, spot numeraire, V), float64 by default and never below
      ``dtype``; the contributions are float64 either way;
    * ``antithetic``: the path axis holds ``[z, -z]`` (paths even; not
      with ``increments=``);
    * ``scheme``: "euler" or "predictor_corrector" (the drift averaged at
      the current and the Euler-predicted state, the diffusion kept);
    * the model's ``measure`` ("spot" or "terminal": the suffix drift over
      j > i and the P(T_e, T_n) numeraire, values scaled by P(0, T_n)),
      ``state_space`` ("normal" or "lognormal": log-Euler with the L_j
      numerator in the drift and the -|lambda|^2 / 2 Ito term) and
      simulation grid (any grid refining the tenor grid);
    * ``mesh``: a ``parallel.PathMesh``: the paths are split over its
      ranks (``num_paths`` divisible by the world size, and each rank's
      block even under antithetic sampling), every rank holds its block
      of the realization on the mesh's device (the default ``device``;
      another raises), and every public result is the same on every rank.
      The engine's own draw is then rank r's block of ``num_paths / W``
      paths from ``torch.Generator(device).manual_seed(rank_seed(seed,
      r))``; injected increments are the global ``[S, F', num_paths]``
      array, of which rank r keeps ``[..., r n:(r + 1) n]`` (JAX's
      ``P(None, None, axis)``), so the meshed engine prices the unsharded
      engine's paths. ``path_axis`` labels the mesh's axis, as in the JAX
      engine. Every call runs one all-reduce, and a delta ladder one more
      for each backward sweep; ``pathwise_values`` is single-device."""

    def __init__(self, model: LIBORMarketModelTorch,
                 products: Sequence[SwaptionProduct],
                 num_paths: int, num_factors: int, seed: int = 31415, *,
                 device=None, increments=None, scheme: str = "euler",
                 dtype: torch.dtype = torch.float32, collect_dtype=None,
                 mesh=None, path_axis: str = "paths",
                 antithetic: bool = False):
        self.mesh = check_mesh(mesh)
        self.path_axis = path_axis
        if scheme not in ("euler", "predictor_corrector"):
            raise ValueError(f"unknown scheme {scheme!r}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"path dtype {dtype}: float32 or float64")
        self.scheme = scheme
        self.dtype = dtype
        cd = collect_dtype if collect_dtype is not None else torch.float64
        if cd not in (torch.float32, torch.float64):
            raise ValueError(f"collect_dtype {cd}: float32 or float64")
        # never below the path dtype (a float64 engine collects in float64)
        self.collect_dtype = cd if cd.itemsize >= dtype.itemsize else dtype
        self.antithetic = bool(antithetic)
        if self.antithetic and int(num_paths) % 2:
            raise ValueError("antithetic sampling requires an even num_paths")
        if increments is not None and self.antithetic:
            raise ValueError(
                "antithetic and injected increments are mutually exclusive: "
                "the injected realization defines every path")
        self.model = model
        self.num_paths = int(num_paths)
        if self.mesh is None:
            self._local_paths, self._block = self.num_paths, slice(None)
        else:
            self._local_paths = self.mesh.local_count(self.num_paths)
            self._block = self.mesh.local_slice(self.num_paths)
            if self.antithetic and self._local_paths % 2:
                raise ValueError("antithetic sampling requires an even "
                                 "per-rank path count")
        self.device = mesh_device(self.mesh, device)
        self.num_factors = int(num_factors)
        cov_factors = getattr(model.covariance, "num_factors", None)
        if cov_factors is not None and int(cov_factors) != self.num_factors:
            raise ValueError(
                f"engine num_factors={self.num_factors} but the covariance "
                f"model has {cov_factors} factors; they must match (the "
                "factor reduction lives in the correlation model)")
        self.seed = int(seed)
        n = model.num_libors

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
        sim = model.sim_times
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
        # terminal-measure numeraire at t=0: P(0, T_n) from the model's own
        # initial forwards
        self._p0_terminal = float(np.prod(
            1.0 / (1.0 + deltas * np.asarray(model.initial_forwards))))

        # ---- the simulation grid ------------------------------------------
        # step s runs [t_s, t_s+1); forward i evolves during it iff
        # t_s < T_i, so the first live forward is the number of tenor
        # points at or before t_s; a step starting at tenor point T_m
        # first accrues period m at the just-fixed L_m (spot measure)
        S = len(sim) - 1
        self.num_steps = S
        self._alive_from = [int(np.sum(tenor[:n] <= sim[s] + 1e-9))
                            for s in range(S)]
        self._fixing = []
        for s in range(S):
            hit = np.where(np.isclose(tenor[:n], sim[s], atol=1e-9))[0]
            self._fixing.append(int(hit[0]) if hit.size else -1)
        # exercise events: collected at the step that STARTS at T_e
        self._event_steps = []
        for e in self.exercise_indices:
            s_idx = self.exercise_step_of(e)
            if not np.isclose(sim[s_idx], tenor[e], atol=1e-9) or s_idx >= S:
                raise ValueError(
                    f"exercise time {tenor[e]} is not a simulation step start")
            self._event_steps.append(s_idx)
        # simulation runs to the last exercise step (collect happens at the
        # START of a step, so nothing after it is ever read)
        self.steps_needed = self._event_steps[-1]

        dev = self.device
        f64, f32 = torch.float64, torch.float32
        self._t = {k: torch.as_tensor(v, dtype=f64, device=dev)
                   for k, v in per_product.items()}
        self._t.update(
            deltas32=torch.as_tensor(deltas, dtype=f32, device=dev),
            deltas64=torch.as_tensor(deltas, dtype=f64, device=dev),
            L0=torch.as_tensor(model.initial_forwards, dtype=f32, device=dev),
            dts=torch.as_tensor(np.diff(sim), dtype=f32, device=dev),
            ev_of=torch.as_tensor([ev_index[p.exercise_index]
                                   for p in self.products], device=dev),
        )
        # the simulation's tables in the path dtype
        self._p = {k: torch.as_tensor(v, dtype=dtype, device=dev)
                   for k, v in (("deltas", deltas),
                                ("L0", model.initial_forwards),
                                ("dts", np.diff(sim)))}
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
            src = torch.as_tensor(getattr(increments, "increments", increments))
            if (src.dim() != 3 or tuple(src.shape[1:]) != shape[1:]
                    or not shape[0] <= src.shape[0] <= S):
                raise ValueError(
                    f"injected increments have shape {tuple(src.shape)}, "
                    f"engine needs [steps in {shape[0]}..{S}, "
                    f"factors={rng_factors}, paths={self.num_paths}]")
            self._inc_shape, self._inc_dtype = tuple(src.shape), src.dtype
            # a copy the engine owns (this rank's block under a mesh):
            # set_increments overwrites it in place
            self.increments = src[:shape[0], :, self._block].to(
                device=dev, dtype=dtype, copy=True).contiguous()
        else:
            self.increments = self._draw(self.seed)

    # ------------------------------------------------------------------
    def _draw(self, seed: int) -> torch.Tensor:
        """The engine's own realization for ``seed``: this rank's block of
        float32 standard normals from the port's Brownian module
        (``brownian_motion.normal_increments`` on ``key_for_seed``), in the
        path dtype, scaled by sqrt(dt)."""
        shape = (self.steps_needed, self.num_factors + int(self.stoch_vol),
                 self._local_paths)
        if self.mesh is not None:
            seed = rank_seed(seed, self.mesh.rank)
        gen = key_for_seed(seed, self.device)
        unit = torch.ones(shape[0], dtype=torch.float32, device=self.device)
        if self.antithetic:
            z = normal_increments(gen, shape[0], shape[1], shape[2] // 2,
                                  unit)
            z = torch.cat([z, -z], dim=2)
        else:
            z = normal_increments(gen, *shape, unit)
        return (z.to(self.dtype)
                * self._p["dts"][:shape[0], None, None].sqrt())

    def reseed(self, seed: int) -> None:
        """Draw a fresh realization from ``seed`` on the device, in place of
        the engine's: every later evaluation prices the paths of a new
        engine built with that seed, bit for bit, and every table the
        construction built is kept. Under a mesh each rank draws its block
        from ``rank_seed(seed, rank)``. Only for an engine that draws its
        own increments (an injected one swaps them with
        ``set_increments``)."""
        if self.injected:
            raise ValueError(
                "engine was built with injected increments; use "
                "set_increments to swap its realization")
        self.seed = int(seed)
        self.increments = None              # the old block goes first
        self.increments = self._draw(self.seed)

    # ------------------------------------------------------------------
    def set_increments(self, inc) -> None:
        """Swap the injected realization for another of the same shape and
        dtype (NumPy or tensor), in place: everything built on the engine's
        ``increments`` (a kernel backend's realization 0, for one) prices
        the new paths. Only for an engine built with ``increments=``; under
        a mesh ``inc`` is the global array and each rank keeps its
        block."""
        if not self.injected:
            raise ValueError(
                "engine was built without injected increments; build with "
                "increments= to use realization swapping")
        new = torch.as_tensor(getattr(inc, "increments", inc))
        if tuple(new.shape) != self._inc_shape:
            raise ValueError(
                f"replacement increments shape {tuple(new.shape)} != "
                f"engine's {self._inc_shape}")
        if new.dtype != self._inc_dtype:
            raise ValueError(
                f"replacement increments dtype {new.dtype} != engine's "
                f"{self._inc_dtype}")
        self.increments.copy_(
            new[:self.increments.shape[0], :, self._block])

    def _params(self, params) -> torch.Tensor:
        x = torch.as_tensor(params, dtype=torch.float64).to(self.device)
        n_params = int(self.model.covariance.n_params)
        if x.shape != (n_params,):
            raise ValueError(f"params shape {tuple(x.shape)} != ({n_params},)")
        return x

    def _event_contrib(self, ev: dict, L: torch.Tensor, N: torch.Tensor,
                       grad_safe: bool = False):
        """Per-path payoff/numeraire of one event's products ``[m_ev,
        paths]`` and 1/numeraire ``[paths]``, float64, non-finite
        contributions zeroed. ``L`` holds the forwards from the exercise
        index on; the bond curve, annuity and payoff are formed in the
        collect dtype. The numeraire is the spot account ``N`` or, under
        the terminal measure, P(T_e, T_n) from the whole live curve.

        ``grad_safe`` (the delta ladders' reverse mode): paths that
        ``adjoint_dead_mask`` flags are zeroed before the bond curve, which
        is formed as exp(cumsum(log r)) so that a row's cotangent reaches
        only rows before it (the JAX package's
        ``bond_ratio_cumprod_adjoint``)."""
        t = self._t
        cd = self.collect_dtype
        terminal = self.model.measure == "terminal"
        e, width = ev["e"], ev["width"]
        rows = L.shape[0] if terminal else width
        Lw = L[:rows].to(cd)                                       # [w, paths]
        d = t["deltas64"][e:e + rows, None].to(cd)
        dead = None
        if grad_safe:
            dead = adjoint_dead_mask(Lw, N, d, spot=not terminal)
            Lw = torch.where(dead[None, :], 0.01, Lw)
            r = 1.0 / (1.0 + d * Lw)
            cp = torch.exp(torch.cumsum(torch.log(torch.clamp_min(r, 1e-30)),
                                        dim=0))
        else:
            cp = torch.cumprod(1.0 / (1.0 + d * Lw), dim=0)        # P(T_e, T_j+1)
        ann = ev["pay_mask"].to(cd) @ cp[:width]                   # [m_ev, paths]
        p_end = cp[ev["end"]]
        payoff = torch.clamp_min(
            1.0 - p_end - ev["strike"].to(cd)[:, None] * ann, 0.0)
        if terminal:
            inv_n = 1.0 / cp[-1].to(torch.float64)                 # 1/P(T_e, T_n)
        else:
            Nv = N.to(torch.float64)
            if dead is not None:
                # a safe primal before the reciprocal: d(1/N)/dN stays
                # finite on dead paths
                Nv = torch.where(dead, 1.0, Nv)
            inv_n = 1.0 / Nv
        contrib = payoff.to(torch.float64) * inv_n[None, :]
        if dead is not None:
            contrib = torch.where(dead[None, :], 0.0, contrib)
            inv_n = torch.where(dead, 0.0, inv_n)
        contrib = torch.where(torch.isfinite(contrib), contrib, 0.0)
        inv_safe = torch.where(torch.isfinite(inv_n), inv_n, 0.0)
        return contrib, inv_safe

    def _collect(self, ev: dict, L: torch.Tensor, N: torch.Tensor,
                 grad_safe: bool = False):
        """Path sums of payoff/numeraire for one event's products [m_ev]
        and of 1/numeraire [], float64."""
        contrib, inv_safe = self._event_contrib(ev, L, N, grad_safe)
        return contrib.sum(dim=-1), inv_safe.sum()

    def exercise_step_of(self, e: int) -> int:
        """Simulation step index whose start time is tenor point T_e."""
        return int(np.argmin(np.abs(self.model.sim_times
                                    - self.model.tenor_times[e])))

    def _simulate_collect(self, params: torch.Tensor, collect, fwd0=None,
                          grad_safe: bool = False, step_hook=None) -> list:
        """Run the simulation once and apply ``collect(e, ev, L, N)`` at
        every exercise step, before that step's accrual and evolution;
        return the outputs per event, in event order (``ev`` is the
        event's ordinal, ``e`` its tenor index).

        The contract for ``L``, on any simulation grid that refines the
        tenor grid: forward i evolves during the steps that start before
        T_i only, so the state is the live block of the forwards not fixed
        before the step's start; a step that starts at T_m holds L_m as its
        first row (it has just fixed: it accrues the spot numeraire and is
        read by the step's collection) and drops it after. Nothing needs a
        fixed row again. So ``collect`` gets the rows from the exercise
        index on: ``L[j]`` is forward ``e + j`` at T_e, ``[n - e, paths]``
        in the path dtype. ``N`` is the spot numeraire N(T_e) in the
        collect dtype ``[paths]`` (ones under the terminal measure). (The
        JAX engine passes the full ``[n, paths]`` curve and the collectors
        index it absolutely.) Nothing is simulated after the last event.

        ``fwd0``: initial forwards ``[n]`` (a float64 tensor, the delta
        ladders' differentiation point) in place of the model's; the
        blended local-vol anchor ``L0`` moves with them. ``grad_safe``:
        floor the drift's accrual denominator |1 + delta L| at 1e-4 and
        clip the log-Euler exponent to +-88, both identity on every path
        the valuation keeps; for the reverse-mode ladders only.

        ``step_hook``: called once per simulated step ``s``, after its
        accrual and evolution, as ``step_hook(s, N_old, N_new, dw)``:
        the numeraire at the step's start and after its accrual (the
        collect dtype, ``[paths]``) and the step's increments
        ``self.increments[s]`` ``[F', paths]``. A state carried beside the
        rates (the hybrid's assets) evolves there; the collection still
        sees the state after the steps before the event. The hook changes
        nothing the engine computes."""
        t, tp = self._t, self._p
        cov = self.model.covariance
        n, F = self.model.num_libors, self.num_factors
        paths = self._local_paths
        dtype, cd = self.dtype, self.collect_dtype
        spot = self.model.measure == "spot"
        lognormal = self.model.state_space == "lognormal"
        corrector = self.scheme == "predictor_corrector"
        prep = cov.prepare(params)
        vol = cov.vol_table(prep).to(dtype)                        # [S, n]
        if vol.shape[-2] != self.num_steps:
            raise ValueError(
                f"covariance vol table has {vol.shape[-2]} steps, the "
                f"simulation grid has {self.num_steps}: build the "
                "covariance model on the model's simulation time "
                "discretization")
        R = cov.factor_matrix(prep).to(dtype)                      # [n, F]
        L0 = (tp["L0"] if fwd0 is None else fwd0.to(dtype))[:, None].expand(
            n, paths)
        d_col = tp["deltas"][:, None]
        L = L0                                                     # rows r..n-1
        N = torch.ones(paths, dtype=cd, device=self.device)
        if self.stoch_vol:
            # nu and rho enter in the path dtype, V and its step in the
            # collect dtype (the JAX engine's choice: one downcast of V per
            # step instead of a float32 product of exponentials)
            nu, rho = (torch.as_tensor(p, dtype=torch.float64,
                                       device=self.device).to(dtype).to(cd)
                       for p in cov.stoch_vol_params(prep))
            somega = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 1e-12))
            exponent = getattr(cov, "scaling_exponent", 0.5)
            martingale = getattr(cov, "martingale_correction", True)
            V = torch.ones(paths, dtype=cd, device=self.device)

        def drift(Lx, lam, d):
            """finmath's measure drift: spot, the prefix sum over live
            j <= i; terminal, minus the suffix sum over j > i; lognormal
            with the L_j numerator and the Ito term."""
            denom = 1.0 + d * Lx
            if grad_safe:
                floor = torch.full_like(denom, 1e-4)
                denom = torch.where(torch.abs(denom) < 1e-4,
                                    torch.where(denom < 0, -floor, floor),
                                    denom)
            mt = d / denom
            if lognormal:
                mt = mt * Lx
            c = mt[:, None, :] * lam
            if spot:
                acc = torch.cumsum(c, dim=0)                       # incl. own
            else:
                suffix = torch.flip(torch.cumsum(torch.flip(c, (0,)), dim=0),
                                    (0,))
                acc = -(suffix - c)                                # excl. own
            mu = torch.sum(lam * acc, dim=1)
            if lognormal:
                mu = mu - 0.5 * torch.sum(lam * lam, dim=1)
            return mu

        def evolve(Lx, mu, diffusion, dt):
            if lognormal:
                arg = mu * dt + diffusion
                if grad_safe:
                    arg = torch.clamp(arg, -88.0, 88.0)
                new = Lx * torch.exp(arg)
            else:
                new = Lx + mu * dt + diffusion
            # float32 guard: rates beyond +-1000 carry no price information
            return torch.clamp(new, -1e3, 1e3)

        outs = []
        events = iter(zip(self._event_steps, enumerate(self.exercise_indices)))
        s_e, (j, e) = next(events)
        r = 0                                          # first row of the block
        for s in range(self.steps_needed + 1):
            if s == s_e:
                outs.append(collect(e, j, L, N))
                s_e, (j, e) = next(events, (None, (None, None)))
                if e is None:
                    break
            m = self._fixing[s]
            N_old = N
            if spot and m >= 0:
                # spot account accrues period m at its fixing L_m
                N = N * (1.0 + tp["deltas"][m] * L[m - r]).to(cd)
            a = self._alive_from[s]
            La = L[a - r:]                                         # rows a..
            if self.stoch_vol:
                Vc = V.to(dtype)
                scale = (Vc if exponent == 1.0 else torch.sqrt(Vc)
                         if exponent == 0.5 else Vc ** exponent)

            def loadings(Lx):
                lam = vol[s, a:, None]                             # [n', 1]
                if cov.has_local_vol:
                    lam = lam * cov.local_factor(prep, Lx, L0[a:])
                if self.stoch_vol:
                    lam = lam * scale
                return lam[:, None, :] * R[a:, :, None]            # [n', F, .]

            lam = loadings(La)
            d = d_col[a:]
            mu = drift(La, lam, d)
            dw = self.increments[s]                                # [F', paths]
            diffusion = torch.sum(lam * dw[None, :F], dim=1)
            if corrector:
                L_pred = evolve(La, mu, diffusion, tp["dts"][s])
                mu = 0.5 * (mu + drift(L_pred, loadings(L_pred), d))
            L = evolve(La, mu, diffusion, tp["dts"][s])
            r = a
            if self.stoch_vol:
                dw_v = rho * dw[0].to(cd) + somega * dw[F].to(cd)
                arg = nu * dw_v
                if martingale:
                    arg = arg - 0.5 * nu * nu * tp["dts"][s].to(cd)
                # the same overflow guard for the scaling process
                V = torch.clamp_max(V * torch.exp(arg), 1e6)
            if step_hook is not None:
                step_hook(s, N_old, N, dw)
        return outs

    def _local_sums(self, params: torch.Tensor, fwd0=None,
                    grad_safe: bool = False) -> torch.Tensor:
        """This rank's path sums ``[P + E]`` float64: payoff / numeraire
        per product, then 1 / numeraire per exercise event."""
        raws, invs = zip(*self._simulate_collect(
            params, lambda e, j, L, N: self._collect(self._events[j], L, N,
                                                     grad_safe),
            fwd0=fwd0, grad_safe=grad_safe))
        return torch.cat(raws + (torch.stack(invs),))

    def _values(self, params: torch.Tensor, fwd0=None,
                grad_safe: bool = False) -> torch.Tensor:
        """Monte-Carlo values [P] (terminal scale and numeraire adjustment
        applied). With ``fwd0`` the terminal P(0, T_n) is formed from it,
        so it differentiates too. Under a mesh the sums are all-reduced in
        between, and reverse mode gives every rank the full gradient of
        ``params`` and ``fwd0`` (``parallel.mesh.replicated``)."""
        if self.mesh is None:
            return self._from_sums(
                self._local_sums(params, fwd0, grad_safe), fwd0)
        mesh = self.mesh

        def local(x):
            return replicated(x, mesh) if x.requires_grad else x

        sums = self._local_sums(local(params),
                                None if fwd0 is None else local(fwd0),
                                grad_safe)
        return self._from_sums(sum_over_ranks(sums, mesh), fwd0)

    def _from_sums(self, sums: torch.Tensor, fwd0=None) -> torch.Tensor:
        """Values [P] from the path sums over every path ``[P + E]``."""
        t = self._t
        paths = self.num_paths
        P = len(self.products)
        raw = sums[:P] / paths                                     # [P]
        terminal = self.model.measure == "terminal"
        if terminal:
            p0 = self._p0_terminal if fwd0 is None else torch.prod(
                1.0 / (1.0 + t["deltas64"] * fwd0))
            raw = raw * p0
        if not self.model.use_numeraire_adjustment:
            return raw
        mean_inv = sums[P:][t["ev_of"]] / paths                    # [P]
        if terminal:
            mean_inv = mean_inv * p0
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

    def _residuals_from_sums(self, sums: torch.Tensor) -> torch.Tensor:
        t = self._t
        return t["weight"] * (self._quotes(self._from_sums(sums))
                              - t["target"])

    def _local_sums_and_jacobian(self, x: torch.Tensor):
        """This rank's sums ``[P + E]`` and their forward-mode Jacobian
        ``[P + E, n_params]``, from one pass."""
        def sums(p):
            s = self._local_sums(p)
            return s, s

        J, s = jacfwd(sums, has_aux=True)(x)
        return s, J

    def _meshed_jacobian(self, S: torch.Tensor, J_s: torch.Tensor,
                         batched: bool) -> torch.Tensor:
        """The residual Jacobian from local sums and their Jacobian (a
        leading batch axis when ``batched``): ONE all-reduce of both
        together, then the chain rule through the replicated rest; no
        collective runs inside a transform."""
        both = self.mesh.all_reduce(torch.cat([S[..., None], J_s], dim=-1))
        S, J_s = both[..., 0], both[..., 1:]
        post = jacfwd(self._residuals_from_sums)
        return torch.matmul(vmap(post)(S) if batched else post(S), J_s)

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
        whole simulation (under a mesh: of the local sums, all-reduced,
        then the chain rule through the replicated rest)."""
        x = self._params(params)
        if self.mesh is None:
            return jacfwd(self._residuals)(x).cpu().numpy()
        return self._meshed_jacobian(*self._local_sums_and_jacobian(x),
                                     batched=False).cpu().numpy()

    def pathwise_values(self, params) -> np.ndarray:
        """Per-path value contributions ``[P, paths]`` float64, whose row
        means are ``values(params)`` (terminal scale and numeraire
        adjustment included): the decomposition behind the f32-vs-f64
        parity check, where the paths that decorrelate between the two
        precisions are found by their contribution gap. Holds ``[P,
        paths]`` float64 on the device. Single-device: raises under a
        mesh."""
        if self.mesh is not None:
            raise ValueError("pathwise_values is a single-device diagnostic")
        t = self._t
        contribs, invs = zip(*self._simulate_collect(
            self._params(params),
            lambda e, j, L, N: self._event_contrib(self._events[j], L, N)))
        contrib = torch.cat(contribs)                              # [P, paths]
        mean_inv = torch.stack(invs).mean(dim=-1)[t["ev_of"]]      # [P]
        if self.model.measure == "terminal":
            contrib = contrib * self._p0_terminal
            mean_inv = mean_inv * self._p0_terminal
        if self.model.use_numeraire_adjustment:
            adj = torch.where(mean_inv > 0.0, t["df_ex"] / mean_inv, 0.0)
            contrib = contrib * adj[:, None]
        return contrib.cpu().numpy()

    # ------------------------------------------------------------------
    # delta ladders: reverse mode through the whole sweep with respect to
    # the initial forwards (measure drift, local-vol anchor, stochastic-vol
    # scaling, payoff, numeraire). Held fixed, as in the JAX package: the
    # product definitions and the numeraire adjustment's discount factors;
    # the terminal P(0, T_n) is differentiated. Autograd keeps every
    # step's block for the backward sweep.
    def _delta_inputs(self, params):
        x = self._params(params)
        fwd0 = torch.as_tensor(np.asarray(self.model.initial_forwards,
                                          dtype=np.float64),
                               device=self.device).requires_grad_(True)
        return x, fwd0

    def forward_deltas(self, params, weights=None):
        """Bucketed delta ladder of the (weighted) product portfolio:
        ``(portfolio value, dV/dL0 [num_libors])`` from one forward and one
        backward sweep. ``weights`` defaults to one of each product."""
        x, fwd0 = self._delta_inputs(params)
        w = torch.as_tensor(
            np.ones(len(self.products)) if weights is None
            else np.asarray(weights, dtype=np.float64),
            dtype=torch.float64, device=self.device)
        with torch.enable_grad():
            total = torch.sum(w * self._values(x, fwd0=fwd0, grad_safe=True))
            (grad,) = torch.autograd.grad(total, fwd0)
        return float(total.detach()), grad.cpu().numpy()

    def forward_delta_matrix(self, params) -> np.ndarray:
        """Per-product delta ladder ``[P, num_libors]``: one forward sweep
        and P backward sweeps through its graph. Use ``forward_deltas`` (one
        backward sweep) for portfolio risk at production path counts."""
        x, fwd0 = self._delta_inputs(params)
        with torch.enable_grad():
            v = self._values(x, fwd0=fwd0, grad_safe=True)
            P = v.shape[0]
            rows = [torch.autograd.grad(v[k], fwd0, retain_graph=k < P - 1)[0]
                    for k in range(P)]
        return torch.stack(rows).cpu().numpy()

    # ------------------------------------------------------------------
    # batched evaluation: B parameter sets in one evaluation, vmap over
    # the residual function (and over its forward-mode Jacobian); used by
    # BatchedLevenbergMarquardt in the lockstep multistart
    def _params_batch(self, params_batch) -> torch.Tensor:
        X = torch.as_tensor(params_batch, dtype=torch.float64).to(self.device)
        n_params = int(self.model.covariance.n_params)
        if X.dim() != 2 or X.shape[1] != n_params:
            raise ValueError(f"parameter sets of shape {tuple(X.shape)}, "
                             f"expected [B, {n_params}]")
        return X

    def residuals_batched(self, params_batch) -> np.ndarray:
        """Residuals for a ``[B, n_params]`` batch -> ``[B, P]``."""
        X = self._params_batch(params_batch)
        if self.mesh is None:
            return vmap(self._residuals)(X).cpu().numpy()
        S = self.mesh.all_reduce(vmap(self._local_sums)(X))
        return vmap(self._residuals_from_sums)(S).cpu().numpy()

    def jacobian_batched(self, params_batch) -> np.ndarray:
        """Jacobians for a ``[B, n_params]`` batch -> ``[B, P, n_params]``."""
        X = self._params_batch(params_batch)
        if self.mesh is None:
            return vmap(jacfwd(self._residuals))(X).cpu().numpy()
        return self._meshed_jacobian(
            *vmap(self._local_sums_and_jacobian)(X),
            batched=True).cpu().numpy()

    @property
    def targets(self) -> np.ndarray:
        return np.asarray(self._target)
