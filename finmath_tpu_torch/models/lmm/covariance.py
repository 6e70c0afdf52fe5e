"""LIBOR covariance models: piecewise-constant volatility, exponential-decay
correlation with factor reduction, the 5-parameter exponential form, and
the displaced, blended and stochastic-volatility wrappers — the covariance
stacks of the reference's ATM calibration
(LIBORMarketModelCalibrationATMTest.java:287-294) and of its stoch-vol
benchmark calibration (LIBORMarketModelCalibrationTest.java:269-275).

Counterpart of ``finmath_tpu.models.lmm.covariance``. Everything static
(the bucket map, the eigen-reduced factor matrix of a fixed correlation)
is built with NumPy at construction exactly as in the JAX package; the only
run-time input is the float64 parameter vector, and ``vol_table`` /
``factor_matrix`` / ``local_factor`` / ``stoch_vol_params`` are plain
tensor functions of it, differentiable by ``torch.func.jacfwd``.
Parameters may carry leading batch dimensions (``[..., n_params]``), which
the tables keep.
"""

from __future__ import annotations

import numpy as np
import torch

from ..time_discretization import TimeDiscretization


def _bucket_index(grid: np.ndarray, t: float) -> int:
    """Index of the greatest grid point <= t (finmath
    getTimeIndexNearestLessOrEqual semantics)."""
    return int(np.clip(np.searchsorted(grid, t + 1e-12) - 1, 0, len(grid) - 1))


class _DeviceTables:
    """NumPy tables with one tensor copy per device, made on first use."""

    def __init__(self, **arrays: np.ndarray):
        self._np = arrays
        self._on: dict = {}

    def on(self, device: torch.device) -> dict:
        tables = self._on.get(device)
        if tables is None:
            tables = {k: torch.as_tensor(v, device=device)
                      for k, v in self._np.items()}
            self._on[device] = tables
        return tables


class LIBORVolatilityModelPiecewiseConstant:
    """sigma_i(t) piecewise constant in (simulation-time bucket,
    time-to-maturity bucket) — ref. LIBORVolatilityModelPiecewiseConstant
    with grids {0,1,2,5,10,20,30,40} x {0,1,2,5,10,20,30,40} and initial
    volatility 0.50/100 (ATM test :287).

    Only (time, ttm) buckets actually reachable on the simulation/tenor
    grids get a parameter; ``n_params`` is the calibration dimension.
    """

    def __init__(self, simulation_td: TimeDiscretization,
                 libor_td: TimeDiscretization,
                 time_grid: np.ndarray, maturity_grid: np.ndarray,
                 initial_volatility: float = 0.005,
                 is_calibrateable: bool = True):
        self.simulation_td = simulation_td
        self.libor_td = libor_td
        self.time_grid = np.asarray(time_grid, dtype=np.float64)
        self.maturity_grid = np.asarray(maturity_grid, dtype=np.float64)
        self.is_calibrateable = is_calibrateable

        n_steps = simulation_td.get_number_of_time_steps()
        n_libor = libor_td.get_number_of_time_steps()

        # map each (simulation step m, libor index i) to a parameter bucket
        bucket_of = {}
        bucket_matrix = np.zeros((n_steps, n_libor), dtype=np.int64)
        alive = np.zeros((n_steps, n_libor), dtype=bool)
        for m in range(n_steps):
            t = simulation_td.get_time(m)
            for i in range(n_libor):
                T_i = libor_td.get_time(i)
                ttm = T_i - t
                if ttm <= 0:
                    continue  # forward already fixed; masked
                tb = _bucket_index(self.time_grid, t)
                mb = _bucket_index(self.maturity_grid, ttm)
                key = (tb, mb)
                if key not in bucket_of:
                    bucket_of[key] = len(bucket_of)
                bucket_matrix[m, i] = bucket_of[key]
                alive[m, i] = True

        self.n_params = len(bucket_of)
        self._tables = _DeviceTables(bucket=bucket_matrix, alive=alive)
        self.initial_parameters = np.full(self.n_params, float(initial_volatility))

    def vol_table(self, params: torch.Tensor) -> torch.Tensor:
        """``[..., n_steps, n_libor]`` volatility table for parameter
        vector(s) ``params`` ``[..., n_params]`` (0 where the forward is
        already fixed)."""
        t = self._tables.on(params.device)
        return torch.where(t["alive"], params[..., t["bucket"]], 0.0)


class LIBORCorrelationModelExponentialDecay:
    """rho_ij = exp(-a |T_i - T_j|), reduced to ``num_factors`` factors by
    eigendecomposition with row renormalization — ref.
    LIBORCorrelationModelExponentialDecay(td, liborTd, factors, 0.05, false)
    (ATM test :288). ``a`` is fixed (isCalibrateable=false there)."""

    def __init__(self, libor_td: TimeDiscretization, num_factors: int,
                 decay: float = 0.05):
        self.libor_td = libor_td
        self.num_factors = int(num_factors)
        self.decay = float(decay)

        times = np.asarray([libor_td.get_time(i)
                            for i in range(libor_td.get_number_of_time_steps())])
        corr = np.exp(-self.decay * np.abs(times[:, None] - times[None, :]))
        # factor reduction: top-F eigenpairs, rows renormalized to unit norm
        w, v = np.linalg.eigh(corr)
        idx = np.argsort(w)[::-1][: self.num_factors]
        F = v[:, idx] * np.sqrt(np.maximum(w[idx], 0.0))[None, :]
        norms = np.linalg.norm(F, axis=1, keepdims=True)
        F = F / np.where(norms > 0, norms, 1.0)
        self._tables = _DeviceTables(factors=F.astype(np.float64))

    def factor_matrix(self, device: torch.device) -> torch.Tensor:
        """[n_libor, F] float64 on ``device``."""
        return self._tables.on(device)["factors"]


#: The first-row sign of each of the first five eigen-reduced factors. The
#: JAX package keeps its eigensolver's signs, which are arbitrary: under
#: LAPACK the dominant factor's sign flips as the decay moves (between
#: |e| = 0.089 and 0.15 at 40 libors), and the TPU's solver gives other
#: signs again. The V driver correlates with factor 0, so its sign is the
#: sign of the rate-volatility correlation. These are the signs under
#: which the port's engine, on the reference's Mersenne paths, reproduces
#: the JAX package's recorded TPU scores of the curated basins 0 and 2
#: (all 32 patterns were scored). They were fitted at five factors; a
#: model with fewer takes the leading ones (the same eigenvectors).
FACTOR_SIGNS = (1.0, 1.0, -1.0, -1.0, 1.0)


def factor_reduce(corr: torch.Tensor, num_factors: int) -> torch.Tensor:
    """Differentiable factor reduction: top-F eigenpairs of correlation
    matrices ``[..., n, n]``, rows renormalized to unit norm. Returns
    ``[..., n, F]``, columns by DESCENDING eigenvalue like finmath's
    LinearAlgebra.factorReduction: factor 0 is the dominant (level)
    factor, the one the stochastic-vol driver correlates with.

    Each column's sign is fixed by its first row (the first libor), which
    makes the model a continuous function of the decay: ``FACTOR_SIGNS``
    for the first five factors, positive beyond them (a convention that
    no run has tested). The first row of an eigenvector of this
    Kac-Murdock-Szego matrix is never zero, so the rule is well-defined."""
    w, v = torch.linalg.eigh(corr)                           # ascending
    w_top = w[..., -num_factors:].flip(-1)
    v_top = v[..., :, -num_factors:].flip(-1)
    F = v_top * torch.sqrt(torch.clamp_min(w_top, 0.0))[..., None, :]
    norms = torch.linalg.vector_norm(F, dim=-1, keepdim=True)
    F = F / torch.where(norms > 0, norms, 1.0)
    signs = torch.tensor((FACTOR_SIGNS + (1.0,) * num_factors)[:num_factors],
                         dtype=F.dtype, device=F.device)
    return F * torch.where(F[..., :1, :] * signs < 0, -1.0, 1.0)


class LIBORCovarianceModelFromVolatilityAndCorrelation:
    """lambda_{i,f}(t) = sigma_i(t) * R_{i,f} — ref.
    LIBORCovarianceModelFromVolatilityAndCorrelation (ATM test :291).

    Covariance API consumed by the valuation engine:

    * ``prepare(params)``               -> opaque ``prep`` (once per
                                           parameter vector)
    * ``vol_table(prep)``               -> [..., steps, libors] scalar vols
    * ``factor_matrix(prep)``           -> [libors, F]
    * ``local_factor(prep, L, L0)``     -> [libors, paths] multiplier
    * ``stoch_vol_params(prep)``        -> (nu, rho) or None
    """

    has_local_vol = False
    has_stoch_vol = False

    def __init__(self, volatility_model: LIBORVolatilityModelPiecewiseConstant,
                 correlation_model: LIBORCorrelationModelExponentialDecay):
        self.volatility_model = volatility_model
        self.correlation_model = correlation_model
        self.n_params = volatility_model.n_params
        self.initial_parameters = volatility_model.initial_parameters
        self.num_factors = correlation_model.num_factors

    # -- covariance API ---------------------------------------------------
    def prepare(self, params: torch.Tensor):
        return params

    def vol_table(self, prep) -> torch.Tensor:
        return self.volatility_model.vol_table(prep)

    def factor_matrix(self, prep) -> torch.Tensor:
        return self.correlation_model.factor_matrix(prep.device)

    def local_factor(self, prep, L: torch.Tensor, L0: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(L)

    def stoch_vol_params(self, prep):
        return None


class _CovarianceWrapper(LIBORCovarianceModelFromVolatilityAndCorrelation):
    """Base for wrappers that delegate the covariance API to a wrapped
    model, possibly appending their own calibration parameters."""

    def __init__(self, base, extra_params: np.ndarray):
        self.base = base
        self.num_factors = base.num_factors
        self._n_extra = len(extra_params)
        self.n_params = base.n_params + self._n_extra
        self.initial_parameters = np.concatenate(
            [base.initial_parameters, np.asarray(extra_params, dtype=np.float64)]
        )

    def _split(self, params):
        if self._n_extra == 0:
            return params, params[..., :0]
        return params[..., : -self._n_extra], params[..., -self._n_extra:]

    def prepare(self, params):
        base_params, extra = self._split(params)
        return (self.base.prepare(base_params), extra)

    def vol_table(self, prep):
        return self.base.vol_table(prep[0])

    def factor_matrix(self, prep):
        return self.base.factor_matrix(prep[0])

    def local_factor(self, prep, L, L0):
        return self.base.local_factor(prep[0], L, L0)

    def stoch_vol_params(self, prep):
        return self.base.stoch_vol_params(prep[0])

    @property
    def has_local_vol(self):
        return self.base.has_local_vol

    @property
    def has_stoch_vol(self):
        return self.base.has_stoch_vol

    def __getattr__(self, name):
        # the stoch-vol simulation settings live on the (possibly nested)
        # stochastic-vol model; delegate inward so the engine reads them
        # from the outermost wrapper whatever the nesting order
        if name in ("scaling_exponent", "martingale_correction"):
            base = self.__dict__.get("base")
            if base is not None:
                return getattr(base, name)
        raise AttributeError(name)


class DisplacedLocalVolatilityModel(_CovarianceWrapper):
    """Displaced diffusion: loadings scaled by (L_i + d) — ref.
    DisplacedLocalVolatilityModel(cov, 1/0.25, isCalibrateable=false)
    (ATM test :294). With NORMAL state space this makes the model
    near-lognormal in (L + d)."""

    has_local_vol = True

    def __init__(self, base, displacement: float, is_calibrateable: bool = False):
        extra = [displacement] if is_calibrateable else []
        super().__init__(base, np.asarray(extra))
        self._fixed_displacement = None if is_calibrateable else float(displacement)

    def local_factor(self, prep, L, L0):
        base_prep, extra = prep
        d = self._fixed_displacement if self._fixed_displacement is not None \
            else extra[..., 0].to(L.dtype)
        return (L + d) * self.base.local_factor(base_prep, L, L0)


class BlendedLocalVolatilityModel(_CovarianceWrapper):
    """Blended (lognormal/normal mix) local volatility: loadings scaled by
    (b L_i(0) + (1-b) L_i(t)) — finmath BlendedLocalVolatilityModel used by
    the benchmark test (LIBORMarketModelCalibrationTest.java:271-273,
    b=0.2, calibrateable). ``b`` is taken in the dtype of ``L``, as in the
    JAX package."""

    has_local_vol = True

    def __init__(self, base, blend: float, is_calibrateable: bool = True):
        extra = [blend] if is_calibrateable else []
        super().__init__(base, np.asarray(extra))
        self._fixed_blend = None if is_calibrateable else float(blend)

    def local_factor(self, prep, L, L0):
        base_prep, extra = prep
        b = self._fixed_blend if self._fixed_blend is not None \
            else extra[..., 0].to(L.dtype)
        return ((1.0 - b) * L + b * L0) * self.base.local_factor(base_prep, L, L0)


class LIBORCovarianceModelExponentialForm5Param(
    LIBORCovarianceModelFromVolatilityAndCorrelation
):
    """5-parameter covariance: sigma_i(t) = (a + b ttm) exp(-c ttm) + d,
    floored at 0, correlation rho_ij = exp(-|e| |T_i - T_j|) factor-reduced
    — ref. LIBORCovarianceModelExponentialForm5Param(td, liborTd, 5
    factors, {0.20, 0.05, 0.10, 0.05, 0.10}) (benchmark test :269). All
    five parameters are calibrateable; the factor reduction is part of the
    differentiable function. The decay enters as |e| (finmath clamps a
    negative decay to 0, whose zero gradient strands a calibration; the
    JAX package mirrors instead, and so does the port)."""

    has_local_vol = False
    has_stoch_vol = False

    def __init__(self, simulation_td: TimeDiscretization,
                 libor_td: TimeDiscretization, num_factors: int,
                 parameters=(0.20, 0.05, 0.10, 0.05, 0.10)):
        self.simulation_td = simulation_td
        self.libor_td = libor_td
        self.num_factors = int(num_factors)
        self.n_params = 5
        self.initial_parameters = np.asarray(parameters, dtype=np.float64)

        n_steps = simulation_td.get_number_of_time_steps()
        n_libor = libor_td.get_number_of_time_steps()
        t = np.asarray([simulation_td.get_time(m) for m in range(n_steps)])
        T = np.asarray([libor_td.get_time(i) for i in range(n_libor)])
        ttm = T[None, :] - t[:, None]                     # [steps, libors]
        self._tables = _DeviceTables(
            ttm=np.maximum(ttm, 0.0), alive=ttm > 0,
            tenor_dist=np.abs(T[:, None] - T[None, :]))

    def prepare(self, params):
        t = self._tables.on(params.device)
        a, b, c, d, e = (params[..., k, None, None] for k in range(5))
        vol = (a + b * t["ttm"]) * torch.exp(-c * t["ttm"]) + d
        vol = torch.where(t["alive"], torch.clamp_min(vol, 0.0), 0.0)
        corr = torch.exp(-torch.abs(e) * t["tenor_dist"])
        return (vol, factor_reduce(corr, self.num_factors))

    def vol_table(self, prep):
        return prep[0]

    def factor_matrix(self, prep):
        return prep[1]


class LIBORCovarianceModelStochasticVolatility(_CovarianceWrapper):
    """Stochastic volatility scaling — ref.
    LIBORCovarianceModelStochasticVolatility(cov, brownianMotionView2,
    nu=0.15, rho=0.20, calibrateable) (benchmark test :275).

    A scalar scaling process V(t), V(0) = 1, simulated with the lognormal
    step V *= exp(nu dW_V - nu^2 dt / 2) (without the drift when
    ``martingale_correction`` is False), dW_V = rho dW_0 + sqrt(1-rho^2)
    dW_extra: the driver correlates with the FIRST (dominant) rate factor
    and consumes one additional Brownian factor. Factor loadings at step t
    are multiplied by V(t)**scaling_exponent: 0.5 (default, E[scale^2] = 1
    at every horizon) or 1.0 (finmath's direct scaling)."""

    has_stoch_vol = True

    def __init__(self, base, nu: float = 0.15, rho: float = 0.20,
                 is_calibrateable: bool = True,
                 scaling_exponent: float = 0.5,
                 martingale_correction: bool = True):
        extra = [nu, rho] if is_calibrateable else []
        super().__init__(base, np.asarray(extra))
        self._fixed = None if is_calibrateable else (float(nu), float(rho))
        self.scaling_exponent = float(scaling_exponent)
        self.martingale_correction = martingale_correction

    def stoch_vol_params(self, prep):
        base_prep, extra = prep
        if self._fixed is not None:
            return self._fixed
        return (extra[..., 0], extra[..., 1])
