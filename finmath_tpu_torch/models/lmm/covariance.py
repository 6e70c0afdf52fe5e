"""LIBOR covariance models: piecewise-constant volatility, exponential-decay
correlation with factor reduction, and the displaced local-volatility
wrapper — the covariance stack of the reference's ATM calibration
(LIBORMarketModelCalibrationATMTest.java:287-294).

Counterpart of ``finmath_tpu.models.lmm.covariance``. Everything static
(the bucket map, the eigen-reduced factor matrix) is built with NumPy at
construction exactly as in the JAX package; the only run-time input is the
float64 parameter vector, and ``vol_table`` / ``factor_matrix`` /
``local_factor`` are plain tensor functions of it, differentiable by
``torch.func.jacfwd``. Parameters may carry leading batch dimensions
(``[..., n_params]``), which the tables keep.

The blended, 5-parameter and stochastic-volatility wrappers come with the
stoch-vol calibration.
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


class LIBORCovarianceModelFromVolatilityAndCorrelation:
    """lambda_{i,f}(t) = sigma_i(t) * R_{i,f} — ref.
    LIBORCovarianceModelFromVolatilityAndCorrelation (ATM test :291).

    Covariance API consumed by the valuation engine:

    * ``prepare(params)``               -> opaque ``prep`` (once per
                                           parameter vector)
    * ``vol_table(prep)``               -> [..., steps, libors] scalar vols
    * ``factor_matrix(prep)``           -> [libors, F]
    * ``local_factor(prep, L, L0)``     -> [libors, paths] multiplier
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

    @property
    def has_local_vol(self):
        return self.base.has_local_vol

    @property
    def has_stoch_vol(self):
        return self.base.has_stoch_vol


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
