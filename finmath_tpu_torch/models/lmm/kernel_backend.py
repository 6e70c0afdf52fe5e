"""Kernel-backed residuals and Jacobian for the ATM surface calibration.

Counterpart of ``finmath_tpu.models.lmm.kernel_backend.ATMKernelCalibration``:
the NORMAL-state-space multi-factor LMM without stochastic volatility
(optionally displaced), every calibration swaption plus one
numeraire-adjustment row per exercise event collected in ONE path sweep of
``ops.lmm_kernel.lmm_atm_swaptions_batch`` (the CUDA kernel on a CUDA
device, its plain version on the CPU).

* ``residuals(x)`` — one launch at B = 1; the float64 reduction, the
  numeraire adjustment df(T_e) / E[1/N(T_e)] and the Bachelier inversion
  follow on the engine's device.
* ``jacobian(x)`` — central finite differences under common random
  numbers: ONE launch over 2 * n_params + 1 parameter sets sharing the
  engine's realization.

The backend prices the engine's own paths: it reads the engine's
device-resident increments directly (``[S, F, paths]``, already scaled by
sqrt(dt), passed with ``sqrt_dt = 1``), so kernel and engine agree to the
float32-collection envelope with no second draw.

Scope guards in ``__init__`` pin the kernel's hard-coded dynamics to the
engine's configuration and fail loudly otherwise (the engine itself is
single-device, plain Monte Carlo). The stoch-vol backend
comes with the stoch-vol calibration.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.lmm_kernel import lmm_atm_swaptions_batch
from .model import LMMValuationEngine, bachelier_implied_vol

FD_STEP = 5e-4      # absolute central-difference step of every parameter


class ATMKernelCalibration:
    """Kernel-path residuals / FD Jacobian matching
    ``LMMValuationEngine.residuals`` semantics (same products, targets,
    weights, numeraire adjustment and implied-vol inversion)."""

    def __init__(self, engine: LMMValuationEngine):
        model = engine.model
        cov = model.covariance
        if model.measure != "spot" or model.state_space != "normal":
            raise ValueError("ATM kernel backend: spot/NORMAL only")
        if cov.has_stoch_vol:
            raise ValueError("ATM kernel backend: no stochastic volatility")
        if engine.value_unit != "VOLATILITYNORMAL":
            raise ValueError("ATM kernel backend: VOLATILITYNORMAL products")
        sim = model.sim_times
        n = model.num_libors
        if len(sim) - 1 != n:
            raise ValueError("ATM kernel backend: sim grid == tenor grid")
        dts = np.diff(sim)
        if not np.allclose(dts, dts[0], atol=1e-12):
            raise ValueError("ATM kernel backend: uniform time step")

        self.engine = engine
        self.device = engine.device
        self.num_paths = engine.num_paths
        self._dt = float(dts[0])
        self._n = n
        self._F = engine.num_factors
        self._n_params = int(cov.n_params)

        self._products = tuple(
            (int(p.exercise_index), int(p.num_periods), float(p.strike))
            for p in engine.products)
        self._num_steps = max(e for e, _, _ in self._products)
        self._P = len(self._products)
        self._events = tuple(int(e) for e in engine.exercise_indices)

        # local-volatility form: none or displaced (L + d), the two ATM
        # variants; the form is verified at the initial parameters, the
        # displacement itself is read per parameter set in _pack
        self._displaced = bool(getattr(cov, "has_local_vol", False))
        if self._displaced:
            prep = cov.prepare(torch.as_tensor(
                np.asarray(cov.initial_parameters, np.float64)))
            z11 = torch.zeros((1, 1), dtype=torch.float64)
            d0 = float(cov.local_factor(prep, z11, z11)[0, 0])
            d1 = float(cov.local_factor(prep, z11 + 1.0, z11)[0, 0])
            dl0 = float(cov.local_factor(prep, z11, z11 + 1.0)[0, 0])
            if abs((d1 - d0) - 1.0) > 1e-9 or abs(dl0 - d0) > 1e-9:
                raise ValueError(
                    "ATM kernel backend supports local factor (L + d) "
                    "(displaced) or none; this covariance is neither")

        t = engine._t
        self._fwd0, self._ann0 = t["fwd0"], t["ann0"]
        self._strike, self._texp = t["strike"], t["texp"]
        self._target, self._weight = t["target"], t["weight"]
        self._df_exercise, self._ev_of = t["df_ex"], t["ev_of"]
        self._use_adjustment = bool(model.use_numeraire_adjustment)
        self._l0 = t["L0"].contiguous()
        self._deltas = t["deltas32"].contiguous()
        # the engine's realization, [S * F, paths] in kernel row order
        inc = engine.increments
        self._z = inc[:self._num_steps].reshape(
            self._num_steps * self._F, self.num_paths)

    # ------------------------------------------------------------------
    def _pack(self, params_b: torch.Tensor):
        """[B, n_params] float64 -> (volT [B, F*n, S], scal [B, 8]) float32."""
        cov = self.engine.model.covariance
        F, n, S = self._F, self._n, self._num_steps
        B = params_b.shape[0]
        prep = cov.prepare(params_b)
        vt = cov.vol_table(prep)[:, :S]                       # [B, S, n]
        R = cov.factor_matrix(prep)                           # [n, F]
        volT = (vt.transpose(1, 2)[:, None, :, :]
                * R.T[None, :, :, None]).reshape(B, F * n, S)
        scal = torch.zeros((B, 8), dtype=torch.float64, device=self.device)
        scal[:, 0] = self._dt
        scal[:, 1] = 1.0           # z is the sqrt(dt)-scaled increment
        if self._displaced:
            # the local factor is elementwise: at L = L0 = 0 it is d per set
            zero = torch.zeros(B, dtype=torch.float64, device=self.device)
            scal[:, 2] = cov.local_factor(prep, zero, zero)
        return (volT.to(torch.float32).contiguous(),
                scal.to(torch.float32).contiguous())

    def kernel_arguments(self, params_b: torch.Tensor):
        """The positional tensors and keyword arguments of the
        ``lmm_atm_swaptions_batch`` call that values the parameter sets
        ``params_b`` [B, n_params] (float64, on the engine's device)."""
        volT_b, scal_b = self._pack(params_b)
        return ((self._z, volT_b, scal_b, self._l0, self._deltas),
                dict(num_libors=self._n, num_factors=self._F,
                     products=self._products, events=self._events,
                     displaced=self._displaced, num_paths=self.num_paths))

    def _values(self, params_b: torch.Tensor) -> torch.Tensor:
        args, kwargs = self.kernel_arguments(params_b)
        sums = lmm_atm_swaptions_batch(*args, **kwargs)            # [B, P+E]
        P, paths = self._P, self.num_paths
        raw = sums[:, :P] / paths
        if not self._use_adjustment:
            return raw
        inv_p = (sums[:, P:] / paths)[:, self._ev_of]              # [B, P]
        return raw * torch.where(inv_p > 0.0, self._df_exercise / inv_p, 0.0)

    def _residuals(self, params_b: torch.Tensor) -> torch.Tensor:
        iv = bachelier_implied_vol(self._values(params_b), self._fwd0,
                                   self._strike, self._texp, self._ann0)
        return self._weight * (iv - self._target)                  # [B, P]

    def fd_parameter_sets(self, params: torch.Tensor):
        """The 2 * n_params + 1 parameter sets of the central-difference
        Jacobian ([x, x + h e_k..., x - h e_k...]) and the steps h."""
        h = torch.full_like(params, FD_STEP)                       # [n_params]
        shift = torch.diag(h)
        return torch.cat([params[None, :], params[None, :] + shift,
                          params[None, :] - shift]), h

    def _residuals_and_jacobian(self, params: torch.Tensor):
        X, h = self.fd_parameter_sets(params)
        r = self._residuals(X)                                     # [2n+1, P]
        k = self._n_params
        J = (r[1:1 + k] - r[1 + k:]) / (2.0 * h[:, None])
        return r[0], J.T

    # ------------------------------------------------------------------
    def params(self, x) -> torch.Tensor:
        """A parameter vector as a float64 tensor on the engine's device."""
        x = torch.as_tensor(x, dtype=torch.float64).to(self.device)
        if x.shape != (self._n_params,):
            raise ValueError(f"params shape {tuple(x.shape)} != ({self._n_params},)")
        return x

    def residuals(self, x) -> np.ndarray:
        return self._residuals(self.params(x)[None, :])[0].cpu().numpy()

    def jacobian(self, x) -> np.ndarray:
        return self._residuals_and_jacobian(self.params(x))[1].cpu().numpy()

    def residuals_and_jacobian(self, x):
        r0, J = self._residuals_and_jacobian(self.params(x))
        return r0.cpu().numpy(), J.cpu().numpy()

    def implied_vols(self, x) -> np.ndarray:
        w = self._weight.cpu().numpy()
        r = self.residuals(x)
        return self._target.cpu().numpy() + np.where(
            w != 0.0, r / np.where(w != 0.0, w, 1.0), 0.0)
