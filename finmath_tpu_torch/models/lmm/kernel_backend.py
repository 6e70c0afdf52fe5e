"""Kernel-backed residuals and Jacobians for the two LMM calibrations.

Counterpart of ``finmath_tpu.models.lmm.kernel_backend``:

* ``ATMKernelCalibration`` — the NORMAL-state-space multi-factor LMM
  without stochastic volatility (optionally displaced), every calibration
  swaption plus one numeraire-adjustment row per exercise event collected
  in ONE path sweep of ``ops.lmm_kernel.lmm_atm_swaptions_batch``;
* ``StochVolKernelCalibration`` — the stoch-vol benchmark family (blended
  local vol, sqrt-scaling stochastic vol with martingale correction,
  lognormal quotes), every product in ONE path sweep of
  ``ops.lmm_stochvol_kernel.lmm_stochvol_swaptions_batch``.

Each kernel is the CUDA kernel on a CUDA device and its plain version on
the CPU.

* ``residuals(x)`` — one launch at B = 1; the float64 reduction (and, for
  the ATM backend, the numeraire adjustment df(T_e) / E[1/N(T_e)]) follows
  on the engine's device, then the implied-vol inversion and weighting:
  for the stoch-vol backend one launch of
  ``ops.black_residuals.black_residuals`` (the Black Newton and the
  weighting in one CUDA kernel; on the CPU its plain version, the
  engine's ``black_implied_vol``), for the ATM backend the engine's
  ``bachelier_implied_vol``.
* ``jacobian(x)`` — central finite differences under common random
  numbers: ONE launch over 2 * n_params + 1 parameter sets sharing one
  realization.

Each call is traced (``utils.profiling.span``) as
``finmath.backend.residuals`` or ``finmath.backend.jacobian`` (attribute
``sets``, the parameter sets of its launch), with the parts
``finmath.backend.pack`` (the parameters to the device, the FD sets, the
loading tables and scalars), ``finmath.backend.launch`` and
``finmath.backend.reduce`` (the stoch-vol kernel's tile sums, the division
by the paths, the ATM backend's weights and the FD differences) and
``finmath.backend.implied_vol`` (the inversion; for the stoch-vol backend
with its weights, attribute ``kernel``: True where the CUDA kernel ran,
False for the plain version); the fetch to the host is the call's own.

The backends price the engine's own paths: they read the engine's
device-resident increments directly (``[S, F', paths]``, already scaled by
sqrt(dt), passed with ``sqrt_dt = 1``), so kernel and engine agree to the
float32-collection envelope with no second draw.

Scope guards in ``__init__`` pin each kernel's hard-coded dynamics to the
engine's configuration and fail loudly otherwise; a meshed engine is
refused (the kernels are single-device, as the JAX backends are), and a
meshed calibration takes its residuals from the engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...ops.black_residuals import black_residuals
from ...ops.lmm_kernel import lmm_atm_swaptions_batch
from ...ops.lmm_stochvol_kernel import lmm_stochvol_swaptions_batch
from ...utils.profiling import span
from .model import (BLACK_NEWTON_STEPS, LMMValuationEngine,
                    bachelier_implied_vol)

FD_STEP = 5e-4      # absolute central-difference step of every parameter


class _KernelBackend:
    """What the two backends share: the scope guards and tables common to
    both kernels, parameter vectors on the engine's device, the loading
    table, and the central-difference Jacobian under common random numbers
    from ONE batched residual evaluation, and the traced calls. A backend
    defines ``kernel_arguments(params_b, *realization)``, ``_values(args,
    kwargs)`` (the kernel's call to the products' values ``[B, P]``) and
    ``_weighted_residuals(values)`` (the quotes' inversion and
    weighting)."""

    _name = "kernel backend"

    def __init__(self, engine: LMMValuationEngine):
        model = engine.model
        if engine.mesh is not None:
            raise ValueError(f"{self._name} is single-device: build it on "
                             "an engine without a mesh")
        if model.measure != "spot" or model.state_space != "normal":
            raise ValueError(f"{self._name}: spot/NORMAL only")
        if engine.scheme != "euler" or engine.dtype != torch.float32:
            raise ValueError(f"{self._name}: the Euler scheme on float32 "
                             "paths only")
        n = model.num_libors
        if len(model.sim_times) - 1 != n:
            raise ValueError(f"{self._name}: simulation grid == tenor grid")
        dts = np.diff(model.sim_times)
        if not np.allclose(dts, dts[0], atol=1e-12):
            raise ValueError(f"{self._name}: uniform time step required")

        self.engine = engine
        self.device = engine.device
        self.num_paths = engine.num_paths
        self._dt = float(dts[0])
        self._n = n
        self._F = engine.num_factors
        self._n_params = int(model.covariance.n_params)
        # engine product order: residual rows line up 1:1
        self._products = tuple(
            (int(p.exercise_index), int(p.num_periods), float(p.strike))
            for p in engine.products)
        self._num_steps = max(e for e, _, _ in self._products)
        t = engine._t
        # per-product rows [P], contiguous (the engine's are columns of
        # one table) as the stoch-vol backend's inversion kernel reads them
        (self._fwd0, self._ann0, self._strike, self._texp, self._target,
         self._weight) = (t[k].contiguous() for k in (
             "fwd0", "ann0", "strike", "texp", "target", "weight"))
        self._l0 = t["L0"].contiguous()
        self._deltas = t["deltas32"].contiguous()

    def params(self, x) -> torch.Tensor:
        """A parameter vector as a float64 tensor on the engine's device."""
        x = torch.as_tensor(x, dtype=torch.float64).to(self.device)
        if x.shape != (self._n_params,):
            raise ValueError(f"params shape {tuple(x.shape)} != ({self._n_params},)")
        return x

    def _loadings(self, prep) -> torch.Tensor:
        """volT ``[B, F * n, S]`` float64, ``sigma_i(t_s) * R[i, f]`` at row
        ``f * n + i``, of prepared parameter sets ``[B, ...]``."""
        vt = self.engine.model.covariance.vol_table(prep)[:, :self._num_steps]
        Rt = self.engine.model.covariance.factor_matrix(prep).transpose(-1, -2)
        B = vt.shape[0]                                       # vt [B, S, n]
        return (vt.transpose(1, 2)[:, None] * Rt[..., None]).reshape(
            B, self._F * self._n, self._num_steps)

    def fd_parameter_sets(self, params: torch.Tensor):
        """The 2 * n_params + 1 parameter sets of the central-difference
        Jacobian ([x, x + h e_k..., x - h e_k...]) and the steps h."""
        h = torch.full_like(params, FD_STEP)                       # [n_params]
        shift = torch.diag(h)
        return torch.cat([params[None, :], params[None, :] + shift,
                          params[None, :] - shift]), h

    def _residuals(self, params_b: torch.Tensor, *realization):
        """The weighted residual rows ``[B, P]`` of the parameter sets
        ``params_b`` on the engine's device."""
        with span("finmath.backend.pack"):
            args, kwargs = self.kernel_arguments(params_b, *realization)
        return self._weighted_residuals(self._values(args, kwargs))

    def _row(self, x, *realization) -> np.ndarray:
        """The residual row at ``x``, on the host: one call, one launch."""
        with span("finmath.backend.residuals", sets=1):
            with span("finmath.backend.pack"):
                params_b = self.params(x)[None, :]
            return self._residuals(params_b, *realization)[0].cpu().numpy()

    def _jacobian(self, x, *realization, row: bool = False):
        """The central-difference Jacobian ``[P, n_params]`` at ``x`` (and,
        with ``row``, the residual row there first), on the host: one
        call, one launch over the 2 * n_params + 1 sets."""
        k = self._n_params
        with span("finmath.backend.jacobian", sets=2 * k + 1):
            with span("finmath.backend.pack"):
                X, h = self.fd_parameter_sets(self.params(x))
            r = self._residuals(X, *realization)                   # [2n+1, P]
            with span("finmath.backend.reduce"):
                J = ((r[1:1 + k] - r[1 + k:]) / (2.0 * h[:, None])).T
            if row:
                return r[0].cpu().numpy(), J.cpu().numpy()
            return J.cpu().numpy()


class ATMKernelCalibration(_KernelBackend):
    """Kernel-path residuals / FD Jacobian matching
    ``LMMValuationEngine.residuals`` semantics (same products, targets,
    weights, numeraire adjustment and implied-vol inversion)."""

    _name = "ATM kernel backend"

    def __init__(self, engine: LMMValuationEngine):
        cov = engine.model.covariance
        if cov.has_stoch_vol:
            raise ValueError("ATM kernel backend: no stochastic volatility")
        if engine.value_unit != "VOLATILITYNORMAL":
            raise ValueError("ATM kernel backend: VOLATILITYNORMAL products")
        super().__init__(engine)
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

        self._df_exercise, self._ev_of = engine._t["df_ex"], engine._t["ev_of"]
        self._use_adjustment = bool(engine.model.use_numeraire_adjustment)
        # the engine's realization, [S * F, paths] in kernel row order
        self._z = engine.increments[:self._num_steps].reshape(
            self._num_steps * self._F, self.num_paths)

    # ------------------------------------------------------------------
    def _pack(self, params_b: torch.Tensor):
        """[B, n_params] float64 -> (volT [B, F*n, S], scal [B, 8]) float32."""
        cov = self.engine.model.covariance
        B = params_b.shape[0]
        prep = cov.prepare(params_b)
        scal = torch.zeros((B, 8), dtype=torch.float64, device=self.device)
        scal[:, 0] = self._dt
        scal[:, 1] = 1.0           # z is the sqrt(dt)-scaled increment
        if self._displaced:
            # the local factor is elementwise: at L = L0 = 0 it is d per set
            zero = torch.zeros(B, dtype=torch.float64, device=self.device)
            scal[:, 2] = cov.local_factor(prep, zero, zero)
        return (self._loadings(prep).to(torch.float32).contiguous(),
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

    def _values(self, args, kwargs) -> torch.Tensor:
        sums = lmm_atm_swaptions_batch(*args, **kwargs)            # [B, P+E]
        P, paths = self._P, self.num_paths
        raw = sums[:, :P] / paths
        if not self._use_adjustment:
            return raw
        inv_p = (sums[:, P:] / paths)[:, self._ev_of]              # [B, P]
        return raw * torch.where(inv_p > 0.0, self._df_exercise / inv_p, 0.0)

    def _weighted_residuals(self, values: torch.Tensor) -> torch.Tensor:
        with span("finmath.backend.implied_vol"):
            iv = bachelier_implied_vol(values, self._fwd0, self._strike,
                                       self._texp, self._ann0)
        with span("finmath.backend.reduce"):
            return self._weight * (iv - self._target)

    # ------------------------------------------------------------------
    def residuals(self, x) -> np.ndarray:
        return self._row(x)

    def jacobian(self, x) -> np.ndarray:
        return self._jacobian(x)

    def residuals_and_jacobian(self, x):
        return self._jacobian(x, row=True)

    def implied_vols(self, x) -> np.ndarray:
        w = self._weight.cpu().numpy()
        r = self.residuals(x)
        return self._target.cpu().numpy() + np.where(
            w != 0.0, r / np.where(w != 0.0, w, 1.0), 0.0)


class StochVolKernelCalibration(_KernelBackend):
    """Kernel-path residuals / FD Jacobian matching
    ``LMMValuationEngine.residuals`` semantics (same products, targets,
    weights, Black implied-vol inversion) for the stoch-vol benchmark
    family, to the kernel-vs-engine envelope on identical normals; the
    engine stays the quality oracle.

    Realizations: ``k = 0`` is the engine's own device-resident increments
    (or the first of ``realizations`` when given); ``add_realization``
    registers more, each ``[>= S, F + 1, paths]`` sqrt(dt)-scaled increments
    in the engine's injected format, and every entry point takes ``k=``.
    Nothing on the backend changes between calls, so calls on different
    realizations may run from several threads.

    The quotes' Black inversion and their weighting are one call of
    ``ops.black_residuals.black_residuals``: one CUDA launch on a card,
    the engine's ``black_implied_vol`` on the CPU."""

    def __init__(self, engine: LMMValuationEngine,
                 realizations: Optional[Sequence] = None):
        model = engine.model
        cov = model.covariance
        if model.use_numeraire_adjustment:
            raise ValueError("kernel backend: no numeraire adjustment")
        if not cov.has_stoch_vol:
            raise ValueError("kernel backend: stoch-vol covariance required")
        if getattr(cov, "scaling_exponent", 0.5) != 0.5 \
                or not getattr(cov, "martingale_correction", True):
            raise ValueError(
                "kernel backend implements sqrt-scaling with martingale "
                "correction (the framework default convention)")
        if engine.value_unit != "VOLATILITYLOGNORMAL":
            raise ValueError("kernel backend: VOLATILITYLOGNORMAL products")
        # the kernel's local factor is blended, (1-b) L + b L0; the form is
        # verified at the initial parameters, b itself is read per
        # parameter set in _pack
        prep = cov.prepare(torch.as_tensor(
            np.asarray(cov.initial_parameters, np.float64)))
        z1 = torch.zeros(1, dtype=torch.float64)
        lf = [float(cov.local_factor(prep, z1 + a, z1 + c)[0])
              for a, c in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (2.0, 0.0))]
        if abs(lf[0]) > 1e-12 or abs(lf[1] + lf[2] - 1.0) > 1e-12 \
                or abs(lf[3] - 2.0 * lf[1]) > 1e-12:
            raise ValueError(
                "kernel backend supports the blended local factor "
                "(1-b) L + b L0 only; this covariance has another")
        super().__init__(engine)
        self._z = [self._pack_realization(inc) for inc in (
            realizations if realizations is not None else [engine.increments])]
        if not self._z:
            raise ValueError("at least one realization is required")

    # ------------------------------------------------------------------
    def _pack_realization(self, inc) -> torch.Tensor:
        """``[>= S, F + 1, paths]`` sqrt(dt)-scaled increments (NumPy or
        tensor) -> ``[S * (F + 1), paths]`` float32 on the engine's device,
        in kernel row order (step-major, the factors, then the V driver).
        The engine's own tensor is used in place."""
        inc = getattr(inc, "increments", inc)
        inc = torch.as_tensor(inc).to(device=self.device, dtype=torch.float32)
        S, rows = self._num_steps, self._F + 1
        if (inc.dim() != 3 or inc.shape[1] != rows
                or inc.shape[2] != self.num_paths or inc.shape[0] < S):
            raise ValueError(
                f"realization shape {tuple(inc.shape)} incompatible with "
                f"[>={S}, {rows}, {self.num_paths}]")
        return inc[:S].reshape(S * rows, self.num_paths).contiguous()

    @property
    def num_realizations(self) -> int:
        return len(self._z)

    def add_realization(self, inc) -> int:
        """Register another realization; returns its ``k`` index."""
        self._z.append(self._pack_realization(inc))
        return len(self._z) - 1

    # ------------------------------------------------------------------
    def _pack(self, params_b: torch.Tensor):
        """[B, n_params] float64 -> (volT [B, F*n, S], scal [B, 8]) float32."""
        cov = self.engine.model.covariance
        B = params_b.shape[0]
        prep = cov.prepare(params_b)
        f64 = dict(dtype=torch.float64, device=self.device)
        # the blend through the covariance's own local-factor map at
        # (L, L0) = (1, 0) -> 1 - b, whatever the wrapper nesting
        b = 1.0 - cov.local_factor(prep, torch.ones(B, **f64),
                                   torch.zeros(B, **f64))
        nu, rho = (torch.as_tensor(p, **f64).expand(B)
                   for p in cov.stoch_vol_params(prep))
        scal = torch.zeros((B, 8), **f64)
        scal[:, 0] = self._dt
        scal[:, 1] = 1.0           # z is the sqrt(dt)-scaled increment
        scal[:, 2] = b
        scal[:, 3] = nu
        scal[:, 4] = rho
        scal[:, 5] = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 1e-12))
        return (self._loadings(prep).to(torch.float32).contiguous(),
                scal.to(torch.float32).contiguous())

    def kernel_arguments(self, params_b: torch.Tensor, k: int = 0):
        """The positional tensors and keyword arguments of the
        ``lmm_stochvol_swaptions_batch`` call that values the parameter
        sets ``params_b`` [B, n_params] (float64, on the engine's device)
        on realization ``k``."""
        volT_b, scal_b = self._pack(params_b)
        return ((self._z[k], volT_b, scal_b, self._l0, self._deltas),
                dict(num_libors=self._n, num_factors=self._F,
                     products=self._products, num_paths=self.num_paths))

    def _values(self, args, kwargs) -> torch.Tensor:
        sums = lmm_stochvol_swaptions_batch(*args, **kwargs)       # [B, P]
        with span("finmath.backend.reduce"):
            return sums / self.num_paths

    def _weighted_residuals(self, values: torch.Tensor) -> torch.Tensor:
        with span("finmath.backend.implied_vol", kernel=values.is_cuda):
            return black_residuals(values, self._fwd0, self._strike,
                                   self._texp, self._ann0, self._target,
                                   self._weight, BLACK_NEWTON_STEPS)

    # ------------------------------------------------------------------
    def residuals(self, x, k: int = 0) -> np.ndarray:
        return self._row(x, k)

    def residuals_batch(self, X, k: int = 0) -> np.ndarray:
        """[M, n_params] -> [M, P], one launch at B = M."""
        with span("finmath.backend.residuals") as s:
            with span("finmath.backend.pack"):
                X = torch.as_tensor(X, dtype=torch.float64).to(self.device)
                if X.dim() != 2 or X.shape[1] != self._n_params:
                    raise ValueError(
                        f"parameter sets of shape {tuple(X.shape)}, "
                        f"expected [M, {self._n_params}]")
            s.set(sets=X.shape[0])
            return self._residuals(X, k).cpu().numpy()

    def jacobian(self, x, k: int = 0) -> np.ndarray:
        return self._jacobian(x, k)

    def residuals_and_jacobian(self, x, k: int = 0):
        return self._jacobian(x, k, row=True)

    def implied_vols(self, x, k: int = 0) -> np.ndarray:
        """Model quotes (lognormal implied vols), from the residual row."""
        w = self._weight.cpu().numpy()
        r = self.residuals(x, k)
        return self._target.cpu().numpy() + np.where(
            w != 0.0, r / np.where(w != 0.0, w, 1.0), 0.0)

    def deviations(self, x, k: int = 0) -> np.ndarray:
        return self.implied_vols(x, k) - self._target.cpu().numpy()
