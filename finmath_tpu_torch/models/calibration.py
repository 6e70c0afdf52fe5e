"""Levenberg-Marquardt calibration.

Equivalent of finmath-lib's ``LevenbergMarquardt`` optimizer as configured
by the reference's calibration tests (LIBORMarketModelCalibrationATMTest
.java:317-339: RegularizationMethod.LEVENBERG, lambda = 0.1, <= 200
iterations, accuracy 1e-7, parameter bounds [0, inf)). Copied unchanged
from ``finmath_tpu.models.calibration`` (host-side NumPy; the tests hold
the iterates equal).

The Jacobian comes from the caller: ``torch.func.jacfwd`` through the
engine, or the kernel backend's finite differences; the tiny
(params x params) normal-equation solve stays on host in float64.
``BatchedLevenbergMarquardt`` (lockstep multistart) comes with the
stoch-vol calibration.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

logger = logging.getLogger("finmath_tpu_torch.calibration")


@dataclass
class LMResult:
    parameters: np.ndarray
    rms_error: float
    iterations: int
    converged: bool
    lambda_final: float
    history: List[float] = field(default_factory=list)
    #: per-stage diagnostics (timings, candidate counts, best-rms per
    #: stage) — populated by the staged procedures (calibrate_multistart)
    #: so a single result row is self-explaining
    stages: dict = field(default_factory=dict)


class LevenbergMarquardt:
    """Damped least squares with Levenberg (lambda * I) regularization."""

    def __init__(self, residual_fn: Callable[[np.ndarray], np.ndarray],
                 jacobian_fn: Callable[[np.ndarray], np.ndarray],
                 lambda0: float = 0.1,
                 max_iterations: int = 200,
                 accuracy: float = 1e-7,
                 lower_bound: float = 0.0,
                 upper_bound: float = np.inf,
                 lambda_divisor: float = 3.0,
                 lambda_multiplicator: float = 2.0,
                 max_lambda: float = 1e10):
        self.residual_fn = residual_fn
        self.jacobian_fn = jacobian_fn
        self.lambda0 = lambda0
        self.max_iterations = max_iterations
        self.accuracy = accuracy
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.lambda_divisor = lambda_divisor
        self.lambda_multiplicator = lambda_multiplicator
        self.max_lambda = max_lambda

    @staticmethod
    def _rms(r: np.ndarray) -> float:
        return float(np.sqrt(np.mean(r * r)))

    def run(self, x0: np.ndarray) -> LMResult:
        x = np.asarray(x0, dtype=np.float64).copy()
        r = np.asarray(self.residual_fn(x), dtype=np.float64)
        err = self._rms(r)
        lam = self.lambda0
        history = [err]
        converged = False
        it = 0

        for it in range(1, self.max_iterations + 1):
            if err < self.accuracy:
                converged = True
                break
            J = np.asarray(self.jacobian_fn(x), dtype=np.float64)
            jtj = J.T @ J
            jtr = J.T @ r
            accepted = False
            while lam <= self.max_lambda:
                try:
                    delta = np.linalg.solve(
                        jtj + lam * np.eye(len(x)), -jtr
                    )
                except np.linalg.LinAlgError:
                    lam *= self.lambda_multiplicator
                    continue
                x_new = np.clip(x + delta, self.lower_bound, self.upper_bound)
                r_new = np.asarray(self.residual_fn(x_new), dtype=np.float64)
                err_new = self._rms(r_new)
                if np.isfinite(err_new) and err_new < err:
                    improvement = err - err_new
                    x, r, err = x_new, r_new, err_new
                    lam = max(lam / self.lambda_divisor, 1e-12)
                    accepted = True
                    history.append(err)
                    logger.debug("LM iter %d: rms=%.3e lambda=%.2e", it, err, lam)
                    if improvement < self.accuracy:
                        converged = True
                    break
                lam *= self.lambda_multiplicator
            if not accepted or converged:
                converged = converged or not accepted and err < 10 * self.accuracy
                break

        return LMResult(parameters=x, rms_error=err, iterations=it,
                        converged=converged or err < self.accuracy,
                        lambda_final=lam, history=history)
