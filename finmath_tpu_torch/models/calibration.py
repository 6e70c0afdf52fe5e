"""Levenberg-Marquardt calibration.

Equivalent of finmath-lib's ``LevenbergMarquardt`` optimizer as configured
by the reference's calibration tests (LIBORMarketModelCalibrationATMTest
.java:317-339: RegularizationMethod.LEVENBERG, lambda = 0.1, <= 200
iterations, accuracy 1e-7, parameter bounds [0, inf)). Copied from
``finmath_tpu.models.calibration`` (host-side NumPy; the tests hold the
iterates equal); ``LevenbergMarquardt`` adds its calls and rejected steps
to ``LMResult`` and traces a run (``utils.profiling.span``).

The Jacobian comes from the caller: ``torch.func.jacfwd`` through the
engine, or the kernel backend's finite differences; the tiny
(params x params) normal-equation solve stays on host in float64.
``BatchedLevenbergMarquardt`` (the lockstep multistart of
``sweep_mode="batched"``) is copied unchanged too and gives the JAX
class's iterates bit for bit on the same residual functions.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..utils.profiling import span

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
    #: calls of the residual and Jacobian functions, and trial steps whose
    #: residuals were computed and rejected (``LevenbergMarquardt``)
    residual_calls: int = 0
    jacobian_calls: int = 0
    rejected_steps: int = 0


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
        """Iterate from ``x0``; traced as the span ``finmath.lm.run`` (its
        counts as attributes), each trial step's normal equations, solve
        and clip as a ``finmath.lm.solve`` inside it."""
        with span("finmath.lm.run") as s:
            result = self._run(x0)
            s.set(residual_calls=result.residual_calls,
                  jacobian_calls=result.jacobian_calls,
                  rejected_steps=result.rejected_steps,
                  iterations=result.iterations)
        return result

    def _run(self, x0: np.ndarray) -> LMResult:
        x = np.asarray(x0, dtype=np.float64).copy()
        r = np.asarray(self.residual_fn(x), dtype=np.float64)
        residual_calls, jacobian_calls, rejected = 1, 0, 0
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
            jacobian_calls += 1
            jtj = None
            accepted = False
            while lam <= self.max_lambda:
                with span("finmath.lm.solve"):
                    if jtj is None:
                        jtj = J.T @ J
                        jtr = J.T @ r
                    try:
                        delta = np.linalg.solve(
                            jtj + lam * np.eye(len(x)), -jtr
                        )
                    except np.linalg.LinAlgError:
                        lam *= self.lambda_multiplicator
                        continue
                    x_new = np.clip(x + delta, self.lower_bound,
                                    self.upper_bound)
                r_new = np.asarray(self.residual_fn(x_new), dtype=np.float64)
                residual_calls += 1
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
                rejected += 1
                lam *= self.lambda_multiplicator
            if not accepted or converged:
                converged = converged or not accepted and err < 10 * self.accuracy
                break

        return LMResult(parameters=x, rms_error=err, iterations=it,
                        converged=converged or err < self.accuracy,
                        lambda_final=lam, history=history,
                        residual_calls=residual_calls,
                        jacobian_calls=jacobian_calls,
                        rejected_steps=rejected)


class BatchedLevenbergMarquardt:
    """Levenberg-Marquardt over K independent starts in LOCKSTEP.

    Instead of optimizing each start sequentially (K x iterations x
    (residual + Jacobian) device calls), every iteration evaluates ONE
    batched residual call and ONE batched Jacobian call for all K starts
    (the engine's ``residuals_batched`` / ``jacobian_batched``): the
    device sees K-fold larger work and the host pays one call instead of
    K. The per-start (params x params) normal-equation solves stay on host
    in float64 (they are microseconds at these sizes).

    Semantic difference to the sequential class: a start whose step is
    rejected raises its own damping and retries on the NEXT lockstep
    iteration (sharing the batched evaluations) instead of spinning a
    private inner loop. Each start carries independent (x, lambda,
    converged) state; finished starts idle in their batch slot so the
    batch shape stays fixed.
    """

    def __init__(self,
                 residuals_batched: Callable[[np.ndarray], np.ndarray],
                 jacobian_batched: Callable[[np.ndarray], np.ndarray],
                 lambda0: float = 0.1,
                 max_iterations: int = 50,
                 accuracy: float = 1e-7,
                 lower_bound: float = -np.inf,
                 upper_bound: float = np.inf,
                 lambda_divisor: float = 3.0,
                 lambda_multiplicator: float = 2.0,
                 max_lambda: float = 1e10,
                 reject_patience: int = 6):
        self.residuals_batched = residuals_batched
        self.jacobian_batched = jacobian_batched
        self.lambda0 = lambda0
        self.max_iterations = max_iterations
        self.accuracy = accuracy
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.lambda_divisor = lambda_divisor
        self.lambda_multiplicator = lambda_multiplicator
        self.max_lambda = max_lambda
        #: a start whose last `reject_patience` trial steps were ALL
        #: rejected is marked finished — in lockstep a stuck start would
        #: otherwise drag the whole batch through max_iterations while it
        #: doubles its damping one rejection per iteration
        self.reject_patience = int(reject_patience)

    def run(self, x0_batch: np.ndarray) -> List[LMResult]:
        X = np.asarray(x0_batch, dtype=np.float64).copy()
        if X.ndim != 2:
            raise ValueError("x0_batch must be [num_starts, num_params]")
        K, n = X.shape
        R = np.nan_to_num(
            np.asarray(self.residuals_batched(X), dtype=np.float64),
            nan=1e3, posinf=1e3, neginf=-1e3)
        err = np.sqrt(np.mean(R * R, axis=1))                  # [K]
        lam = np.full(K, self.lambda0)
        converged = err < self.accuracy      # reached the accuracy contract
        done = converged.copy()              # retired slots (incl. give-ups)
        iters = np.zeros(K, dtype=int)
        rejects = np.zeros(K, dtype=int)
        eye = np.eye(n)
        J = None                             # reused across all-reject rounds

        for _ in range(self.max_iterations):
            if done.all():
                break
            if J is None:
                # X is unchanged after a round with zero accepted steps, so
                # the (dominant-cost) batched Jacobian is unchanged too
                J = np.nan_to_num(
                    np.asarray(self.jacobian_batched(X), dtype=np.float64),
                    nan=0.0, posinf=0.0, neginf=0.0)           # [K, P, n]
            X_trial = X.copy()
            solvable = np.zeros(K, dtype=bool)
            for k in range(K):
                if done[k]:
                    continue
                iters[k] += 1
                jtj = J[k].T @ J[k]
                try:
                    delta = np.linalg.solve(jtj + lam[k] * eye, -J[k].T @ R[k])
                except np.linalg.LinAlgError:
                    lam[k] *= self.lambda_multiplicator
                    rejects[k] += 1
                    if lam[k] > self.max_lambda or \
                            rejects[k] >= self.reject_patience:
                        done[k] = True       # gave up; NOT converged
                    continue
                X_trial[k] = np.clip(X[k] + delta,
                                     self.lower_bound, self.upper_bound)
                solvable[k] = True
            if not solvable.any():
                continue
            R_trial = np.nan_to_num(
                np.asarray(self.residuals_batched(X_trial), dtype=np.float64),
                nan=1e3, posinf=1e3, neginf=-1e3)
            err_trial = np.sqrt(np.mean(R_trial * R_trial, axis=1))
            any_accept = False
            for k in range(K):
                if done[k] or not solvable[k]:
                    continue
                if np.isfinite(err_trial[k]) and err_trial[k] < err[k]:
                    improvement = err[k] - err_trial[k]
                    X[k], R[k], err[k] = X_trial[k], R_trial[k], err_trial[k]
                    lam[k] = max(lam[k] / self.lambda_divisor, 1e-12)
                    rejects[k] = 0
                    any_accept = True
                    if improvement < self.accuracy or err[k] < self.accuracy:
                        converged[k] = True
                        done[k] = True
                else:
                    lam[k] *= self.lambda_multiplicator
                    rejects[k] += 1
                    if lam[k] > self.max_lambda or \
                            rejects[k] >= self.reject_patience:
                        done[k] = True       # gave up; NOT converged
            if any_accept:
                J = None                     # X moved: recompute next round

        return [LMResult(parameters=X[k], rms_error=float(err[k]),
                         iterations=int(iters[k]),
                         converged=bool(converged[k] or err[k] < self.accuracy),
                         lambda_final=float(lam[k]), history=[])
                for k in range(K)]
