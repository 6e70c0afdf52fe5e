"""Monte-Carlo conditional expectation by least-squares regression
(Longstaff-Schwartz).

Counterpart of ``finmath_tpu.ops.conditional_expectation``, finmath-lib's
``MonteCarloConditionalExpectationRegression``: the estimator behind
``RandomVariable.getConditionalExpectation``. The normal equations are
formed and solved in float64 on the variables' device: ``X @ X.T`` and
``X @ y`` are plain float64 products, and the small (basis x basis) SPD
solve is ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``. The JAX
package spells its Cholesky out by hand only because the TPU's float64
emulation has no LU decomposition; the card's float64 LAPACK-style solvers
need no such detour.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.config import select_device
from .random_variable import (ACC_DTYPE, FLOAT_DTYPE, RandomVariable,
                              RandomVariableTorch)


def _cholesky_solve_small(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the small SPD system ``gram @ beta = rhs`` in float64.

    A Gram matrix that is not numerically positive definite (a pivot
    <= 0, which the Tikhonov jitter of ``regression_fit`` leaves only for
    an all-zero basis) gives NaN betas, so every prediction from them is
    NaN: the failure shows in the result instead of raising, and the
    check costs no host synchronisation. (The JAX package floors each
    pivot at 1e-300 and returns finite betas there.)"""
    factor, info = torch.linalg.cholesky_ex(gram)
    beta = torch.cholesky_solve(rhs[:, None], factor)[:, 0]
    return torch.where(info == 0, beta, torch.nan)


def regression_fit(basis: torch.Tensor, y: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """basis [B, paths], y [paths] -> float64 coefficients beta [B].

    Normal equations with Tikhonov jitter ``1e-12 * trace(gram)`` in
    float64 (B is a handful of basis functions, paths is large). Exposed
    apart from prediction so that a Longstaff-Schwartz policy can be
    fitted on one path set and applied to an independent one (the
    out-of-sample lower bound of the Bermudan pricer). ``mesh``: a
    ``parallel.PathMesh`` whose ranks each hold one block of the paths;
    the Gram matrix and the right-hand side are then summed over the ranks
    (one float64 all-reduce) before the solve, so every rank fits the same
    global regression (the JAX package's ``axis_name``)."""
    X = basis.to(ACC_DTYPE)                          # [B, paths]
    gram = X @ X.T                                   # [B, B]
    rhs = X @ y.to(ACC_DTYPE)                        # [B]
    if mesh is not None:
        both = mesh.all_reduce(torch.cat([gram, rhs[:, None]], dim=1))
        gram, rhs = both[:, :-1], both[:, -1]
    eye = torch.eye(gram.shape[0], dtype=ACC_DTYPE, device=gram.device)
    return _cholesky_solve_small(gram + 1e-12 * torch.trace(gram) * eye, rhs)


def regression_predict(basis: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """basis [B, paths], beta [B] -> predicted E[y | basis] [paths] float32
    (the product in float64)."""
    return (beta @ basis.to(ACC_DTYPE)).to(FLOAT_DTYPE)


def regression_fit_predict(basis: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """basis [B, paths] float32, y [paths] -> fitted E[y | basis] [paths]
    float32."""
    return regression_predict(basis, regression_fit(basis, y))


class MonteCarloConditionalExpectationRegression:
    """Estimator usable as the argument of
    ``RandomVariable.get_conditional_expectation``.

    The regression runs on the device of the target's realizations when
    they are a tensor, else on that of the first stochastic
    ``RandomVariableTorch`` basis function, else on ``device`` (default
    ``select_device()``). A target under a mesh (``RandomVariableTorch.mesh``)
    is fitted globally over the ranks, and the fit carries the mesh."""

    def __init__(self, basis_functions: Sequence[RandomVariable], device=None):
        if not basis_functions:
            raise ValueError("need at least one basis function")
        self.basis_functions = list(basis_functions)
        self.device = torch.device(device) if device is not None else None

    def _device_for(self, rv: RandomVariable) -> torch.device:
        for x in [rv] + self.basis_functions:
            if isinstance(x, RandomVariableTorch) and isinstance(
                    x.values, torch.Tensor):
                return x.values.device
        return self.device if self.device is not None else select_device()

    def _basis_matrix(self, device, size: int) -> torch.Tensor:
        """[B, paths]: deterministic basis functions broadcast to ``size``
        paths (the target's)."""
        cols = []
        for b in self.basis_functions:
            rv = RandomVariableTorch.from_random_variable(b, device)
            if rv.is_deterministic():
                cols.append(torch.full((size,), float(rv.values),
                                       dtype=FLOAT_DTYPE, device=device))
            else:
                cols.append(rv.values)
        return torch.stack(cols)  # [B, paths]

    def get_conditional_expectation(self, rv: RandomVariable) -> RandomVariableTorch:
        device = self._device_for(rv)
        target = RandomVariableTorch.from_random_variable(rv, device)
        if target.is_deterministic():
            return target
        basis = self._basis_matrix(device, target.values.shape[0])
        fitted = regression_predict(
            basis, regression_fit(basis, target.values, mesh=target.mesh))
        return RandomVariableTorch.of(target.get_filtration_time(), fitted,
                                      mesh=target.mesh)

    getConditionalExpectation = get_conditional_expectation


def monomial_basis(underlying: RandomVariable, degree: int, device=None
                   ) -> MonteCarloConditionalExpectationRegression:
    """Regression on {1, x, x^2, ..., x^degree} of an underlying state
    variable (the classic Longstaff-Schwartz choice). ``device`` is where
    a host-side ``underlying`` is uploaded (default: the device of a
    tensor-backed one, else ``select_device()``)."""
    if device is None and isinstance(underlying, RandomVariableTorch) \
            and isinstance(underlying.values, torch.Tensor):
        device = underlying.values.device
    device = torch.device(device) if device is not None else select_device()
    basis = [RandomVariableTorch(0.0, 1.0, device=device)]
    x = RandomVariableTorch.from_random_variable(underlying, device)
    p = x
    for _ in range(degree):
        basis.append(p)
        p = p.mult(x)
    return MonteCarloConditionalExpectationRegression(basis, device=device)
