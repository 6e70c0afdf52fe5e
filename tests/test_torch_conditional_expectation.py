"""The port's Longstaff-Schwartz regression (``ops/conditional_expectation.py``)
against finmath_tpu's on the same seeded NumPy inputs.

Tolerances: the float64 betas within 1e-10 relative to their largest
component, at B = 1..5 basis functions and 4,096 paths (both packages
solve the same float64 normal equations, by LAPACK here and by an
unrolled Cholesky there); the float32 predictions within 2 float32 ulps
of the JAX package's; the estimator's fitted values and the
``get_conditional_expectation`` hooks of ``RandomVariableTorch`` and the
port's ``RandomVariableFloat`` within 2 ulps too. A Gram that is not
positive definite gives NaN betas (the documented behaviour; the JAX
package floors its pivots instead).

On a card (the ``gpu`` test, no JAX needed): ``regression_fit_predict`` on
``cuda`` against the same call on the CPU, to within float32 rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.ops import (RandomVariableFloat,  # noqa: E402
                                   RandomVariableTorch)
from finmath_tpu_torch.ops import conditional_expectation as ce  # noqa: E402

PATHS, SEED = 4096, 2718
CPU = "cpu"


def _basis(B, paths=PATHS, seed=SEED):
    """{1, x, x^2, ...} of a normal x, plus a noisy quadratic target."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(paths)
    basis = np.stack([x ** k for k in range(B)]).astype(np.float32)
    y = (0.3 + x - 0.5 * x * x + 0.2 * rng.standard_normal(paths)
         ).astype(np.float32)
    return basis, y


def _ulps(a, b):
    """Distance in float32 ulps of the larger magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.max(np.abs(a.astype(np.float64) - b) / scale)


@pytest.fixture(scope="module")
def jce():
    jax_ce = pytest.importorskip("finmath_tpu.ops.conditional_expectation")
    import jax.numpy as jnp
    return jax_ce, jnp


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5])
def test_regression_fit_and_predict_match_jax(jce, B):
    jax_ce, jnp = jce
    basis, y = _basis(B)
    beta_j = np.asarray(jax_ce.regression_fit(jnp.asarray(basis),
                                              jnp.asarray(y)))
    beta_t = ce.regression_fit(torch.from_numpy(basis), torch.from_numpy(y))
    assert beta_t.dtype == torch.float64
    np.testing.assert_allclose(beta_t.numpy(), beta_j, rtol=0,
                               atol=1e-10 * np.max(np.abs(beta_j)))
    pred_j = np.asarray(jax_ce.regression_fit_predict(jnp.asarray(basis),
                                                      jnp.asarray(y)))
    pred_t = ce.regression_fit_predict(torch.from_numpy(basis),
                                       torch.from_numpy(y))
    assert pred_t.dtype == torch.float32
    assert _ulps(pred_t.numpy(), pred_j) <= 2
    # the same coefficients applied by regression_predict
    assert torch.equal(ce.regression_predict(torch.from_numpy(basis), beta_t),
                       pred_t)


def test_estimator_and_hooks_match_jax(jce):
    jax_ce, _ = jce
    from finmath_tpu.ops.random_variable import RandomVariableTPU
    from finmath_tpu.ops.random_variable_float import (
        RandomVariableFloat as JaxFloat)

    basis, y = _basis(3)
    x = basis[1]
    # monomial_basis on the underlying, through the device type's hook
    fit_j = RandomVariableTPU(0.0, y).get_conditional_expectation(
        jax_ce.monomial_basis(RandomVariableTPU(0.0, x), 2))
    est_t = ce.monomial_basis(RandomVariableTorch(0.0, x, device=CPU), 2)
    assert len(est_t.basis_functions) == 3
    fit_t = RandomVariableTorch(1.5, y, device=CPU).get_conditional_expectation(
        est_t)
    assert isinstance(fit_t, RandomVariableTorch)
    assert fit_t.get_filtration_time() == 1.5
    assert _ulps(fit_t.get_realizations(), fit_j.get_realizations()) <= 2
    # the explicit estimator with a deterministic basis function, and the
    # float oracle's hook (its realizations go to the estimator's device)
    est = ce.MonteCarloConditionalExpectationRegression(
        [RandomVariableTorch(0.0, 1.0, device=CPU),
         RandomVariableFloat(0.0, x)], device=CPU)
    jest = jax_ce.MonteCarloConditionalExpectationRegression(
        [RandomVariableTPU(0.0, 1.0), JaxFloat(0.0, x)])
    via_float = RandomVariableFloat(0.0, y).get_conditional_expectation(est)
    via_jax = JaxFloat(0.0, y).get_conditional_expectation(jest)
    assert via_float.values.device.type == "cpu"
    assert _ulps(via_float.get_realizations(), via_jax.get_realizations()) <= 2
    with pytest.raises(ValueError):
        ce.MonteCarloConditionalExpectationRegression([])


def test_deterministic_passthrough():
    est = ce.monomial_basis(
        RandomVariableTorch(0.0, np.ones(10, np.float32), device=CPU), 2)
    det = RandomVariableTorch(0.0, 5.0)
    out = det.get_conditional_expectation(est)
    assert out.is_deterministic() and out.double_value() == 5.0


def test_regression_recovers_function():
    """tests/test_aad.py's regression case: a cubic fit of x^2 + noise."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(-1, 1, 50_000).astype(np.float32)
    noise = (rng.standard_normal(50_000) * 0.1).astype(np.float32)
    target = RandomVariableTorch(0.0, xs * xs + noise, device=CPU)
    est = ce.monomial_basis(RandomVariableTorch(0.0, xs, device=CPU), 3)
    fitted = target.get_conditional_expectation(est)
    assert np.max(np.abs(fitted.get_realizations() - xs * xs)) < 0.01


def test_singular_gram_gives_nan_betas():
    """An all-zero basis leaves a zero Gram even after the jitter (its
    trace is 0): cholesky_ex reports the pivot, the betas are NaN and so is
    every prediction. A collinear but nonzero basis is regularized by the
    jitter and stays finite."""
    zero = torch.zeros(2, 64)
    y = torch.linspace(0.0, 1.0, 64)
    beta = ce.regression_fit(zero, y)
    assert beta.shape == (2,) and bool(torch.all(torch.isnan(beta)))
    assert bool(torch.all(torch.isnan(ce.regression_fit_predict(zero, y))))
    collinear = torch.stack([torch.ones(64), 2.0 * torch.ones(64)])
    pred = ce.regression_fit_predict(collinear, y)
    assert bool(torch.all(torch.isfinite(pred)))
    assert float(pred[0]) == pytest.approx(float(y.double().mean()), rel=1e-6)
    # the small solve alone, on a gram with a negative pivot
    gram = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    out = ce._cholesky_solve_small(gram, torch.ones(2, dtype=torch.float64))
    assert bool(torch.all(torch.isnan(out)))


@pytest.mark.gpu
def test_cuda_regression_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    basis, y = _basis(4, paths=100_003)
    cpu = ce.regression_fit_predict(torch.from_numpy(basis),
                                    torch.from_numpy(y))
    beta_c = ce.regression_fit(torch.from_numpy(basis), torch.from_numpy(y))
    beta_g = ce.regression_fit(torch.from_numpy(basis).cuda(),
                               torch.from_numpy(y).cuda())
    gpu = ce.regression_fit_predict(torch.from_numpy(basis).cuda(),
                                    torch.from_numpy(y).cuda())
    np.testing.assert_allclose(beta_g.cpu().numpy(), beta_c.numpy(), rtol=0,
                               atol=1e-10 * float(beta_c.abs().max()))
    assert _ulps(gpu.cpu().numpy(), cpu.numpy()) <= 2
