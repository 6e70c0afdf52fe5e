"""The stoch-vol kernel backend's Black implied-vol inversion and weighting
(``ops/black_residuals.py``): the wrapper's plain version against the
valuation engine's composition ``weight * (black_implied_vol(...) -
target)`` bit for bit on the CPU, the wrapper's checks, and, on a card,
the CUDA kernel against the plain version within 1e-12 absolute.

The grid: 15 products from far out of the money to deep in the money
(ln(F/K) from -1.5 to 1.5, expiries 0.25 to 20 years), valued by Black's
formula at vols from 1e-6 to 9.5 (near both of the inversion's bounds,
1e-8 and 10), plus quotes at and below intrinsic value, which invert to
0. B = 1 and B = 17 (the backend's residual row and the central-difference
Jacobian's parameter sets at 8 parameters).

The ``gpu`` tests need a card and no JAX; on a machine with the card:
``python -m pytest tests/test_torch_black_residuals.py -m gpu
--noconftest``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models.lmm import (  # noqa: E402
    StochVolKernelCalibration, build_benchmark_calibration)
from finmath_tpu_torch.models.lmm.model import (  # noqa: E402
    BLACK_NEWTON_STEPS as STEPS, black_implied_vol)
from finmath_tpu_torch.ops import black_residuals as br  # noqa: E402
from finmath_tpu_torch.utils import profiling  # noqa: E402

LOG_MONEYNESS = (-1.5, -0.6, -0.2, -0.05, 0.0, 0.0, 0.05, 0.2, 0.6, 1.5,
                 -1.0, -0.01, 0.01, 1.0, 0.3)
EXPIRIES = (0.25, 1.0, 5.0, 10.0, 20.0)
VOLS = np.geomspace(1e-6, 9.5, 17)
B1_VOLS = (0.8, 0.4, 0.25, 0.2, 1e-6, 9.5, 0.15, 0.3, 0.5, 1.2, 3.0, 1e-4,
           2e-4, 0.05, 0.1)


def _rows(device="cpu"):
    """forward, strike, maturity, annuity, target, weight ``[P]``."""
    P = len(LOG_MONEYNESS)
    fwd = 0.01 + 0.004 * np.arange(P)
    strike = fwd * np.exp(-np.asarray(LOG_MONEYNESS))
    texp = np.asarray([EXPIRIES[j % len(EXPIRIES)] for j in range(P)])
    ann = 0.5 + 0.3 * np.arange(P)
    target = 0.15 + 0.01 * np.arange(P)
    weight = 1.0 + 0.1 * (np.arange(P) % 3)
    return tuple(torch.tensor(a, dtype=torch.float64, device=device)
                 for a in (fwd, strike, texp, ann, target, weight))


def _black_values(vols, rows):
    """Annuity times Black's call value at ``vols`` ``[B, P]``, with row
    b's last two products at and just below intrinsic value."""
    fwd, strike, texp, ann = (r.cpu().numpy() for r in rows[:4])
    vols = np.asarray(vols, np.float64)
    v = vols * np.sqrt(texp)
    d1 = np.log(fwd / strike) / v + 0.5 * v
    d2 = d1 - v
    ncdf = np.vectorize(lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0)))
    values = ann * (fwd * ncdf(d1) - strike * ncdf(d2))
    intrinsic = ann * np.maximum(fwd - strike, 0.0)
    values[:, -2] = intrinsic[-2]
    values[:, -1] = intrinsic[-1] * (1.0 - 1e-9) - 1e-15
    return values


def _inputs(B, device="cpu"):
    rows = _rows()
    if B == 1:   # one row, each product at its own vol
        vols = np.asarray(B1_VOLS)[None, :]
    else:        # row b at vol b for every product
        vols = np.repeat(VOLS[:B, None], len(LOG_MONEYNESS), axis=1)
    values = torch.tensor(_black_values(vols, rows), dtype=torch.float64,
                          device=device)
    return (values,) + tuple(r.to(device) for r in rows)


def _composition(values, fwd, strike, texp, ann, target, weight):
    return weight * (black_implied_vol(values, fwd, strike, texp, ann)
                     - target)


@pytest.mark.parametrize("B", [1, 17])
def test_plain_version_is_the_engine_composition(B):
    args = _inputs(B)
    launches = br.LAUNCHES
    got = br.black_residuals(*args, STEPS)
    assert torch.equal(got, _composition(*args))
    assert torch.equal(got, br.black_residuals_reference(*args, STEPS))
    assert br.LAUNCHES == launches          # the CPU never launches
    iv = black_implied_vol(*args[:5])
    assert torch.all(iv[:, -2:] == 0.0)     # at and below intrinsic


def test_grid_reaches_both_bounds_and_the_zeros():
    """The grid's vols come back where the time value is not lost to
    rounding (at least 1e-6 F) and the total vol sigma sqrt(T) is below
    10, near both bounds (1e-6 at the money, 9.5); out of the money at
    the smallest vols the time value falls to at most 1e-12 F and the
    inversion gives 0, as it does at and below intrinsic."""
    args = _inputs(17)
    iv = black_implied_vol(*args[:5]).numpy()[:, :-2]
    values, fwd, strike, texp, ann = (a.numpy()[..., :-2] for a in args[:5])
    time_value = (values / ann - np.maximum(fwd - strike, 0.0)) / fwd
    vols = np.broadcast_to(VOLS[:, None], iv.shape)
    sound = (time_value > 1e-6) & (vols * np.sqrt(texp) < 10.0)
    err = np.abs(iv - vols) / vols
    assert np.all(err[sound] < 1e-9)
    assert sound[0].any() and sound[-1].any()       # 1e-6 and 9.5
    assert np.all(iv[time_value <= 1e-12] == 0.0)
    assert (iv == 0.0).sum() >= 20


def _bad(case):
    values, fwd, strike, texp, ann, target, weight = _inputs(1)
    if case == "values_1d":
        values = values[0]
    elif case == "values_empty":
        values = values[:0]
    elif case == "row_length":
        fwd = torch.cat([fwd, fwd[:1]])
    elif case == "values_float32":
        values = values.float()
    elif case == "target_float32":
        target = target.float()
    elif case == "weight_on_meta":
        weight = weight.to("meta")
    elif case == "all_on_meta":
        values, fwd, strike, texp, ann, target, weight = (
            t.to("meta") for t in (values, fwd, strike, texp, ann, target,
                                   weight))
    elif case == "strided_row":
        strike = torch.stack([strike, strike], dim=1)[:, 0]
    elif case == "not_a_tensor":
        ann = ann.tolist()
    elif case == "strided_values":
        values = torch.cat([values, values], dim=1)[:, ::2]
    return values, fwd, strike, texp, ann, target, weight


@pytest.mark.parametrize("case", [
    "values_1d", "values_empty", "row_length", "values_float32",
    "target_float32", "weight_on_meta", "all_on_meta", "strided_row",
    "not_a_tensor", "strided_values"])
def test_wrapper_rejects_wrong_inputs(case):
    with pytest.raises((ValueError, TypeError)):
        br.black_residuals(*_bad(case), STEPS)


def _small_backend(device):
    setup = build_benchmark_calibration(num_paths=256, num_factors=2,
                                        device=device)
    return setup, StochVolKernelCalibration(setup.engine)


def test_backend_inverts_through_the_wrapper_on_cpu():
    """The backend's rows are the engine composition on the kernel's
    values, under a ``finmath.backend.implied_vol`` span that says the
    plain version ran, with no launch."""
    setup, kb = _small_backend("cpu")
    x = np.asarray(setup.covariance.initial_parameters) * 1.02
    params_b = kb.params(x)[None, :]
    values = kb._values(*kb.kernel_arguments(params_b))
    launches = br.LAUNCHES
    profiling.clear()
    with profiling.recording():
        row = kb.residuals(x)
    inverted = [r for r in profiling.spans()
                if r.name == "finmath.backend.implied_vol"]
    assert [r.attrs for r in inverted] == [{"kernel": False}]
    assert br.LAUNCHES == launches
    t = setup.engine._t
    want = _composition(values, t["fwd0"], t["strike"], t["texp"],
                        t["ann0"], t["target"], t["weight"])[0]
    np.testing.assert_array_equal(row, want.numpy())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 17])
def test_kernel_matches_plain_version_gpu(B):
    _needs_card()
    args = _inputs(B, "cuda")
    launches = br.LAUNCHES
    got = br.black_residuals(*args, STEPS)
    again = br.black_residuals(*args, STEPS)
    torch.cuda.synchronize()
    assert br.LAUNCHES == launches + 2
    assert torch.equal(got, again)
    want = br.black_residuals_reference(*args, STEPS)
    assert torch.equal(got[:, -2:], want[:, -2:])     # the zeros, exactly
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.gpu
def test_backend_one_launch_a_call_gpu():
    """A residual call and a Jacobian call each launch the kernel once, and
    their rows equal the plain path's on the same values within 1e-12."""
    _needs_card()
    setup, kb = _small_backend("cuda")
    x = np.asarray(setup.covariance.initial_parameters) * 1.02
    kb.residuals(x)                         # builds the libraries first
    t = setup.engine._t
    rows = (t["fwd0"], t["strike"], t["texp"], t["ann0"], t["target"],
            t["weight"])

    launches = br.LAUNCHES
    row = kb.residuals(x)
    assert br.LAUNCHES == launches + 1
    values = kb._values(*kb.kernel_arguments(kb.params(x)[None, :]))
    plain = br.black_residuals_reference(values, *rows, STEPS)[0]
    plain = plain.cpu().numpy()
    np.testing.assert_allclose(row, plain, rtol=0, atol=1e-12)

    launches = br.LAUNCHES
    row_j, J = kb.residuals_and_jacobian(x)
    assert br.LAUNCHES == launches + 1
    X, h = kb.fd_parameter_sets(kb.params(x))
    r = br.black_residuals_reference(
        kb._values(*kb.kernel_arguments(X)), *rows, STEPS)
    k = X.shape[1]
    np.testing.assert_allclose(row_j, r[0].cpu().numpy(), rtol=0,
                               atol=1e-12)
    J_plain = ((r[1:1 + k] - r[1 + k:]) / (2.0 * h[:, None])).T
    np.testing.assert_allclose(J, J_plain.cpu().numpy(), rtol=0,
                               atol=1e-12 / (2.0 * float(h[0])))
    launches = br.LAUNCHES
    kb.jacobian(x)
    assert br.LAUNCHES == launches + 1

    profiling.clear()
    with profiling.recording():
        kb.residuals(x)
    assert [r.attrs for r in profiling.spans()
            if r.name == "finmath.backend.implied_vol"] == [{"kernel": True}]
