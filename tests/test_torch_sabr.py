"""The port's SABR module (``finmath_tpu_torch/models/sabr.py``) against
finmath_tpu's, and the JAX package's own cases (``tests/test_sabr.py``)
on the port.

Tolerances:
* the Hagan expansions (host float64, the same arithmetic) and the
  calibrated parameters: within 1e-12 relative (measured: equal bit for
  bit);
* the torch twin against the JAX twin, values and autograd gradients:
  within 1e-12 relative (values measured equal to 1.1e-16);
* ``_sabr_terminal`` on the JAX normals (``k1, k2 = split(PRNGKey(3))``,
  ``normal(k, (64, 10,000))`` each, mirrored): the same paths absorbed,
  and every terminal value within 1e-5 of max(|X_T|, X_0) (measured
  1.2e-6). Both simulators are float32 over 64 steps, and the two
  libraries' ``exp`` and ``pow`` round differently in the last bit; the
  local vol X^(beta - 1) grows near the absorbing barrier, where the
  relative gap of a path grows with it (4.1e-5 measured at X_T =
  1.8e-5), so the bound is relative to the forward's own scale. Prices,
  float64 means: within 1e-7 absolute (measured 9.2e-11).
The Monte-Carlo cases run on the port's own stream at the JAX tests'
bounds."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.sabr import (  # noqa: E402
    SABRParams,
    _sabr_terminal,
    calibrate_sabr,
    mc_sabr_implied_vols,
    mc_sabr_option_prices,
    sabr_lognormal_implied_volatility,
    sabr_normal_implied_volatility,
    torch_sabr_lognormal_implied_volatility,
)

F, T = 0.03, 2.0
KS = np.array([0.015, 0.02, 0.025, 0.03, 0.04, 0.05])
P = SABRParams(alpha=0.035, beta=0.5, rho=-0.3, nu=0.4)
CASES = [P, SABRParams(alpha=0.25, beta=1.0, rho=0.0, nu=0.0),
         SABRParams(alpha=0.01, beta=0.0, rho=0.3, nu=0.2),
         SABRParams(alpha=0.03, beta=0.7, rho=-0.6, nu=0.8,
                    displacement=0.01)]
PATHS, STEPS, SEED = 20_000, 64, 3
CPU = "cpu"


@pytest.fixture(scope="module")
def jsabr():
    from finmath_tpu.models import sabr
    return sabr


def _jparams(jsabr, p):
    return jsabr.SABRParams(p.alpha, p.beta, p.rho, p.nu, p.displacement)


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(CASES)))
def test_hagan_expansions_match_jax(jsabr, case):
    p = CASES[case]
    jp = _jparams(jsabr, p)
    for fn, jfn in ((sabr_lognormal_implied_volatility,
                     jsabr.sabr_lognormal_implied_volatility),
                    (sabr_normal_implied_volatility,
                     jsabr.sabr_normal_implied_volatility)):
        got = np.array([fn(p, F, k, T) for k in KS])
        ref = np.array([jfn(jp, F, k, T) for k in KS])
        np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("case", [0, 2, 3])
def test_torch_twin_and_gradient_match_jax(jsabr, case):
    import jax
    import jax.numpy as jnp

    p = CASES[case]
    ks = np.concatenate([KS, [F, F + 1e-9]])    # ATM and the series branch
    args = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for v in (p.alpha, p.beta, p.rho, p.nu)]
    twin = torch_sabr_lognormal_implied_volatility(
        *args, F, torch.tensor(ks), T, p.displacement)
    grads = torch.autograd.grad(twin.sum(), args)

    def jtwin(a, b, r, n):
        return jsabr.jnp_sabr_lognormal_implied_volatility(
            a, b, r, n, F, jnp.asarray(ks), T, p.displacement)

    ref = np.asarray(jtwin(p.alpha, p.beta, p.rho, p.nu))
    jgrads = jax.grad(lambda *a: jnp.sum(jtwin(*a)), argnums=(0, 1, 2, 3))(
        p.alpha, p.beta, p.rho, p.nu)
    np.testing.assert_allclose(twin.detach().numpy(), ref, rtol=1e-12)
    for g, jg in zip(grads, jgrads):
        assert np.isfinite(float(g))
        assert float(g) == pytest.approx(float(jg), rel=1e-12, abs=1e-15)


@pytest.fixture(scope="module")
def jax_terminal(jsabr):
    """The JAX simulator's terminal values and its mirrored normals."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(SEED))
    half = PATHS // 2
    z = [np.asarray(jax.random.normal(k, (STEPS, half), dtype=jnp.float32))
         for k in (k1, k2)]
    z = [np.concatenate([a, -a], axis=1) for a in z]
    x = np.asarray(jsabr._sabr_terminal(
        jax.random.PRNGKey(SEED), PATHS, STEPS, jnp.float32(F),
        jnp.float32(P.alpha), jnp.float32(P.beta), jnp.float32(P.rho),
        jnp.float32(P.nu), jnp.float32(T / STEPS), True))
    return x, z


def test_sabr_terminal_on_the_jax_normals(jax_terminal):
    xj, z = jax_terminal
    xt = _sabr_terminal(SEED, PATHS, STEPS, F, P.alpha, P.beta, P.rho, P.nu,
                        T / STEPS, True, normals=z, device=CPU)
    assert xt.dtype == torch.float32 and xt.shape == (PATHS,)
    xt = xt.numpy()
    np.testing.assert_array_equal(xt == 0.0, xj == 0.0)
    scale = np.maximum(np.abs(xj), np.float32(F))
    assert np.max(np.abs(xt - xj) / scale) < 1e-5
    ks = np.array([0.025, 0.03, 0.035])
    prices = [np.mean(np.maximum(x.astype(np.float64)[None, :]
                                 - ks[:, None], 0.0), axis=1)
              for x in (xt, xj)]
    np.testing.assert_allclose(prices[0], prices[1], rtol=0.0, atol=1e-7)


def test_own_stream_is_the_generators_mirrored_draws():
    """Without ``normals`` the simulator draws two [steps, paths / 2]
    blocks from ``torch.Generator(device).manual_seed(seed)`` and mirrors
    them: the same blocks injected give the same paths bit for bit."""
    gen = torch.Generator(device=CPU).manual_seed(11)
    z = [torch.randn((16, 500), generator=gen, dtype=torch.float32)
         for _ in range(2)]
    z = [torch.cat([a, -a], dim=1) for a in z]
    own = _sabr_terminal(11, 1000, 16, F, P.alpha, P.beta, P.rho, P.nu,
                         T / 16, True, device=CPU)
    injected = _sabr_terminal(11, 1000, 16, F, P.alpha, P.beta, P.rho,
                              P.nu, T / 16, True, normals=z, device=CPU)
    assert torch.equal(own, injected)
    with pytest.raises(ValueError, match="normals"):
        _sabr_terminal(11, 1000, 16, F, P.alpha, P.beta, P.rho, P.nu,
                       T / 16, True, normals=[a[:, :10] for a in z],
                       device=CPU)


@pytest.mark.parametrize("quote_type,case", [("lognormal", 0),
                                             ("normal", 3)])
def test_calibration_matches_jax(jsabr, quote_type, case):
    p = CASES[case]
    fn = (sabr_lognormal_implied_volatility if quote_type == "lognormal"
          else sabr_normal_implied_volatility)
    target = np.array([fn(p, F, k, T) for k in KS])
    kw = dict(quote_type=quote_type, beta=p.beta,
              displacement=p.displacement)
    got = calibrate_sabr(F, T, KS, target, **kw)
    ref = jsabr.calibrate_sabr(F, T, KS, target, **kw)
    np.testing.assert_allclose(
        [got.params.alpha, got.params.rho, got.params.nu],
        [ref.params.alpha, ref.params.rho, ref.params.nu], rtol=1e-12)
    assert got.iterations == ref.iterations
    assert got.converged == ref.converged


# ---------------------------------------------------------------------------
# the JAX package's own cases (tests/test_sabr.py) on the port
# ---------------------------------------------------------------------------

class TestHaganExpansion:
    def test_beta_one_nu_zero_is_flat_black(self):
        p = SABRParams(alpha=0.25, beta=1.0, rho=0.0, nu=0.0)
        for k in KS:
            assert abs(sabr_lognormal_implied_volatility(p, F, k, T)
                       - 0.25) < 1e-12

    def test_beta_zero_nu_zero_is_flat_normal(self):
        p = SABRParams(alpha=0.01, beta=0.0, rho=0.0, nu=0.0)
        for k in KS:
            assert abs(sabr_normal_implied_volatility(p, F, k, T)
                       - 0.01) < 1e-10

    def test_torch_twin_matches_host(self):
        host = np.array([sabr_lognormal_implied_volatility(P, F, k, T)
                         for k in KS])
        twin = torch_sabr_lognormal_implied_volatility(
            P.alpha, P.beta, P.rho, P.nu, F, torch.tensor(KS), T).numpy()
        assert np.abs(host - twin).max() < 1e-12

    def test_torch_twin_atm_branch_finite_gradient(self):
        a = torch.tensor(0.035, dtype=torch.float64, requires_grad=True)
        v = torch_sabr_lognormal_implied_volatility(
            a, 0.5, -0.3, 0.4, F, torch.tensor(F, dtype=torch.float64), T)
        (g,) = torch.autograd.grad(v, a)
        assert np.isfinite(float(g)) and float(g) > 0.0

    def test_negative_rho_skews_down(self):
        lo = sabr_lognormal_implied_volatility(P, F, 0.02, T)
        atm = sabr_lognormal_implied_volatility(P, F, F, T)
        assert lo > atm

    def test_displacement_shifts_both(self):
        pd = SABRParams(alpha=P.alpha, beta=P.beta, rho=P.rho, nu=P.nu,
                        displacement=0.02)
        v1 = sabr_lognormal_implied_volatility(pd, F, 0.02, T)
        v2 = sabr_lognormal_implied_volatility(
            SABRParams(P.alpha, P.beta, P.rho, P.nu), F + 0.02,
            0.02 + 0.02, T)
        assert abs(v1 - v2) < 1e-14

    def test_param_validation(self):
        with pytest.raises(ValueError):
            SABRParams(alpha=0.03, beta=1.5, rho=0.0, nu=0.3)
        with pytest.raises(ValueError):
            SABRParams(alpha=0.03, beta=0.5, rho=1.0, nu=0.3)
        with pytest.raises(ValueError):
            SABRParams(alpha=-0.1, beta=0.5, rho=0.0, nu=0.3)
        with pytest.raises(ValueError):
            SABRParams(alpha=0.03, beta=0.5, rho=0.0, nu=0.3,
                       displacement=-0.01)


class TestMonteCarlo:
    def test_martingale(self):
        _, fwd = mc_sabr_option_prices(P, F, T, KS, num_paths=200_000,
                                       num_steps=32, seed=3, device=CPU)
        assert abs(fwd - F) < 3e-4

    def test_implied_smile_matches_hagan_near_atm(self):
        ks = np.array([0.025, 0.03, 0.035])
        mc = mc_sabr_implied_vols(P, F, T, ks, num_paths=200_000,
                                  num_steps=64, seed=5, device=CPU)
        hagan = np.array([sabr_lognormal_implied_volatility(P, F, k, T)
                          for k in ks])
        assert np.abs(mc - hagan).max() < 0.006     # vol points

    def test_normal_quote_convention(self):
        ks = np.array([0.028, 0.03, 0.032])
        mc = mc_sabr_implied_vols(P, F, T, ks, quote_type="normal",
                                  num_paths=200_000, num_steps=64, seed=5,
                                  device=CPU)
        hagan = np.array([sabr_normal_implied_volatility(P, F, k, T)
                          for k in ks])
        assert np.abs(mc - hagan).max() < 3e-4      # normal vol units

    def test_prices_monotone_in_strike(self):
        prices, _ = mc_sabr_option_prices(P, F, T, KS, num_paths=100_000,
                                          num_steps=32, seed=7, device=CPU)
        assert np.all(np.diff(prices) < 0.0)


class TestCalibration:
    def test_lognormal_round_trip(self):
        target = np.array([sabr_lognormal_implied_volatility(P, F, k, T)
                           for k in KS])
        fit = calibrate_sabr(F, T, KS, target, beta=0.5)
        assert fit.converged or fit.rms_vol_error < 1e-8
        assert abs(fit.params.alpha - P.alpha) < 1e-5
        assert abs(fit.params.rho - P.rho) < 1e-4
        assert abs(fit.params.nu - P.nu) < 1e-4

    def test_normal_displaced_round_trip(self):
        pd = SABRParams(alpha=0.03, beta=0.5, rho=0.2, nu=0.3,
                        displacement=0.01)
        target = np.array([sabr_normal_implied_volatility(pd, F, k, T)
                           for k in KS])
        fit = calibrate_sabr(F, T, KS, target, quote_type="normal",
                             beta=0.5, displacement=0.01)
        assert fit.rms_vol_error < 1e-8
        assert not math.isnan(fit.params.alpha)

    def test_validation(self):
        with pytest.raises(ValueError):
            calibrate_sabr(F, T, KS, np.ones_like(KS), quote_type="mid")
        with pytest.raises(ValueError):
            calibrate_sabr(F, T, KS[:2], np.ones(2))
