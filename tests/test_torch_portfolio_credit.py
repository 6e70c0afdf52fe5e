"""The port's portfolio-credit layer
(``finmath_tpu_torch/models/portfolio_credit.py``) against finmath_tpu's,
and ``tests/test_portfolio_credit.py``'s checks on the port.

Tolerances against the JAX package:
* the host layer (thresholds, conditional PDs, the loss and count
  recursions, tranche and kth-to-default legs, the LHP closed form):
  1e-14 relative; the same NumPy float64 code (measured: equal);
* ``tranche_statistics`` on the JAX latent matrix (``latent=``): 1e-13
  relative, the float64 summation order of the loss, the mean and the
  second moment (measured 4.1e-16);
* on the JAX draws (``normals=(z, eps)``, the Threefry blocks of
  ``GaussianCopulaSimulation``'s key path): the latents within 4 float32
  ulps of each name's largest |latent| (XLA may contract ``b z + s eps``
  into a multiply-add), and the statistics within what one flipped
  indicator moves them: the largest loss over the paths for the ETL, one
  over the paths for P(count >= k) (measured: the latents equal, the
  statistics 6.9e-18 apart).
The rest are ``tests/test_portfolio_credit.py``'s cases with its sizes,
seeds and bounds, on the port's own torch stream.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models.credit import (  # noqa: E402
    SurvivalCurve, cds_par_spread)
from finmath_tpu_torch.models.curves import DiscountCurve  # noqa: E402
from finmath_tpu_torch.models.multi_asset import (  # noqa: E402
    bivariate_normal_cdf)
from finmath_tpu_torch.models.portfolio_credit import (  # noqa: E402
    GaussianCopulaPortfolio, GaussianCopulaSimulation,
    lhp_expected_tranche_loss)

CPU = "cpu"
T_GRID = np.arange(0.0, 31.0)
DC = DiscountCurve(T_GRID, np.exp(-0.03 * T_GRID))
CURVE = SurvivalCurve([0.0], [0.02])
PD5 = float(1.0 - CURVE.get_survival_probability(5.0))
#: the JAX parity simulation: paths, seed, horizons, tranche, ranks
MC_PATHS, MC_SEED = 20_000, 3
MC_TIMES, MC_TRANCHE, MC_KS = [1.0, 3.0, 5.0], (0.03, 0.07), (1, 5, 10)


def homogeneous(n, beta=0.5, recovery=0.4):
    return GaussianCopulaPortfolio([CURVE] * n, betas=beta,
                                   recoveries=recovery, notionals=1.0 / n)


def _heterogeneous_jax():
    """A 20-name JAX pool with heterogeneous hazards and betas (as
    ``bench_portfolio_credit`` draws them, at 20 names)."""
    from finmath_tpu.models.credit import SurvivalCurve as JaxCurve
    from finmath_tpu.models.portfolio_credit import GaussianCopulaPortfolio

    rng = np.random.default_rng(1)
    n = 20
    curves = [JaxCurve([0.0], [h]) for h in rng.uniform(0.005, 0.06, n)]
    return GaussianCopulaPortfolio(curves, betas=rng.uniform(0.3, 0.7, n),
                                   recoveries=0.4, notionals=1.0 / n)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX simulation on the 50-name homogeneous pool (its latent
    matrix, its draws rebuilt from the key path, its statistics) and the
    JAX heterogeneous pool, once."""
    import jax
    import jax.numpy as jnp

    from finmath_tpu.models.credit import SurvivalCurve as JaxCurve
    from finmath_tpu.models.portfolio_credit import (
        GaussianCopulaPortfolio as JaxPortfolio,
        GaussianCopulaSimulation as JaxSimulation)

    pf = JaxPortfolio([JaxCurve([0.0], [0.02])] * 50, betas=0.5,
                      recoveries=0.4, notionals=1.0 / 50)
    sim = JaxSimulation(pf, num_paths=MC_PATHS, seed=MC_SEED)
    stats = sim.tranche_statistics(MC_TIMES, *MC_TRANCHE, ks=MC_KS)
    # GaussianCopulaSimulation's draws: (kz, ke) = split(PRNGKey(seed)),
    # z = normal(kz, (1, half)), eps = normal(ke, (names, half)), float32
    kz, ke = jax.random.split(jax.random.PRNGKey(MC_SEED))
    half = MC_PATHS // 2
    z = np.asarray(jax.random.normal(kz, (1, half), dtype=jnp.float32))
    eps = np.asarray(jax.random.normal(ke, (50, half), dtype=jnp.float32))
    return {"portfolio": pf, "latent": np.asarray(sim._lat),
            "stats": stats, "normals": (z, eps),
            "heterogeneous": _heterogeneous_jax()}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def test_host_layer_matches_jax(jax_side):
    from finmath_tpu.models.curves import DiscountCurve as JaxDC
    from finmath_tpu.models.portfolio_credit import (
        lhp_expected_tranche_loss as jax_lhp)

    jpf = jax_side["heterogeneous"]
    pf = convert.copula_portfolio_from_jax(jpf)
    jdc = JaxDC(T_GRID, np.exp(-0.03 * T_GRID))
    z = np.linspace(-3.0, 3.0, 7)
    checks = [
        (pf.default_thresholds(5.0), jpf.default_thresholds(5.0)),
        (pf.conditional_pd(3.0, z), jpf.conditional_pd(3.0, z)),
        (pf.loss_distribution(5.0, unit=0.6 / 20)[1],
         jpf.loss_distribution(5.0, unit=0.6 / 20)[1]),
        (pf.default_count_distribution(5.0),
         jpf.default_count_distribution(5.0)),
        (pf.expected_tranche_loss(5.0, 0.03, 0.07),
         jpf.expected_tranche_loss(5.0, 0.03, 0.07)),
        (pf.kth_to_default_probability(5.0, 3),
         jpf.kth_to_default_probability(5.0, 3)),
        (pf.tranche_legs(DC, 0.03, 0.07, 5.0),
         jpf.tranche_legs(jdc, 0.03, 0.07, 5.0)),
        (pf.kth_to_default_legs(DC, 2, 5.0),
         jpf.kth_to_default_legs(jdc, 2, 5.0)),
        (lhp_expected_tranche_loss(PD5, 0.5, 0.03, 0.07, 0.4),
         jax_lhp(PD5, 0.5, 0.03, 0.07, 0.4)),
    ]
    for i, (got, want) in enumerate(checks):
        assert _rel(got, want) <= 1e-14, i


def test_statistics_on_the_jax_latent(jax_side):
    pf = convert.copula_portfolio_from_jax(jax_side["portfolio"])
    sim = GaussianCopulaSimulation(pf, num_paths=MC_PATHS, device=CPU,
                                   latent=jax_side["latent"])
    got = sim.tranche_statistics(MC_TIMES, *MC_TRANCHE, ks=MC_KS)
    for key, want in jax_side["stats"].items():
        assert got[key].shape == want.shape
        assert _rel(got[key], want) <= 1e-13, key


def test_statistics_on_the_jax_draws(jax_side):
    pf = convert.copula_portfolio_from_jax(jax_side["portfolio"])
    sim = GaussianCopulaSimulation(pf, num_paths=MC_PATHS, seed=MC_SEED,
                                   device=CPU, normals=jax_side["normals"])
    lat, want_lat = sim._lat.numpy(), jax_side["latent"]
    assert lat.dtype == np.float32 and lat.shape == want_lat.shape
    ulp = np.spacing(np.max(np.abs(want_lat), axis=1))[:, None]
    assert np.all(np.abs(lat.astype(np.float64) - want_lat) <= 4 * ulp)
    got = sim.tranche_statistics(MC_TIMES, *MC_TRANCHE, ks=MC_KS)
    want = jax_side["stats"]
    one_flip = np.max(pf.losses) / MC_PATHS
    assert np.all(np.abs(got["etl"] - want["etl"]) <= one_flip)
    assert np.all(np.abs(got["kth_prob"] - want["kth_prob"])
                  <= 1.0 / MC_PATHS)


# ---------------------------------------------------------------------------
# tests/test_portfolio_credit.py's checks on the port
# ---------------------------------------------------------------------------

class TestExactRecursion:
    def test_independence_limit_is_binomial(self):
        pmf = homogeneous(50, beta=0.0).default_count_distribution(5.0)
        binom = np.array([math.comb(50, k) * PD5 ** k
                          * (1 - PD5) ** (50 - k) for k in range(51)])
        assert np.max(np.abs(pmf - binom)) < 1e-14

    def test_expected_loss_is_beta_invariant(self):
        for beta in (0.0, 0.3, 0.8):
            grid, pmf = homogeneous(40, beta=beta).loss_distribution(5.0)
            assert abs(np.sum(pmf) - 1.0) < 1e-12
            assert abs(float(np.sum(grid * pmf)) - 0.6 * PD5) < 1e-12

    def test_comonotone_limit(self):
        pmf = homogeneous(20, beta=0.99999).default_count_distribution(5.0)
        assert abs(pmf[0] - (1 - PD5)) < 5e-3
        assert abs(pmf[-1] - PD5) < 5e-3
        assert np.sum(pmf[1:-1]) < 5e-3

    def test_two_name_bivariate_oracle(self):
        pf = GaussianCopulaPortfolio([CURVE] * 2, betas=[0.6, 0.3],
                                     recoveries=0.4)
        c = pf.default_thresholds(5.0)
        both = bivariate_normal_cdf(float(c[0]), float(c[1]), 0.6 * 0.3)
        assert abs(pf.kth_to_default_probability(5.0, 1)
                   - (2 * PD5 - both)) < 1e-12
        assert abs(pf.kth_to_default_probability(5.0, 2) - both) < 1e-12

    def test_heterogeneous_pool_unit_guard(self):
        pf = GaussianCopulaPortfolio([CURVE] * 2, betas=0.4, recoveries=0.4,
                                     notionals=[1.0, 1.7])
        with pytest.raises(ValueError, match="integer multiples"):
            pf.loss_distribution(5.0)
        grid, pmf = pf.loss_distribution(5.0, unit=0.06)
        assert abs(np.sum(pmf) - 1.0) < 1e-12
        assert abs(float(np.sum(grid * pmf)) - (0.6 + 1.02) * PD5) < 1e-12

    def test_lhp_limit(self):
        lhp = lhp_expected_tranche_loss(PD5, 0.5, 0.03, 0.07, 0.4)
        errs = [abs(homogeneous(n).expected_tranche_loss(5.0, 0.03, 0.07)
                    - lhp) for n in (50, 800)]
        assert errs[1] < errs[0]
        assert errs[1] < 5e-5

    def test_validation(self):
        with pytest.raises(ValueError):
            GaussianCopulaPortfolio([CURVE], betas=1.0)
        with pytest.raises(ValueError):
            GaussianCopulaPortfolio([CURVE], betas=0.5, recoveries=1.0)
        with pytest.raises(ValueError):
            GaussianCopulaPortfolio([CURVE], betas=0.5, notionals=0.0)
        pf = homogeneous(5)
        with pytest.raises(ValueError):
            pf.expected_tranche_loss(5.0, 0.07, 0.03)
        with pytest.raises(ValueError):
            pf.kth_to_default_probability(5.0, 6)
        with pytest.raises(ValueError):
            lhp_expected_tranche_loss(PD5, 1.2, 0.0, 0.03)


class TestLegPricing:
    def test_tranche_spread_ordering(self):
        pf = homogeneous(100)
        eq = pf.tranche_par_spread(DC, 0.00, 0.03, 5.0)
        mez = pf.tranche_par_spread(DC, 0.03, 0.07, 5.0)
        sen = pf.tranche_par_spread(DC, 0.07, 0.15, 5.0)
        assert eq > mez > sen > 0

    def test_correlation_moves_risk_up_the_capital_structure(self):
        lo, hi = homogeneous(100, beta=0.2), homogeneous(100, beta=0.7)
        assert hi.expected_tranche_loss(5.0, 0.0, 0.03) \
            < lo.expected_tranche_loss(5.0, 0.0, 0.03)
        assert hi.expected_tranche_loss(5.0, 0.07, 0.30) \
            > lo.expected_tranche_loss(5.0, 0.07, 0.30)

    def test_whole_capital_structure_reprices_the_index(self):
        pf = homogeneous(50)
        cuts = [0.0, 0.03, 0.07, 0.15, 0.6]
        prot = sum(pf.tranche_legs(DC, a, d, 5.0)[0]
                   for a, d in zip(cuts[:-1], cuts[1:]))
        assert abs(prot - pf.tranche_legs(DC, 0.0, 0.6, 5.0)[0]) < 1e-12

    def test_kth_to_default_ordering_and_legs(self):
        pf = GaussianCopulaPortfolio([CURVE] * 5, betas=0.4, recoveries=0.4)
        spreads = []
        for k in (1, 2, 3):
            p, a = pf.kth_to_default_legs(DC, k, 5.0)
            assert p > 0 and a > 0
            spreads.append(p / a)
        assert spreads[0] > spreads[1] > spreads[2]
        single = cds_par_spread(DC, CURVE, 5.0, recovery=0.4)
        assert single < spreads[0] < 5 * single


class TestMonteCarlo:
    @pytest.fixture(scope="class")
    def setup(self):
        pf = homogeneous(50)
        sim = GaussianCopulaSimulation(pf, num_paths=100_000, seed=3,
                                       antithetic=True, device=CPU)
        return pf, sim

    def test_etl_matches_exact(self, setup):
        pf, sim = setup
        times = [1.0, 3.0, 5.0]
        st = sim.tranche_statistics(times, 0.03, 0.07, ks=(1, 5))
        for i, t in enumerate(times):
            ex = pf.expected_tranche_loss(t, 0.03, 0.07)
            assert abs(st["etl"][i] - ex) < 4 * st["etl_stderr"][i] + 1e-6

    def test_kth_prob_matches_exact(self, setup):
        pf, sim = setup
        st = sim.tranche_statistics([5.0], 0.0, 0.03, ks=(1, 5, 10))
        for j, k in enumerate((1, 5, 10)):
            ex = pf.kth_to_default_probability(5.0, k)
            se = math.sqrt(ex * (1 - ex) / 100_000)
            assert abs(st["kth_prob"][0, j] - ex) < 5 * se + 1e-4

    def test_pathwise_monotone_in_time(self, setup):
        _, sim = setup
        st = sim.tranche_statistics(np.arange(1.0, 8.0), 0.0, 0.10, ks=(3,))
        assert np.all(np.diff(st["etl"]) > -1e-15)
        assert np.all(np.diff(st["kth_prob"][:, 0]) > -1e-15)

    def test_no_ranks(self, setup):
        _, sim = setup
        st = sim.tranche_statistics([2.0, 4.0], 0.0, 0.03)
        assert st["kth_prob"].shape == (2, 0)
        assert st["etl"].shape == st["etl_stderr"].shape == (2,)

    def test_validation(self, setup):
        pf, sim = setup
        with pytest.raises(ValueError):
            GaussianCopulaSimulation(pf, num_paths=101, antithetic=True,
                                     device=CPU)
        with pytest.raises(ValueError):
            sim.tranche_statistics([5.0], 0.07, 0.03)
        with pytest.raises(NotImplementedError):
            GaussianCopulaSimulation(pf, num_paths=100, mesh=object(),
                                     device=CPU)
        with pytest.raises(ValueError, match="normals eps"):
            GaussianCopulaSimulation(pf, num_paths=100, device=CPU,
                                     normals=(np.zeros((1, 50)),
                                              np.zeros((49, 50))))


@pytest.mark.gpu
def test_statistics_on_card_match_cpu():
    """``tranche_statistics`` on the card against the CPU on one latent
    matrix: within 1e-13 relative (the card sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pf = homogeneous(125)
    cpu = GaussianCopulaSimulation(pf, num_paths=200_000, seed=7, device=CPU)
    card = GaussianCopulaSimulation(pf, num_paths=200_000, device="cuda",
                                    latent=cpu._lat.cuda())
    got = card.tranche_statistics(np.arange(1.0, 11.0), 0.03, 0.07,
                                  ks=(1, 5, 10))
    want = cpu.tranche_statistics(np.arange(1.0, 11.0), 0.03, 0.07,
                                  ks=(1, 5, 10))
    for key in want:
        assert np.max(np.abs(got[key] - want[key])) \
            <= 1e-13 * np.max(np.abs(want[key])), key
