"""The port's Schwartz-Smith layer (``finmath_tpu_torch/models/commodity.py``)
against finmath_tpu's, and ``tests/test_commodity.py``'s checks on the port.

Tolerances against the JAX package:
* the host layer (futures curve, log-futures covariances, Black-76 options
  on futures, Margrabe): 1e-14 relative, the same NumPy float64 code
  (measured: equal);
* the factor histories on the JAX draws (``_ss_scan``'s Threefry normals,
  rebuilt from its key path and injected): within 4 float32 ulps of each
  step's largest |value| (XLA may contract ``chi e^{-k dt} + a z1`` into a
  multiply-add on the CPU; measured 3 ulps);
* futures, options and the calendar spread on the JAX histories: 1e-12
  relative (float64 sums in another order; XLA's ``exp`` is not torch's;
  measured 1.7e-14);
  the spot's realizations within one float32 ulp.
The rest are ``tests/test_commodity.py``'s cases with its sizes, seeds and
bounds, on the port's own torch stream.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models.commodity import (  # noqa: E402
    SchwartzSmithModel, SchwartzSmithSimulation)
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

CPU = "cpu"
BASE = dict(chi0=0.1, xi0=math.log(60.0), kappa=1.5, sigma_chi=0.35,
            sigma_xi=0.15, rho=0.3, mu_star=0.01, lambda_chi=0.05)
#: the JAX parity simulation: steps (monthly), paths, seed
PAR_STEPS, PAR_PATHS, PAR_SEED = 24, 4_000, 2
MATS, STRIKES = [1.5, 2.0, 3.0, 5.0], [55.0, 65.0, 75.0]


def make_model(**kw):
    return SchwartzSmithModel(**{**BASE, **kw})


def _grid(steps=PAR_STEPS):
    return TimeDiscretization(initial=0.0, num_steps=steps, step=1 / 12)


def ss_stream(seed, steps, paths):
    """``_ss_scan``'s normals: ``split(PRNGKey(seed), steps)``, each step's
    key split into (k1, k2); ``normal(k_i, (half,), float32)``; the
    ``[steps, half]`` blocks before the mirror."""
    import jax
    import jax.numpy as jnp

    z1, z2 = [], []
    for k in jax.random.split(jax.random.PRNGKey(seed), steps):
        k1, k2 = jax.random.split(k)
        z1.append(np.asarray(jax.random.normal(k1, (paths // 2,),
                                               dtype=jnp.float32)))
        z2.append(np.asarray(jax.random.normal(k2, (paths // 2,),
                                               dtype=jnp.float32)))
    return np.stack(z1), np.stack(z2)


def _prices(sim):
    return {
        "futures": sim.mc_futures_prices(1.0, MATS),
        "calls": sim.mc_option_on_future(1.0, 2.0, STRIKES, 0.97),
        "puts": sim.mc_option_on_future(1.0, 2.0, STRIKES, 0.97,
                                        is_call=False),
        "spread": sim.mc_calendar_spread(1.0, 1.5, 2.0, 0.0, 0.97),
        "struck_spread": sim.mc_calendar_spread(1.0, 1.5, 2.0, 1.0, 0.97),
    }


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model and simulation (its histories, prices and spot), and
    its draws, once."""
    from finmath_tpu.models.commodity import (
        SchwartzSmithModel as JaxModel,
        SchwartzSmithSimulation as JaxSimulation)
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JaxTD)

    model = JaxModel(**BASE)
    sim = JaxSimulation(model, JaxTD(initial=0.0, num_steps=PAR_STEPS,
                                     step=1 / 12),
                        num_paths=PAR_PATHS, seed=PAR_SEED)
    return {"model": model, "chis": np.array(sim._chis),
            "xis": np.array(sim._xis), "prices": _prices(sim),
            "spot": sim.spot(1.0).get_realizations(),
            "normals": ss_stream(PAR_SEED, PAR_STEPS, PAR_PATHS)}


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _within_ulps(got, want, n):
    want = np.asarray(want, dtype=np.float64)
    ulp = np.spacing(np.max(np.abs(want), axis=1).astype(np.float32))
    return np.all(np.abs(np.asarray(got, dtype=np.float64) - want)
                  <= n * ulp.astype(np.float64)[:, None])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_host_layer_matches_jax(jax_side):
    jm = jax_side["model"]
    m = convert.schwartz_smith_model_from_jax(jm)
    mats = np.array([0.0, 0.5, 1.0, 2.0, 10.0])
    assert _rel(m.futures_price(mats), jm.futures_price(mats)) <= 1e-14
    for got, want in (
            (m.log_futures_covariance(1.0, 1.5, 3.0),
             jm.log_futures_covariance(1.0, 1.5, 3.0)),
            (m.option_on_future(1.0, 2.0, 62.0, 0.97),
             jm.option_on_future(1.0, 2.0, 62.0, 0.97)),
            (m.option_on_future(1.0, 2.0, 62.0, 0.97, is_call=False),
             jm.option_on_future(1.0, 2.0, 62.0, 0.97, is_call=False)),
            (m.calendar_spread_margrabe(1.0, 1.5, 2.0, 0.97),
             jm.calendar_spread_margrabe(1.0, 1.5, 2.0, 0.97))):
        assert abs(got - want) <= 1e-14 * abs(want)


def test_histories_on_the_jax_draws(jax_side):
    m = convert.schwartz_smith_model_from_jax(jax_side["model"])
    sim = SchwartzSmithSimulation(m, _grid(), num_paths=PAR_PATHS,
                                  seed=PAR_SEED, device=CPU,
                                  normals=jax_side["normals"])
    for got, want in ((sim._chis, jax_side["chis"]),
                      (sim._xis, jax_side["xis"])):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape == (PAR_STEPS + 1, PAR_PATHS)
        assert _within_ulps(got.numpy(), want, 4)


def test_pricers_on_the_jax_histories(jax_side):
    m = convert.schwartz_smith_model_from_jax(jax_side["model"])
    sim = SchwartzSmithSimulation(m, _grid(), num_paths=PAR_PATHS,
                                  seed=PAR_SEED, device=CPU)
    sim._chis = torch.as_tensor(jax_side["chis"])
    sim._xis = torch.as_tensor(jax_side["xis"])
    got = _prices(sim)
    for key, want in jax_side["prices"].items():
        for g, w in zip(got[key], want):
            assert _rel(g, w) <= 1e-12, key
    spot = sim.spot(1.0).get_realizations()
    want = jax_side["spot"]
    assert np.all(np.abs(spot.astype(np.float64) - want)
                  <= np.spacing(np.abs(want).astype(np.float32)))


# ---------------------------------------------------------------------------
# tests/test_commodity.py's checks on the port
# ---------------------------------------------------------------------------

class TestAnalytic:
    def test_futures_limits(self):
        m = make_model()
        assert np.isclose(float(m.futures_price(0.0)),
                          math.exp(0.1 + math.log(60.0)))
        f10 = float(m.futures_price(10.0))
        assert abs(f10 / float(make_model(chi0=0.0).futures_price(10.0))
                   - 1.0) < 1e-6

    def test_samuelson_effect(self):
        m = make_model()
        assert m.log_futures_variance(1.0, 1.25) \
            > m.log_futures_variance(1.0, 5.0)

    def test_option_put_call_parity(self):
        m = make_model()
        f = float(m.futures_price(2.0))
        for k in (50.0, 60.0, 70.0):
            c = m.option_on_future(1.0, 2.0, k, 0.97)
            p = m.option_on_future(1.0, 2.0, k, 0.97, is_call=False)
            assert abs((c - p) - 0.97 * (f - k)) < 1e-12

    def test_margrabe_degenerate(self):
        assert make_model().calendar_spread_margrabe(1.0, 2.0, 2.0) < 1e-10

    def test_validation(self):
        with pytest.raises(ValueError):
            make_model(kappa=-1.0)
        with pytest.raises(ValueError):
            make_model(rho=1.0)
        m = make_model()
        with pytest.raises(ValueError):
            m.option_on_future(2.0, 1.0, 60.0)
        with pytest.raises(ValueError):
            m.log_futures_variance(2.0, 1.0)


class TestSimulation:
    @pytest.fixture(scope="class")
    def sim(self):
        return SchwartzSmithSimulation(make_model(), _grid(24),
                                       num_paths=200_000, seed=2,
                                       device=CPU)

    def test_futures_martingale(self, sim):
        p, se = sim.mc_futures_prices(1.0, MATS)
        for t, pp, s in zip(MATS, p, se):
            f0 = float(sim.model.futures_price(t))
            assert abs(pp - f0) < 4 * s + 1e-9, (t, pp, f0)

    def test_spot_expectation(self, sim):
        s1 = sim.spot(1.0)
        f0 = float(sim.model.futures_price(1.0))
        assert abs(s1.get_average() - f0) < 4 * s1.get_standard_error()

    def test_option_vs_black(self, sim):
        m = sim.model
        for is_call in (True, False):
            pr, se = sim.mc_option_on_future(1.0, 2.0, STRIKES, 0.97,
                                             is_call=is_call)
            for k, pp, s in zip(STRIKES, pr, se):
                cf = m.option_on_future(1.0, 2.0, k, 0.97, is_call=is_call)
                assert abs(pp - cf) < 4.5 * s + 1e-6, (k, pp, cf)

    def test_calendar_spread_vs_margrabe(self, sim):
        m = sim.model
        sp, se = sim.mc_calendar_spread(1.0, 1.5, 2.0, 0.0, 0.97)
        mg = m.calendar_spread_margrabe(1.0, 1.5, 2.0, 0.97)
        assert abs(sp - mg) < 4.5 * se + 1e-6
        sp_k, _ = sim.mc_calendar_spread(1.0, 1.5, 2.0, 1.0, 0.97)
        assert sp_k < sp

    def test_validation(self, sim):
        with pytest.raises(ValueError, match="not on the simulation"):
            sim.spot(0.99)
        with pytest.raises(ValueError):
            sim.mc_futures_prices(1.0, [0.5])
        td = TimeDiscretization(initial=0.0, num_steps=4, step=0.25)
        with pytest.raises(ValueError):
            SchwartzSmithSimulation(make_model(), td, num_paths=101,
                                    antithetic=True, device=CPU)
        with pytest.raises(NotImplementedError):
            SchwartzSmithSimulation(make_model(), td, num_paths=100,
                                    mesh=object(), device=CPU)
        with pytest.raises(ValueError, match="normals z2"):
            SchwartzSmithSimulation(make_model(), td, num_paths=100,
                                    device=CPU,
                                    normals=(np.zeros((4, 50)),
                                             np.zeros((3, 50))))


@pytest.mark.gpu
def test_simulation_on_card_matches_cpu():
    """One normal block on the card and on the CPU: the histories within 4
    float32 ulps of each step's largest value, the prices within 1e-12
    relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(5)
    normals = tuple(torch.randn((24, 100_000), generator=g)
                    for _ in range(2))
    sims = [SchwartzSmithSimulation(make_model(), _grid(24),
                                    num_paths=200_000, device=dev,
                                    normals=normals)
            for dev in (CPU, "cuda")]
    for a, b in ((sims[0]._chis, sims[1]._chis),
                 (sims[0]._xis, sims[1]._xis)):
        assert _within_ulps(b.cpu().numpy(), a.numpy(), 4)
    want, got = _prices(sims[0]), _prices(sims[1])
    for key in want:
        for g_, w in zip(got[key], want[key]):
            assert _rel(g_, w) <= 1e-12, key
