"""The port's hybrid asset-LMM (``finmath_tpu_torch/models/lmm/hybrid.py``)
against finmath_tpu's, on ``tests/test_hybrid.py``'s 10-period model (5Y
semiannual, lognormal, a flat 40% caplet curve, 1 factor, spot measure)
at 2,000 paths, on one injected realization: seeded NumPy increments for
the rates and the JAX package's own equity normals (drawn in the test at
``fold_in(fold_in(PRNGKey(seed), 987654321), s)``, ``[K, paths]`` float32
per step) injected into the port through ``equity_normals=``.

Tolerances against the JAX package (measured gaps in brackets):
* the discounted assets S/N of ``simulate``: 1e-12 relative [2.7e-15].
  The asset leg is a float64 log carry on the engine's numeraire ratio,
  and adds no gap of its own;
* the assets, numeraires and bonds of ``simulate_with_bonds``, and the
  option values: 2e-6 relative, 16 float32 epsilons [2.2e-7 for the
  numeraires and assets, 9.1e-8 for the bonds, 1.7e-9 for the options].
  The two packages' float32 log-Euler sweeps differ by up to 7 ulps in
  the forwards (XLA's and torch's float32 ``exp`` round differently),
  and the spot numeraire accrues float32 factors (1 + delta L); the
  assets inherit the numeraire's gap through log(N_new / N_old);
* ``martingale_errors`` within 1e-9 absolute and ``forward_value``
  within 1e-9 relative [4.4e-16 and 0]: both read S/N only;
* the exposure profile of two forwards and two options (EE, ENE, the
  forward value, PFE 0.95): within 1e-6 of the largest EE [2.8e-9 of it
  for EE, ENE and the forward value, 5.1e-8 for the PFE].
  The options' close-outs are regressions on (1, s, s^2, p, s p) with
  p = P(T_e, T_m) nearly constant at short horizons, so the betas are
  ill-conditioned and are not compared; their fitted values are;
* ``HybridAutocallableNote`` with and without memory: 1e-6 relative
  [1.6e-9];
* two assets, an FX rate on a foreign curve and a quanto underlying
  (``tests/test_hybrid.py``'s set-up, with stochastic rates): the same
  bounds, and the quanto column NaN in both.
The engine's ``step_hook`` is held to keep every bit of the engine: a
no-op hook gives ``torch.equal`` values, pathwise values and forward
deltas. The remaining cases are the JAX package's own on the port's
stream (torch's generators) at the JAX bounds."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.caps import (  # noqa: E402
    CapletVolatilityCurve, LIBORVolatilityModelFromCapletCurve)
from finmath_tpu_torch.models.curves import (  # noqa: E402
    DiscountCurve, ForwardCurve)
from finmath_tpu_torch.models.lmm import hybrid as th  # noqa: E402
from finmath_tpu_torch.models.lmm.covariance import (  # noqa: E402
    LIBORCorrelationModelExponentialDecay,
    LIBORCovarianceModelFromVolatilityAndCorrelation)
from finmath_tpu_torch.models.lmm.model import (  # noqa: E402
    LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct)
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

CPU = "cpu"
PERIOD, N_STEPS, SIGMA_L = 0.5, 10, 0.40
PILLARS = [0.5, 1.0, 2.0, 3.0, 5.0]
ZEROS = [0.045, 0.047, 0.050, 0.051, 0.052]
DFS = list(np.exp(-np.array(ZEROS) * np.array(PILLARS)))
PATHS, SEED, INC_SEED, R_F = 2_000, 11, 2027, 0.02
P0 = np.zeros(0)
BONDS = (4, 8, 9)
FLAT_T = np.linspace(0.0, 5.0, 11)[1:]


def build_model(mod):
    """``tests/test_hybrid.py``'s ``build_model`` in package ``mod`` (a dict
    of that package's classes)."""
    dc = mod["DiscountCurve"](PILLARS, DFS)
    fc = mod["ForwardCurve"](dc, payment_offset=PERIOD)
    td = mod["TimeDiscretization"](initial=0.0, num_steps=N_STEPS,
                                   step=PERIOD)
    curve = mod["CapletVolatilityCurve"]([td.get_last_time()], [SIGMA_L])
    vm = mod["LIBORVolatilityModelFromCapletCurve"](td, td, curve)
    cov = mod["LIBORCovarianceModelFromVolatilityAndCorrelation"](
        vm, mod["LIBORCorrelationModelExponentialDecay"](td, 1))
    return mod["LIBORMarketModel"](td, fc, dc, cov, measure="spot",
                                   state_space="lognormal")


PORT = dict(DiscountCurve=DiscountCurve, ForwardCurve=ForwardCurve,
            TimeDiscretization=TimeDiscretization,
            CapletVolatilityCurve=CapletVolatilityCurve,
            LIBORVolatilityModelFromCapletCurve=(
                LIBORVolatilityModelFromCapletCurve),
            LIBORCovarianceModelFromVolatilityAndCorrelation=(
                LIBORCovarianceModelFromVolatilityAndCorrelation),
            LIBORCorrelationModelExponentialDecay=(
                LIBORCorrelationModelExponentialDecay),
            LIBORMarketModel=LIBORMarketModelTorch)


def increments(paths=PATHS, seed=INC_SEED):
    rng = np.random.default_rng(seed)
    return (np.sqrt(PERIOD) * rng.standard_normal((N_STEPS, 1, paths))
            ).astype(np.float32)


def jax_equity_normals(seed, k, paths=PATHS, steps=N_STEPS - 1):
    """The JAX hybrid's idiosyncratic normals, ``[steps, K, paths]``."""
    import jax
    import jax.numpy as jnp

    base = jax.random.fold_in(jax.random.PRNGKey(seed), 987654321)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(base, s), (k, paths), dtype=jnp.float32))
        for s in range(steps)])


def flat_curve(cls, rate=R_F):
    return cls(list(FLAT_T), list(np.exp(-rate * FLAT_T)))


def equity_kw(dc_cls):
    return dict(equity_initial_values=[100.0], equity_volatilities=[0.20],
                rate_correlations=[0.3], dividend_yields=[0.01])


def fx_quanto_kw(dc_cls):
    fc_f = flat_curve(dc_cls)
    return dict(equity_initial_values=[1.25, 80.0],
                equity_volatilities=[0.12, 0.25],
                rate_correlations=[0.3, -0.2],
                dividend_yields=[fc_f, 0.01], growth_curves=[None, fc_f],
                quanto_fx_indices=[None, 0],
                equity_correlation=[[1.0, 0.6], [0.6, 1.0]])


def trades(mod):
    return [mod.EquityForwardTrade(0, 8, 100.0),
            mod.EquityForwardTrade(0, 5, 95.0, notional=-0.5),
            mod.EquityOptionTrade(0, 6, 105.0),
            mod.EquityOptionTrade(0, 9, 98.0, is_call=False, notional=2.0)]


AUTOCALL = dict(observation_indices=[1, 2, 3, 4, 5, 6],
                autocall_levels=[110.0] * 6, coupon_levels=[85.0] * 6,
                coupons=[0.02] * 6, protection_level=60.0)


def _port_hybrid(kw, k, **extra):
    return th.HybridAssetLMM(build_model(PORT), num_paths=PATHS,
                             num_factors=1, seed=SEED,
                             increments=increments(), device=CPU,
                             equity_normals=jax_equity_normals(SEED, k),
                             **kw(DiscountCurve), **extra)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX program of this file, run once on the injected block."""
    from finmath_tpu.models import caps as jcaps
    from finmath_tpu.models import curves as jcurves
    from finmath_tpu.models.lmm import covariance as jcov
    from finmath_tpu.models.lmm import hybrid as jh
    from finmath_tpu.models.lmm.model import LIBORMarketModelTPU
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    mod = dict(DiscountCurve=jcurves.DiscountCurve,
               ForwardCurve=jcurves.ForwardCurve, TimeDiscretization=JTD,
               CapletVolatilityCurve=jcaps.CapletVolatilityCurve,
               LIBORVolatilityModelFromCapletCurve=(
                   jcaps.LIBORVolatilityModelFromCapletCurve),
               LIBORCovarianceModelFromVolatilityAndCorrelation=(
                   jcov.LIBORCovarianceModelFromVolatilityAndCorrelation),
               LIBORCorrelationModelExponentialDecay=(
                   jcov.LIBORCorrelationModelExponentialDecay),
               LIBORMarketModel=LIBORMarketModelTPU)

    def hybrid(kw):
        return jh.HybridAssetLMM(build_model(mod), num_paths=PATHS,
                                 num_factors=1, seed=SEED,
                                 increments=increments(),
                                 **kw(jcurves.DiscountCurve))

    h = hybrid(equity_kw)
    assets, nums, bonds = (np.asarray(a) for a in
                           h.simulate_with_bonds(P0, BONDS))
    out = dict(assets=assets, nums=nums, bonds=bonds,
               mart=h.martingale_errors(P0),
               fwd=h.forward_value(P0, 6),
               call=h.european_option_value(P0, 6, 105.0),
               put=h.european_option_value(P0, 9, 98.0, is_call=False),
               prof=jh.HybridExposureEngine(h, trades(jh),
                                            quantiles=(0.95,)).profile(P0))
    for memory in (False, True):
        out[("auto", memory)] = jh.HybridAutocallableNote(
            h, memory=memory, **AUTOCALL).get_value_and_error(P0)
    hq = hybrid(fx_quanto_kw)
    qa, qn = (np.asarray(a) for a in hq.simulate(P0))
    out.update(q_assets=qa, q_nums=qn, q_mart=hq.martingale_errors(P0),
               q_call=hq.european_option_value(P0, 6, 82.0, asset_index=1),
               q_fx=hq.forward_value(P0, 6, asset_index=0))
    return out


@pytest.fixture(scope="module")
def port():
    return _port_hybrid(equity_kw, 1)


class TestSimulate:
    def test_simulate_with_bonds_matches_jax(self, jax_side, port):
        assets, nums, bonds = port.simulate_with_bonds(P0, BONDS)
        for t in (assets, nums, bonds):
            assert t.dtype == torch.float64 and t.device.type == CPU
        assert assets.shape == (9, 1, PATHS) and bonds.shape == (9, 3, PATHS)
        np.testing.assert_allclose(
            (assets / nums[:, None]).numpy(),
            jax_side["assets"] / jax_side["nums"][:, None], rtol=1e-12)
        np.testing.assert_allclose(assets.numpy(), jax_side["assets"],
                                   rtol=2e-6)
        np.testing.assert_allclose(nums.numpy(), jax_side["nums"], rtol=2e-6)
        np.testing.assert_allclose(bonds.numpy(), jax_side["bonds"],
                                   rtol=2e-6)
        a2, n2 = port.simulate(P0)
        assert torch.equal(a2, assets) and torch.equal(n2, nums)

    def test_diagnostics_match_jax(self, jax_side, port):
        np.testing.assert_allclose(port.martingale_errors(P0),
                                   jax_side["mart"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(port.forward_value(P0, 6),
                                   jax_side["fwd"], rtol=1e-9)
        for got, key in ((port.european_option_value(P0, 6, 105.0), "call"),
                         (port.european_option_value(P0, 9, 98.0,
                                                     is_call=False), "put")):
            np.testing.assert_allclose(got, jax_side[key], rtol=2e-6)

    def test_fx_and_quanto_match_jax(self, jax_side):
        h = _port_hybrid(fx_quanto_kw, 2)
        assets, nums = h.simulate(P0)
        np.testing.assert_allclose(assets.numpy(), jax_side["q_assets"],
                                   rtol=2e-6)
        np.testing.assert_allclose(nums.numpy(), jax_side["q_nums"],
                                   rtol=2e-6)
        mart = h.martingale_errors(P0)
        assert np.all(np.isnan(mart[:, 1])) and np.all(
            np.isnan(jax_side["q_mart"][:, 1]))
        np.testing.assert_allclose(mart[:, 0], jax_side["q_mart"][:, 0],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            h.european_option_value(P0, 6, 82.0, asset_index=1),
            jax_side["q_call"], rtol=2e-6)
        np.testing.assert_allclose(h.forward_value(P0, 6, asset_index=0),
                                   jax_side["q_fx"], rtol=1e-9)


class TestExposureAndNote:
    def test_profile_matches_jax(self, jax_side, port):
        prof = th.HybridExposureEngine(port, trades(th)).profile(P0)
        ref = jax_side["prof"]
        tol = 1e-6 * np.max(ref.ee)
        np.testing.assert_array_equal(prof.times, ref.times)
        for name in ("ee", "ene", "forward_value"):
            np.testing.assert_allclose(getattr(prof, name),
                                       getattr(ref, name), rtol=0, atol=tol)
        np.testing.assert_allclose(prof.pfe[0.95], ref.pfe[0.95], rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(prof.ee + prof.ene, prof.forward_value,
                                   rtol=0, atol=1e-10)

    @pytest.mark.parametrize("memory", [False, True])
    def test_autocallable_matches_jax(self, jax_side, port, memory):
        note = th.HybridAutocallableNote(port, memory=memory, **AUTOCALL)
        np.testing.assert_allclose(note.get_value_and_error(P0),
                                   jax_side[("auto", memory)], rtol=1e-6)
        assert note.getValue(P0) == note.get_value_and_error(P0)[0]


class TestStepHook:
    def _engine(self):
        products = [SwaptionProduct(2, 4, 0.05, 0.0, value_unit="VALUE"),
                    SwaptionProduct(5, 3, 0.045, 0.0, value_unit="VALUE")]
        return LMMValuationEngine(build_model(PORT), products, 500, 1,
                                  seed=3, device=CPU)

    def test_noop_hook_keeps_every_bit(self):
        plain, hooked = self._engine(), self._engine()
        calls = []
        inner = hooked._simulate_collect

        def with_hook(*args, **kwargs):
            return inner(*args, step_hook=lambda s, n0, n1, dw: calls.append(
                (s, n0, n1, dw)), **kwargs)

        hooked._simulate_collect = with_hook
        for name in ("values", "pathwise_values"):
            a = torch.as_tensor(getattr(plain, name)(P0))
            b = torch.as_tensor(getattr(hooked, name)(P0))
            assert torch.equal(a, b), name
        va, ga = plain.forward_deltas(P0)
        vb, gb = hooked.forward_deltas(P0)
        assert va == vb and torch.equal(torch.as_tensor(ga),
                                        torch.as_tensor(gb))
        # one call per simulated step, before the last event's step
        steps = [c[0] for c in calls[:hooked.steps_needed]]
        assert steps == list(range(hooked.steps_needed))
        s, n_old, n_new, dw = calls[1]
        assert torch.equal(dw, hooked.increments[1])
        assert n_old.dtype == torch.float64 and torch.all(n_new > n_old)


class TestOwnStream:
    """``tests/test_hybrid.py``'s cases on torch's generators."""

    def _hybrid(self, paths=80_000, seed=11, **kw):
        defaults = dict(equity_initial_values=[100.0],
                        equity_volatilities=[0.20])
        defaults.update(kw)
        return th.HybridAssetLMM(build_model(PORT), num_paths=paths,
                                 num_factors=1, seed=seed, antithetic=True,
                                 device=CPU, **defaults)

    def test_martingale_and_parity(self):
        h = self._hybrid(rate_correlations=[0.4])
        assert np.max(np.abs(h.martingale_errors(P0))) < 0.01
        t = TimeDiscretization(initial=0.0, num_steps=N_STEPS,
                               step=PERIOD).get_time(6)
        c, se_c = h.european_option_value(P0, 6, 100.0, is_call=True)
        p, se_p = h.european_option_value(P0, 6, 100.0, is_call=False)
        fwd, _ = h.forward_value(P0, 6)
        df = float(DiscountCurve(PILLARS, DFS).get_discount_factor(t))
        assert abs((c - p) - (fwd - 100.0 * df)) < 4 * (se_c + se_p) + 5e-3

    def test_covered_interest_parity(self):
        fc_f = flat_curve(DiscountCurve)
        h = self._hybrid(equity_initial_values=[1.25],
                         equity_volatilities=[0.10], rate_correlations=[0.3],
                         dividend_yields=[fc_f], seed=21)
        v, se = h.forward_value(P0, 6)
        assert abs(v - 1.25 * math.exp(-R_F * 3.0)) < 4 * se + 1e-4

    def test_correlation_ordering(self):
        vals = [self._hybrid(paths=60_000, seed=5, rate_correlations=[r])
                .european_option_value(P0, 6, 105.0)[0]
                for r in (-0.7, 0.0, 0.7)]
        assert vals[0] < vals[1] < vals[2]

    def test_exposure_identities(self):
        h = self._hybrid(paths=20_000, rate_correlations=[0.3])
        prof = th.HybridExposureEngine(
            h, [th.EquityForwardTrade(0, 8, 100.0),
                th.EquityOptionTrade(0, 6, 110.0)]).profile(P0)
        assert np.allclose(prof.ee + prof.ene, prof.forward_value,
                           atol=1e-10)
        assert np.all(prof.ee >= 0.0) and np.all(prof.ene <= 0.0)
        assert np.all(np.isfinite(prof.pfe[0.95]))
        # the antithetic halves mirror the idiosyncratic normals too
        half = h.engine.num_paths // 2
        assert torch.equal(h.equity_normals[..., :half],
                           -h.equity_normals[..., half:])


class TestValidation:
    def test_constructor_errors(self):
        model = build_model(PORT)
        kw = dict(num_paths=8, device=CPU)
        fc_f = flat_curve(DiscountCurve)
        bad = [
            dict(equity_initial_values=[100.0], equity_volatilities=[0.2],
                 rate_correlations=[1.2]),
            dict(equity_initial_values=[100.0, 100.0],
                 equity_volatilities=[0.2, 0.2],
                 equity_correlation=[[1.0, 2.0], [2.0, 1.0]]),
            dict(equity_initial_values=[-1.0], equity_volatilities=[0.2]),
            dict(equity_initial_values=[100.0], equity_volatilities=[0.2],
                 observation_indices=[N_STEPS]),
            dict(equity_initial_values=[100.0],
                 equity_volatilities=[0.2, 0.1]),
            dict(equity_initial_values=[100.0], equity_volatilities=[0.2],
                 rate_correlations=[[0.1, 0.2]]),
            dict(equity_initial_values=[100.0], equity_volatilities=[0.2],
                 dividend_yields=[0.0, 0.0]),
            dict(equity_initial_values=[1.0, 80.0],
                 equity_volatilities=[0.1, 0.2], quanto_fx_indices=[None, 0]),
            dict(equity_initial_values=[1.0, 80.0],
                 equity_volatilities=[0.1, 0.2], growth_curves=[fc_f, fc_f],
                 quanto_fx_indices=[None, 0]),
            dict(equity_initial_values=[80.0], equity_volatilities=[0.2],
                 growth_curves=[fc_f], quanto_fx_indices=[0]),
            dict(equity_initial_values=[100.0], equity_volatilities=[0.2],
                 equity_normals=np.zeros((3, 1, 8), np.float32)),
        ]
        for b in bad:
            with pytest.raises(ValueError):
                th.HybridAssetLMM(model, **b, **kw)
        with pytest.raises(NotImplementedError):
            th.HybridAssetLMM(model, [100.0], [0.2], mesh=object(), **kw)

    def test_engine_and_note_errors(self):
        model = build_model(PORT)
        fc_f = flat_curve(DiscountCurve)
        h = th.HybridAssetLMM(model, [1.25, 80.0], [0.12, 0.25],
                              dividend_yields=[fc_f, 0.0],
                              growth_curves=[None, fc_f],
                              quanto_fx_indices=[None, 0], num_paths=8,
                              device=CPU)
        with pytest.raises(ValueError, match="quanto"):
            th.HybridExposureEngine(h, [th.EquityForwardTrade(1, 6, 80.0)])
        with pytest.raises(ValueError, match="observation"):
            th.HybridExposureEngine(h, [th.EquityForwardTrade(0, 10, 1.2)])
        with pytest.raises(ValueError, match="range"):
            th.HybridExposureEngine(h, [th.EquityForwardTrade(3, 6, 1.2)])
        with pytest.raises(ValueError):
            th.HybridExposureEngine(h, [])
        with pytest.raises(TypeError):
            th.HybridExposureEngine(h, [object()])
        with pytest.raises(ValueError, match="basis_degree"):
            th.EquityOptionTrade(0, 6, 1.2, basis_degree=0)
        for args in (([2, 1], [1.0, 1.0], [0.0, 0.0], 0.6),
                     ([1, 99], [1.0, 1.0], [0.0, 0.0], 0.6),
                     ([1, 2], [1.0], [0.0, 0.0], 0.6)):
            with pytest.raises(ValueError):
                th.HybridAutocallableNote(h, *args)
        with pytest.raises(ValueError, match="domestic"):
            th.HybridAutocallableNote(h, [1, 2], [1.0, 1.0], [0.0, 0.0], 0.6,
                                      asset_index=1)
