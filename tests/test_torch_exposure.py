"""The port's exposure engines (``finmath_tpu_torch/models/lmm/exposure.py``)
against finmath_tpu's, on the ATM setup (80 libors, 1 factor) at 3,000
paths and one injected realization (seeded NumPy, sqrt(dt)-scaled, 20
steps), and the JAX package's own cases (``tests/test_exposure.py``) on
the port.

Tolerances against the JAX package, per observation date, with u the
float32 ulp (``np.spacing``) of the date's largest |V/N| over the paths
(today's money) or |V| (time-t money, for the PFE):
* the netted swap value pathwise, V/N and V (the JAX profile collector's
  own arithmetic, rebuilt once on the JAX engine): within 32 u (measured
  2.3 u and 2.5 u). The two packages form the annuity as a float32
  product (XLA's dot there, a torch matmul here: other orders of
  addition) and the bond curve in float64 from float32 forwards, and the
  forwards of the two Euler sweeps differ by float32 rounding after up to
  19 steps;
* EE, ENE, the forward value and the standalone EE: within 32 u
  (measured 0.006 u); the PFE quantiles (linear interpolation in both):
  within 32 u of |V|, as a quantile moves no more than the largest
  pathwise gap (measured 0.92 u); the CVA at a 1.2% hazard: within
  (1 - R) sum_i PD_i 32 u_i (measured 2.7e-5 of that);
* the mixed netting set (swaps, European swaptions physical and cash,
  long and short, Bermudans physical and cash), whose close-out values
  are Longstaff-Schwartz regressions on the par rate (float64 normal
  equations on float32 features, float32 predictions, in both packages):
  EE, ENE, forward value and standalone EE within 1e-6 of the profile's
  largest |value| (measured 7.3e-10), the PFE within 32 float32 ulps of
  its largest value (measured 4.2e-7 of it, about 4 ulps);
* the CVA delta ladder (reverse mode in both; the port's log-form bond
  curve in float64, the JAX package's in float32): within 1e-4 of the
  largest bucket (measured 1.0e-7), and every bucket at or past the
  swap's last index exactly 0.0 in both.
The remaining cases are the JAX package's own on the port's own stream
(the seeds of ``tests/test_exposure.py``, torch's generator) at the JAX
bounds; where two engines must share their paths they share injected
increments. The ``gpu`` cases hold a profile on the card against the same
engine on the CPU on one injected block (``-m gpu --noconftest``; they
skip without a card)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.curves import par_swap_rate  # noqa: E402
from finmath_tpu_torch.models.lmm.atm_calibration import (  # noqa: E402
    build_atm_calibration)
from finmath_tpu_torch.models.lmm import exposure as tx  # noqa: E402
from finmath_tpu_torch.models.lmm.exposure import (  # noqa: E402
    BermudanSwaptionTrade,
    ExposureProfile,
    NettingSetExposureEngine,
    SwapExposureEngine,
    SwapTrade,
    SwaptionExposureEngine,
    SwaptionTrade,
    _default_probability_vector,
    bilateral_cva_from_profile,
    cva_from_profile,
    dva_from_profile,
)

CPU = "cpu"
PATHS, STEPS, INC_SEED = 3_000, 20, 2026
FIRST, LAST = 4, 20                       # the bench swap: periods [4, 20)
HAZARD, RECOVERY = 0.012, 0.4
N_PATHS = 8000                            # the JAX cases' path count
X, M = 8, 8                               # 4Y into 4Y


def _increments(steps=STEPS, paths=PATHS, seed=INC_SEED):
    rng = np.random.default_rng(seed)
    return (np.sqrt(0.5) * rng.standard_normal((steps, 1, paths))
            ).astype(np.float32)


def _ulps(x):
    """32 float32 ulps of each date's largest |x| over the paths."""
    return 32.0 * np.spacing(np.max(np.abs(x), axis=-1).astype(np.float32)
                             ).astype(np.float64)


def _mixed_trades(mod, strike):
    return [mod.SwapTrade(2, 16, 0.006, payer=False, notional=1.5),
            mod.SwapTrade(1, 12, 0.02, payer=True),
            mod.SwaptionTrade(X, M, strike),
            mod.SwaptionTrade(6, 4, strike, physical=False, notional=-0.7),
            mod.BermudanSwaptionTrade((X, X + 2, X + 4), X + M, strike),
            mod.BermudanSwaptionTrade((4, 9), 14, strike, physical=False)]


@pytest.fixture(scope="module")
def port():
    st = build_atm_calibration(num_paths=N_PATHS, num_factors=1, device=CPU)
    m = st.model
    par = float(par_swap_rate(m.forward_curve, m.discount_curve,
                              m.tenor_times[FIRST:LAST + 1]))
    strike = float(par_swap_rate(m.forward_curve, m.discount_curve,
                                 m.tenor_times[X:X + M + 1]))
    return dict(setup=st, model=m, x=np.asarray(st.covariance.initial_parameters),
                par=par, strike=strike)


@pytest.fixture(scope="module")
def jax_runs(port):
    """Every JAX program of this file, run once on the injected block: the
    bench swap's profile, its pathwise netted V/N, its CVA ladder, and the
    mixed netting set's profile."""
    import jax
    import jax.numpy as jnp
    from finmath_tpu.models.lmm import exposure as jx
    from finmath_tpu.models.lmm.atm_calibration import (
        build_atm_calibration as jax_build)
    from finmath_tpu.models.lmm.model import bond_ratio_cumprod_hi

    sj = jax_build(num_paths=PATHS, num_factors=1)
    x = sj.covariance.initial_parameters
    inc = _increments()
    swap = jx.SwapExposureEngine(sj.model, FIRST, LAST, port["par"],
                                 num_paths=PATHS, increments=inc,
                                 quantiles=(0.5, 0.95, 0.99))
    prof = swap.profile(x)

    # the profile collector's netted swap value (exposure.py:659-676)
    eng = swap.engine
    cd = eng.collect_dtype
    deltas = jnp.asarray(sj.model.deltas, dtype=cd)
    pay_mask = jnp.asarray(swap._pay_mask_np, dtype=eng.dtype)
    start_m1, is_fwd = (jnp.asarray(a) for a in (swap._start_m1_np,
                                                  swap._is_fwd_np))
    end_m1, coef = jnp.asarray(swap._end_m1_np), jnp.asarray(swap._coef_np)
    strikes = jnp.asarray(swap._strikes_np)
    j_iota = jnp.arange(sj.model.num_libors)[:, None]

    def collect(e, ev, L, N):
        cp = bond_ratio_cumprod_hi(L, deltas[:, None].astype(L.dtype), e,
                                   j_iota, cd)
        ann = jnp.matmul(pay_mask[ev], cp.astype(eng.dtype),
                         precision=jax.lax.Precision.HIGHEST
                         ).astype(jnp.float64)
        p_start = jnp.where(is_fwd[ev][:, None],
                            jnp.take(cp, start_m1[ev], axis=0), 1.0)
        p_end = jnp.take(cp, end_m1, axis=0)
        raw = (p_start.astype(jnp.float64) - p_end.astype(jnp.float64)
               - strikes[:, None] * ann)
        return (jnp.sum(coef[ev][:, None] * raw, axis=0),
                1.0 / N.astype(jnp.float64))

    v, inv_n = jax.jit(lambda p, i: eng._simulate_collect(p, collect, i))(
        jnp.asarray(x, dtype=eng.dtype), eng._inc_dev)
    cva, grad = swap.cva_forward_deltas(x, hazard_rate=HAZARD,
                                        recovery=RECOVERY)
    mixed = jx.NettingSetExposureEngine(
        sj.model, _mixed_trades(jx, port["strike"]), num_paths=PATHS,
        increments=inc).profile(x)
    return dict(swap=prof, v=np.asarray(v), inv_n=np.asarray(inv_n),
                cva=cva, grad=np.asarray(grad), mixed=mixed, inc=inc)


@pytest.fixture(scope="module")
def port_swap(port, jax_runs):
    eng = SwapExposureEngine(port["model"], FIRST, LAST, port["par"],
                             num_paths=PATHS, increments=jax_runs["inc"],
                             quantiles=(0.5, 0.95, 0.99), device=CPU)
    return eng, eng.profile(port["x"])


def _port_pathwise(eng, x):
    outs = eng.engine._simulate_collect(eng.engine._params(x), eng._collect)
    v = torch.stack([o[0] for o in outs]).numpy()
    inv_n = torch.stack([o[-1] for o in outs]).numpy()
    return v, inv_n


# ---------------------------------------------------------------------------
# parity with the JAX package on one injected realization
# ---------------------------------------------------------------------------

def test_pathwise_netted_value_matches_jax(port, jax_runs, port_swap):
    eng, _ = port_swap
    v, inv_n = _port_pathwise(eng, port["x"])
    vj, invj = jax_runs["v"], jax_runs["inv_n"]
    assert v.shape == vj.shape == (LAST - 1, PATHS)
    np.testing.assert_allclose(inv_n, invj, rtol=1e-6)
    gap = np.max(np.abs(v * inv_n - vj * invj), axis=-1)
    assert np.all(gap <= _ulps(vj * invj))


@pytest.mark.parametrize("e", [1, FIRST - 1, FIRST, LAST - 1])
def test_observation_geometry_at_the_edges(port, jax_runs, port_swap, e):
    """The live block's geometry shifted by e: before the swap starts, at
    its first fixing and one period before its end (where an
    off-by-one in the relative tables shows)."""
    eng, _ = port_swap
    ev = eng.observation_indices.index(e)
    v, inv_n = _port_pathwise(eng, port["x"])
    vj, invj = jax_runs["v"][ev], jax_runs["inv_n"][ev]
    assert np.max(np.abs(v[ev] * inv_n[ev] - vj * invj)) <= \
        _ulps((vj * invj)[None])[0]
    assert np.max(np.abs(v[ev] - vj)) <= _ulps(vj[None])[0]


@pytest.mark.parametrize("row", ["ee", "ene", "forward_value",
                                 "ee_standalone"])
def test_profile_rows_match_jax(jax_runs, port_swap, row):
    _, prof = port_swap
    vn = jax_runs["v"] * jax_runs["inv_n"]
    got, ref = getattr(prof, row), getattr(jax_runs["swap"], row)
    assert got.shape == ref.shape == (LAST - 1,)
    assert np.all(np.abs(got - ref) <= _ulps(vn))


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_pfe_matches_jax(jax_runs, port_swap, q):
    _, prof = port_swap
    assert np.all(np.abs(prof.pfe[q] - jax_runs["swap"].pfe[q])
                  <= _ulps(jax_runs["v"]))


@pytest.mark.parametrize("shape", [(7, 1001), (513,), (3, 1)])
def test_pfe_quantiles_equal_torch_quantile(shape):
    """The engines' one-sort quantiles are torch.quantile's bit for bit."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(shape))
    qs = torch.tensor([0.0, 0.05, 0.5, 0.95, 0.99, 1.0], dtype=torch.float64)
    assert torch.equal(tx._linear_quantiles(x, qs),
                       torch.quantile(x, qs, dim=-1))


def test_pfe_quantiles_past_two_to_the_24_elements():
    """An [E, paths] block of 2**24 + 10 float64 values, past
    torch.quantile's limit (jnp.quantile has none): numpy.quantile's
    linear values within 1e-12 relative (its interpolation weight is
    formed in another order)."""
    x = np.random.default_rng(4).standard_normal((2, 2 ** 23 + 5))
    qs = (0.05, 0.95, 0.99)
    got = tx._linear_quantiles(torch.as_tensor(x),
                               torch.tensor(qs, dtype=torch.float64)).numpy()
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, np.quantile(x, qs, axis=-1),
                               rtol=1e-12, atol=0.0)


def test_cva_matches_jax(port, jax_runs, port_swap):
    eng, prof = port_swap
    pd = _default_probability_vector(prof.times, HAZARD, None)
    bound = (1.0 - RECOVERY) * np.sum(pd * _ulps(jax_runs["v"]
                                                 * jax_runs["inv_n"]))
    ref = cva_from_profile(jax_runs["swap"], HAZARD, RECOVERY)
    assert abs(eng.cva(port["x"], HAZARD, RECOVERY) - ref) <= bound
    assert abs(jax_runs["cva"] - ref) <= bound


def test_cva_delta_ladder_matches_jax(port, jax_runs, port_swap):
    eng, _ = port_swap
    cva, grad = eng.cva_forward_deltas(port["x"], hazard_rate=HAZARD,
                                       recovery=RECOVERY)
    gj = jax_runs["grad"]
    assert grad.shape == gj.shape == (80,)
    assert np.all(np.isfinite(grad))
    assert np.max(np.abs(grad - gj)) <= 1e-4 * np.max(np.abs(gj))
    assert cva == pytest.approx(jax_runs["cva"], rel=1e-6)
    # tail_exact_zero (bench.py:1577-1584), in both packages
    assert np.all(grad[LAST:] == 0.0) and np.all(gj[LAST:] == 0.0)


@pytest.mark.parametrize("row", ["ee", "ene", "forward_value",
                                 "ee_standalone", "pfe"])
def test_mixed_netting_set_matches_jax(port, jax_runs, row):
    prof = NettingSetExposureEngine(
        port["model"], _mixed_trades(tx, port["strike"]), num_paths=PATHS,
        increments=jax_runs["inc"], device=CPU).profile(port["x"])
    ref = jax_runs["mixed"]
    if row == "pfe":
        for q in ref.pfe:
            assert np.max(np.abs(prof.pfe[q] - ref.pfe[q])) <= \
                _ulps(ref.pfe[q][None])[0]
        return
    scale = max(np.max(np.abs(getattr(ref, r)))
                for r in ("ee", "ene", "forward_value", "ee_standalone"))
    assert np.max(np.abs(getattr(prof, row) - getattr(ref, row))) \
        <= 1e-6 * scale


# ---------------------------------------------------------------------------
# the JAX package's own cases (tests/test_exposure.py) on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def profile_and_engine(port):
    eng = SwapExposureEngine(
        port["model"], first_index=4, last_index=20, strike=0.02,
        payer=True, num_paths=N_PATHS, num_factors=1, seed=777,
        quantiles=(0.5, 0.95, 0.99), device=CPU)
    return eng.profile(port["x"]), eng


def _engine(port, trades, **kw):
    kw.setdefault("num_paths", N_PATHS)
    return NettingSetExposureEngine(port["model"], trades, num_factors=1,
                                    device=CPU, **kw)


class TestSwapExposure:
    def test_forward_value_martingale(self, profile_and_engine):
        prof, eng = profile_and_engine
        analytic = eng.analytic_forward_values()
        assert np.max(np.abs(prof.forward_value - analytic)) < 2e-3

    def test_ee_ene_decompose_forward_value(self, profile_and_engine):
        prof, _ = profile_and_engine
        assert np.allclose(prof.ee + prof.ene, prof.forward_value,
                           atol=1e-12)

    def test_exposure_bounds(self, profile_and_engine):
        prof, _ = profile_and_engine
        assert np.all(prof.ee >= 0.0)
        assert np.all(prof.ene <= 0.0)
        assert np.all(prof.ee >= np.maximum(prof.forward_value, 0.0) - 1e-12)

    def test_pfe_quantile_ordering(self, profile_and_engine):
        prof, _ = profile_and_engine
        assert np.all(prof.pfe[0.99] >= prof.pfe[0.95] - 1e-12)
        assert np.all(prof.pfe[0.95] >= prof.pfe[0.5] - 1e-12)
        assert prof.max_pfe(0.99) >= prof.max_pfe(0.95)

    def test_exposure_dies_with_the_swap(self, profile_and_engine):
        prof, _ = profile_and_engine
        assert prof.ee[-1] < 0.5 * np.max(prof.ee)

    def test_payer_receiver_mirror(self, port):
        kw = dict(first_index=2, last_index=8, strike=0.01,
                  num_paths=N_PATHS, num_factors=1, seed=99, device=CPU)
        payer = SwapExposureEngine(port["model"], payer=True,
                                   **kw).profile(port["x"])
        recv = SwapExposureEngine(port["model"], payer=False,
                                  **kw).profile(port["x"])
        assert np.allclose(recv.ee, -payer.ene, atol=1e-12)
        assert np.allclose(recv.ene, -payer.ee, atol=1e-12)

    def test_notional_scales_linearly(self, port):
        kw = dict(first_index=2, last_index=6, strike=0.01,
                  num_paths=N_PATHS, num_factors=1, seed=5, device=CPU)
        one = SwapExposureEngine(port["model"], notional=1.0,
                                 **kw).profile(port["x"])
        ten = SwapExposureEngine(port["model"], notional=10.0,
                                 **kw).profile(port["x"])
        assert np.allclose(ten.ee, 10.0 * one.ee, rtol=1e-12)
        assert np.allclose(ten.pfe[0.95], 10.0 * one.pfe[0.95], rtol=1e-12)

    def test_deterministic(self, port, profile_and_engine):
        prof, eng = profile_and_engine
        again = eng.profile(port["x"])
        assert np.array_equal(prof.ee, again.ee)
        assert np.array_equal(prof.pfe[0.99], again.pfe[0.99])

    def test_antithetic_composes(self, port):
        eng = SwapExposureEngine(
            port["model"], first_index=2, last_index=6, strike=0.01,
            num_paths=N_PATHS, num_factors=1, seed=5, antithetic=True,
            device=CPU)
        prof = eng.profile(port["x"])
        assert np.all(np.isfinite(prof.ee))
        assert np.max(np.abs(prof.forward_value
                             - eng.analytic_forward_values())) < 2e-3

    def test_qmc_increments_compose(self, port):
        from finmath_tpu_torch.models.qmc import sobol_brownian_increments

        sim = port["model"].sim_times
        inc = sobol_brownian_increments(sim[1:] - sim[:-1], 1, 4096, seed=7)
        eng = SwapExposureEngine(port["model"], first_index=2, last_index=6,
                                 strike=0.01, num_paths=4096, num_factors=1,
                                 increments=inc, device=CPU)
        prof = eng.profile(port["x"])
        assert np.all(np.isfinite(prof.ee))
        assert np.max(np.abs(prof.forward_value
                             - eng.analytic_forward_values())) < 2e-3

    def test_invalid_ranges_raise(self, port):
        m = port["model"]
        with pytest.raises(ValueError):
            SwapExposureEngine(m, first_index=0, last_index=6, strike=0.01,
                               device=CPU)
        with pytest.raises(ValueError):
            SwapExposureEngine(m, first_index=4, last_index=4, strike=0.01,
                               device=CPU)
        with pytest.raises(ValueError):
            SwapExposureEngine(m, first_index=2, last_index=6, strike=0.01,
                               observation_indices=[6], device=CPU)

    def test_mesh_raises_until_the_sharding_slice(self, port):
        with pytest.raises(NotImplementedError):
            SwapExposureEngine(port["model"], 2, 6, 0.01, num_paths=64,
                               mesh=object(), device=CPU)


class TestNettingSet:
    @pytest.fixture(scope="class")
    def engines(self, port):
        trades = [SwapTrade(2, 12, 0.005, payer=True, notional=2.0),
                  SwapTrade(4, 8, 0.012, payer=False, notional=1.0)]
        eng = _engine(port, trades, seed=11)
        return eng, eng.profile(port["x"])

    def test_forward_value_martingale(self, engines):
        eng, prof = engines
        assert np.max(np.abs(prof.forward_value
                             - eng.analytic_forward_values())) < 4e-3

    def test_netting_benefit_nonnegative(self, engines):
        _, prof = engines
        assert np.all(prof.netting_benefit >= -1e-12)
        assert np.max(prof.netting_benefit) > 0.0

    def test_single_trade_set_has_zero_benefit(self, profile_and_engine):
        prof, _ = profile_and_engine
        assert np.allclose(prof.netting_benefit, 0.0, atol=1e-15)

    def test_perfect_hedge_nets_to_zero(self, port):
        trades = [SwapTrade(2, 8, 0.01, payer=True),
                  SwapTrade(2, 8, 0.01, payer=False)]
        prof = _engine(port, trades, seed=3).profile(port["x"])
        assert np.allclose(prof.ee, 0.0, atol=1e-12)
        assert np.allclose(prof.ene, 0.0, atol=1e-12)
        assert np.allclose(prof.pfe[0.99], 0.0, atol=1e-12)
        assert np.all(prof.ee_standalone > 0.0)

    def test_matured_trade_drops_out(self, port):
        long_tr = SwapTrade(1, 12, 0.008, payer=True)
        short_tr = SwapTrade(1, 6, 0.002, payer=False)
        netted = _engine(port, [long_tr, short_tr], seed=17).profile(
            port["x"])
        alone = _engine(port, [long_tr], seed=17,
                        observation_indices=range(1, 12)).profile(port["x"])
        assert np.allclose(netted.ee[5:], alone.ee[5:], atol=1e-12)
        assert np.allclose(netted.pfe[0.95][5:], alone.pfe[0.95][5:],
                           atol=1e-12)

    def test_empty_set_raises(self, port):
        with pytest.raises(ValueError):
            NettingSetExposureEngine(port["model"], [], device=CPU)


class TestMixedNettingSet:
    def test_swaption_only_set_matches_dedicated_engine(self, port):
        kw = dict(num_paths=N_PATHS, num_factors=1, seed=123, device=CPU)
        nset = NettingSetExposureEngine(
            port["model"], [SwaptionTrade(X, M, port["strike"])],
            **kw).profile(port["x"])
        alone = SwaptionExposureEngine(port["model"], X, M, port["strike"],
                                       physical=True, **kw).profile(
                                           port["x"])
        assert np.allclose(nset.ee, alone.ee, atol=1e-12)
        assert np.allclose(nset.ene, alone.ene, atol=1e-12)
        assert np.allclose(nset.pfe[0.95], alone.pfe[0.95], atol=1e-12)

    def test_long_short_swaptions_net_to_zero(self, port):
        prof = _engine(port, [SwaptionTrade(X, M, port["strike"],
                                            notional=1.0),
                              SwaptionTrade(X, M, port["strike"],
                                            notional=-1.0)],
                       seed=9).profile(port["x"])
        assert np.allclose(prof.ee, 0.0, atol=1e-12)
        assert np.allclose(prof.ene, 0.0, atol=1e-12)
        assert np.all(prof.ee_standalone > 0.0)

    def test_mixed_set_forward_value_adds(self, port):
        sw = SwapTrade(2, X + M, 0.006, payer=False)
        opt = SwaptionTrade(X, M, port["strike"])
        kw = dict(seed=31, observation_indices=range(1, X + M))
        mixed = _engine(port, [sw, opt], **kw).profile(port["x"])
        only_sw = _engine(port, [sw], **kw).profile(port["x"])
        only_opt = _engine(port, [opt], **kw).profile(port["x"])
        assert np.allclose(mixed.forward_value,
                           only_sw.forward_value + only_opt.forward_value,
                           atol=1e-10)
        assert np.all(mixed.ee <= only_sw.ee + only_opt.ee + 1e-12)
        assert np.max(mixed.netting_benefit) > 0.0

    def test_cash_settled_swaption_trade_dies_at_expiry(self, port):
        prof = _engine(port, [SwaptionTrade(X, M, port["strike"],
                                            physical=False)],
                       seed=9).profile(port["x"])
        evx = X - 1
        assert prof.ee[evx] > 0.0
        assert np.allclose(prof.ee[evx + 1:], 0.0, atol=1e-15)

    def test_cva_deltas_guarded_for_swaptions(self, port):
        eng = _engine(port, [SwaptionTrade(X, M, port["strike"])])
        with pytest.raises(NotImplementedError):
            eng.cva_forward_deltas(port["x"], hazard_rate=0.01)

    def test_swaption_expiry_must_be_observed(self, port):
        with pytest.raises(ValueError):
            _engine(port, [SwaptionTrade(X, M, port["strike"])],
                    observation_indices=[2, 4])


class TestSwaptionExposure:
    @pytest.fixture(scope="class")
    def swaption_setup(self, port):
        inc = _increments(steps=X + M, paths=N_PATHS, seed=123)
        eng = SwaptionExposureEngine(
            port["model"], X, M, port["strike"], physical=True,
            num_paths=N_PATHS, num_factors=1, increments=inc, device=CPU)
        return eng, eng.profile(port["x"]), inc

    def test_regression_preserves_the_mean(self, swaption_setup):
        eng, prof, _ = swaption_setup
        up_to_x = prof.forward_value[:eng._ev_x + 1]
        assert np.max(np.abs(up_to_x - up_to_x[-1])) < 1e-10

    def test_value_matches_valuation_engine(self, port, swaption_setup):
        """forward_value at expiry == the valuation engine's price on the
        same injected paths, within the JAX test's 1e-9 relative. The
        engine forms the annuity in float64, the exposure collector in
        float32 (as the JAX collector does), so the two differ by the
        strike times the annuity's float32 rounding, which averages out
        over the paths (7.3e-11 measured)."""
        from finmath_tpu_torch.models.lmm.model import (LMMValuationEngine,
                                                        SwaptionProduct)

        eng, prof, inc = swaption_setup
        pricer = LMMValuationEngine(
            port["model"], [SwaptionProduct(X, M, port["strike"], 0.0,
                                            value_unit="VALUE")],
            N_PATHS, 1, device=CPU, increments=inc)
        value = float(pricer.values(port["x"])[0])
        assert prof.forward_value[eng._ev_x] == pytest.approx(value,
                                                              rel=1e-9)

    def test_option_exposure_is_nonnegative_before_expiry(self,
                                                          swaption_setup):
        eng, prof, _ = swaption_setup
        k = eng._ev_x + 1
        assert np.all(prof.ee[:k] >= 0.0)
        assert np.all(prof.ene[:k] == 0.0)
        assert np.all(prof.ee[:k] >= prof.forward_value[:k] - 1e-12)

    def test_physical_exercise_continues_and_can_go_negative(
            self, swaption_setup):
        eng, prof, _ = swaption_setup
        k = eng._ev_x
        assert len(prof.times) == X + M - 1
        assert np.any(prof.ee[k + 1:] > 0.0)
        assert np.all(prof.ene[k + 1:] <= 0.0)
        assert prof.ee[-1] < 0.5 * np.max(prof.ee)

    def test_cash_settlement_dies_at_expiry(self, port):
        eng = SwaptionExposureEngine(
            port["model"], X, M, port["strike"], physical=False,
            num_paths=N_PATHS, num_factors=1, seed=123, device=CPU)
        prof = eng.profile(port["x"])
        assert len(prof.times) == X
        assert prof.times[-1] == pytest.approx(
            float(port["model"].tenor_times[X]))

    def test_exposure_peaks_at_expiry_for_atm(self, swaption_setup):
        eng, prof, _ = swaption_setup
        k = eng._ev_x
        assert prof.ee[k] == pytest.approx(np.max(prof.ee[:k + 1]),
                                           rel=0.15)

    def test_cva_positive(self, port, swaption_setup):
        eng, _, _ = swaption_setup
        assert eng.cva(port["x"], hazard_rate=0.01) > 0.0

    def test_invalid_args_raise(self, port):
        with pytest.raises(ValueError):
            SwaptionExposureEngine(port["model"], 0, 4, 0.01, device=CPU)
        with pytest.raises(ValueError):
            SwaptionExposureEngine(port["model"], 4, 4, 0.01,
                                   basis_degree=0, device=CPU)


class TestRegulatoryMeasures:
    @pytest.fixture()
    def prof(self):
        times = np.asarray([0.5, 1.0, 1.5, 2.0])
        ee = np.asarray([2.0, 4.0, 1.0, 3.0])
        z = np.zeros(4)
        return ExposureProfile(times, ee, z, z, {0.95: ee})

    def test_epe_is_the_time_weighted_average(self, prof):
        assert prof.epe() == pytest.approx(2.5)
        assert prof.epe(horizon=1.0) == pytest.approx(3.0)
        assert prof.epe(horizon=0.75) == pytest.approx(
            (0.5 * 2.0 + 0.25 * 4.0) / 0.75)

    def test_effective_ee_is_the_running_max(self, prof):
        eff = prof.effective_ee()
        assert np.array_equal(eff, [2.0, 4.0, 4.0, 4.0])
        assert np.all(eff >= prof.ee)

    def test_effective_epe_dominates_epe(self, prof):
        assert prof.effective_epe() == pytest.approx(3.5)
        assert prof.effective_epe() >= prof.epe()

    def test_epe_horizon_validation(self, prof):
        with pytest.raises(ValueError):
            prof.epe(horizon=0.0)
        with pytest.raises(ValueError):
            prof.epe(horizon=99.0)


class TestCVADeltas:
    @pytest.fixture(scope="class")
    def f64_engine(self, port):
        return SwapExposureEngine(
            port["model"], first_index=2, last_index=10, strike=0.005,
            num_paths=2000, num_factors=1, seed=21, dtype=np.float64,
            device=CPU)

    def test_ad_matches_finite_differences(self, port, f64_engine):
        eng = f64_engine
        _, grad = eng.cva_forward_deltas(port["x"], hazard_rate=0.01)
        assert np.all(np.isfinite(grad))
        pd = torch.as_tensor(0.6 * _default_probability_vector(
            eng._obs_times, 0.01, None), dtype=torch.float64)
        fwd0 = np.asarray(port["model"].initial_forwards, dtype=np.float64)
        x = eng.engine._params(port["x"])
        h = 1e-7
        for b in (2, 5, 8):
            fp, fm = fwd0.copy(), fwd0.copy()
            fp[b] += h
            fm[b] -= h
            with torch.no_grad():
                vp, vm = (float(eng._cva_value(x, torch.as_tensor(f), pd))
                          for f in (fp, fm))
            assert grad[b] == pytest.approx((vp - vm) / (2 * h), rel=1e-5,
                                            abs=1e-10)

    def test_value_matches_cva(self, port, f64_engine):
        cva, _ = f64_engine.cva_forward_deltas(port["x"], hazard_rate=0.01)
        assert cva == pytest.approx(
            f64_engine.cva(port["x"], hazard_rate=0.01), rel=1e-9)

    def test_dead_buckets_have_zero_delta(self, port, f64_engine):
        _, grad = f64_engine.cva_forward_deltas(port["x"], hazard_rate=0.01)
        assert np.allclose(grad[f64_engine.last_index:], 0.0, atol=1e-14)
        assert np.max(np.abs(grad[:f64_engine.last_index])) > 0.0

    def test_f32_production_path_finite(self, port):
        eng32 = SwapExposureEngine(
            port["model"], first_index=2, last_index=10, strike=0.005,
            num_paths=2000, num_factors=1, seed=21, device=CPU)
        cva32, g32 = eng32.cva_forward_deltas(port["x"], hazard_rate=0.01)
        assert np.all(np.isfinite(g32))
        assert cva32 == pytest.approx(eng32.cva(port["x"], hazard_rate=0.01),
                                      rel=1e-3, abs=1e-9)


class TestCVA:
    def test_cva_zero_hazard_zero(self, port, profile_and_engine):
        _, eng = profile_and_engine
        assert eng.cva(port["x"], hazard_rate=0.0) == 0.0

    def test_cva_monotone_in_hazard(self, port, profile_and_engine):
        _, eng = profile_and_engine
        c1 = eng.cva(port["x"], hazard_rate=0.005)
        c2 = eng.cva(port["x"], hazard_rate=0.02)
        assert 0.0 < c1 < c2

    def test_cva_bounded_by_peak_ee(self, port, profile_and_engine):
        prof, eng = profile_and_engine
        c = eng.cva(port["x"], hazard_rate=0.5, recovery=0.4)
        assert c <= 0.6 * np.max(prof.ee) + 1e-15

    def test_cva_explicit_default_probs(self, port, profile_and_engine):
        prof, eng = profile_and_engine
        t = np.concatenate([[0.0], prof.times])
        surv = np.exp(-0.01 * t)
        c_explicit = eng.cva(port["x"], default_probabilities=surv[:-1]
                             - surv[1:])
        assert c_explicit == pytest.approx(eng.cva(port["x"],
                                                   hazard_rate=0.01),
                                           rel=1e-12)

    def test_dva_mirrors_cva_of_the_flipped_position(self, port,
                                                     profile_and_engine):
        payer_prof, _ = profile_and_engine
        recv_prof = SwapExposureEngine(
            port["model"], first_index=4, last_index=20, strike=0.02,
            payer=False, num_paths=N_PATHS, num_factors=1, seed=777,
            quantiles=(0.5, 0.95, 0.99), device=CPU).profile(port["x"])
        dva = dva_from_profile(payer_prof, own_hazard_rate=0.01)
        assert dva == pytest.approx(cva_from_profile(recv_prof,
                                                     hazard_rate=0.01),
                                    rel=1e-12)
        assert dva >= 0.0

    def test_bilateral_cva_decomposes(self, profile_and_engine):
        prof, _ = profile_and_engine
        b = bilateral_cva_from_profile(prof, counterparty_hazard_rate=0.02,
                                       own_hazard_rate=0.005)
        assert b == pytest.approx(
            cva_from_profile(prof, hazard_rate=0.02)
            - dva_from_profile(prof, own_hazard_rate=0.005), rel=1e-12)

    def test_cva_argument_validation(self, port, profile_and_engine):
        _, eng = profile_and_engine
        with pytest.raises(ValueError):
            eng.cva(port["x"])
        with pytest.raises(ValueError):
            eng.cva(port["x"], hazard_rate=0.01, default_probabilities=[0.1])
        with pytest.raises(ValueError):
            eng.cva(port["x"], default_probabilities=[0.2])


class TestBermudanExposure:
    @pytest.fixture(scope="class")
    def berm_profile(self, port):
        return _engine(port, [BermudanSwaptionTrade(
            (X, X + 2, X + 4), X + M, port["strike"])], seed=123).profile(
                port["x"])

    def test_single_exercise_matches_european(self, port):
        kw = dict(seed=123)
        berm = _engine(port, [BermudanSwaptionTrade((X,), X + M,
                                                    port["strike"])],
                       **kw).profile(port["x"])
        eur = _engine(port, [SwaptionTrade(X, M, port["strike"])],
                      **kw).profile(port["x"])
        assert np.allclose(berm.ee, eur.ee, atol=1e-10)
        assert np.allclose(berm.ene, eur.ene, atol=1e-10)
        assert np.allclose(berm.pfe[0.95], eur.pfe[0.95], atol=1e-10)

    def test_t0_value_matches_bermudan_pricer(self, port, berm_profile):
        from finmath_tpu_torch.models.lmm.bermudan import (
            BermudanSwaption, BermudanSwaptionPricer)

        pricer = BermudanSwaptionPricer(
            port["model"], BermudanSwaption((X, X + 2, X + 4), X + M,
                                            port["strike"]),
            num_paths=N_PATHS, num_factors=1, seed=123, device=CPU)
        lo, hi = pricer.get_value_bounds(port["x"])
        mc_tol = 4e-4
        assert lo - mc_tol <= berm_profile.forward_value[0] <= hi + mc_tol

    def test_bermudan_dominates_european(self, port, berm_profile):
        eur = _engine(port, [SwaptionTrade(X, M, port["strike"])],
                      seed=123).profile(port["x"])
        assert berm_profile.forward_value[0] >= \
            eur.forward_value[0] - 2e-4

    def test_forward_value_flat_before_first_exercise(self, berm_profile):
        pre = berm_profile.forward_value[:X - 1]
        assert np.max(np.abs(pre - pre[0])) < 6e-4

    def test_exposure_nonnegative_before_first_exercise(self, berm_profile):
        assert np.all(berm_profile.ene[:X - 1] >= -1e-12)

    def test_physical_exercise_continues_and_can_go_negative(
            self, berm_profile):
        assert np.min(berm_profile.ene[X:]) < 0.0
        assert np.max(berm_profile.ee[X:]) > 0.0

    def test_cash_settlement_dies_after_last_exercise(self, port):
        prof = _engine(port, [BermudanSwaptionTrade(
            (X, X + 2), X + M, port["strike"], physical=False)],
            seed=7).profile(port["x"])
        last_x_ev = X + 2 - 1
        assert np.allclose(prof.ee[last_x_ev + 1:], 0.0, atol=1e-15)
        assert np.all(prof.ene >= -1e-12)
        assert prof.ee[last_x_ev - 1] > 0.0

    def test_netting_against_offsetting_swap(self, port):
        prof = _engine(port, [
            BermudanSwaptionTrade((X, X + 2), X + M, port["strike"]),
            SwapTrade(X, X + M, port["strike"], payer=False)],
            seed=11).profile(port["x"])
        assert np.all(prof.netting_benefit >= -1e-12)
        assert np.max(prof.netting_benefit) > 0.0

    def test_guards(self, port):
        s = port["strike"]
        with pytest.raises(ValueError):
            BermudanSwaptionTrade((X, X), X + M, s)
        with pytest.raises(ValueError):
            BermudanSwaptionTrade((X + M,), X + M, s)
        with pytest.raises(ValueError):
            _engine(port, [BermudanSwaptionTrade((X,), X + M, s)],
                    observation_indices=[2, 4])
        eng = _engine(port, [BermudanSwaptionTrade((X,), X + M, s)])
        with pytest.raises(NotImplementedError):
            eng.cva_forward_deltas(port["x"], hazard_rate=0.01)
        with pytest.raises(NotImplementedError):
            eng.im_profile(port["x"])


# ---------------------------------------------------------------------------
# on the card (gpu marker): the same engine on the CPU and on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engines run on the card here")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["swap", "mixed"])
def test_profile_on_card_matches_cpu(kind):
    """The card's profile against the CPU's on one injected block: EE,
    ENE, forward value within 32 float32 ulps of each date's largest
    |V/N|, the PFE within 32 ulps of |V| (swap; the mixed set's
    regressions within 1e-6 of the profile's largest value)."""
    _needs_card()
    st = build_atm_calibration(num_paths=PATHS, num_factors=1, device=CPU)
    m, x = st.model, st.covariance.initial_parameters
    par = float(par_swap_rate(m.forward_curve, m.discount_curve,
                              m.tenor_times[FIRST:LAST + 1]))
    inc = _increments()

    def engine(device):
        if kind == "swap":
            return SwapExposureEngine(m, FIRST, LAST, par, num_paths=PATHS,
                                      increments=inc, device=device)
        strike = float(par_swap_rate(m.forward_curve, m.discount_curve,
                                     m.tenor_times[X:X + M + 1]))
        return NettingSetExposureEngine(m, _mixed_trades(tx, strike),
                                        num_paths=PATHS, increments=inc,
                                        device=device)

    cpu_eng, card_eng = engine(CPU), engine("cuda")
    p_cpu, p_card = cpu_eng.profile(x), card_eng.profile(x)
    if kind == "swap":
        v, inv_n = _port_pathwise(cpu_eng, x)
        for row in ("ee", "ene", "forward_value"):
            assert np.all(np.abs(getattr(p_card, row) - getattr(p_cpu, row))
                          <= _ulps(v * inv_n))
        for q in p_cpu.pfe:
            assert np.all(np.abs(p_card.pfe[q] - p_cpu.pfe[q]) <= _ulps(v))
        c_cpu, g_cpu = cpu_eng.cva_forward_deltas(x, hazard_rate=HAZARD)
        c_card, g_card = card_eng.cva_forward_deltas(x, hazard_rate=HAZARD)
        assert np.max(np.abs(g_card - g_cpu)) <= 1e-4 * np.max(np.abs(g_cpu))
        assert np.all(g_card[LAST:] == 0.0)
        return
    scale = max(np.max(np.abs(getattr(p_cpu, r)))
                for r in ("ee", "ene", "forward_value"))
    for row in ("ee", "ene", "forward_value", "ee_standalone"):
        assert np.max(np.abs(getattr(p_card, row) - getattr(p_cpu, row))) \
            <= 1e-6 * scale
