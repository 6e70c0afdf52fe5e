"""The port's importance sampling and multilevel Monte Carlo
(``finmath_tpu_torch/models/importance_sampling.py``, ``mlmc.py``) against
finmath_tpu's, on ``tests/test_importance_sampling.py``'s and
``tests/test_mlmc.py``'s market (S0 100, r 5%, sigma 30%, T 1).

Both JAX functions draw Threefry normals inside their jitted programs;
torch cannot reproduce that stream, so the tests draw JAX's normals here
and inject them:
* importance sampling: ``jax.random.normal(PRNGKey(seed), (n,))``, 50,000
  paths, at the ATM, 2x, 3x and 4x spot strikes, a put and explicit tilts.
  The JAX function's ``exp32`` is a float32 exponential of its own and the
  port's is ``torch.exp``; one ulp of S_T becomes S_T / (S_T - K) ulps of
  a deep out-of-the-money payoff, so the gap grows into the tail: measured
  4.3e-9 relative at the money, 3.4e-8 at 3x, 3.3e-7 at 4x and 1.1e-6 on
  the untilted 3x stream (a few paths in the money). (price, stderr) within
  2e-6 relative and the price within 1e-4 of its standard error (measured
  at most 4.8e-5); 1e-9 holds only at the money;
* MLMC: ``fold_in(fold_in(PRNGKey(seed), level), draw)`` split into one
  key a coarse step, each split into (k1, k2); the level sums of levels
  0-3 within 1e-6 relative (measured at most 1.0e-7), the correction sum
  sum_Y of levels 1-3, a small difference of large payoffs, within 1e-6 of
  the level's payoff sum (measured 6.6e-8 of it, 9.4e-6 of itself);
* the adaptive loop: the port's ``_level_sums`` swapped for JAX's level
  sums (monkeypatch), so both loops see the same numbers: the levels and
  samples equal, the value, stderr and cost within 1e-12.
Then the JAX tests' bounds on the port's own torch streams."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models import analytic as tanalytic  # noqa: E402
from finmath_tpu_torch.models import importance_sampling as tis  # noqa: E402
from finmath_tpu_torch.models import mlmc as tml  # noqa: E402

S0, R, SIG, T = 100.0, 0.05, 0.3, 1.0
N, SEED, CPU = 50_000, 13, "cpu"
IS_CASES = [("atm", 100.0, True, None), ("2x", 200.0, True, None),
            ("3x", 300.0, True, None), ("4x", 400.0, True, None),
            ("3x-plain", 300.0, True, 0.0), ("120-tilt-1.5", 120.0, True, 1.5),
            ("put-0.4x", 40.0, False, None)]
ADAPTIVE = dict(eps=0.15, n_pilot=5_000, seed=7)


def jax_is_normals(seed, n):
    import jax
    import jax.numpy as jnp

    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                      dtype=jnp.float32))


def jax_level_normals(seed, level, draw, coarse, n):
    """The normals ``mlmc._lookback_level_kernel`` draws: ([coarse, n],
    [coarse, n])."""
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                level), draw)
    z1, z2 = [], []
    for k in jax.random.split(key, coarse):
        k1, k2 = jax.random.split(k)
        z1.append(jax.random.normal(k1, (n,), dtype=jnp.float32))
        z2.append(jax.random.normal(k2, (n,), dtype=jnp.float32))
    return np.array(jnp.stack(z1)), np.array(jnp.stack(z2))


def jax_level_sums(seed, level, draw, n, m0=4):
    import jax
    import jax.numpy as jnp
    from finmath_tpu.models.mlmc import _lookback_level_kernel

    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                level), draw)
    coarse = m0 * 2 ** max(level - 1, 0)
    f32 = jnp.float32
    return np.asarray(_lookback_level_kernel(
        key, int(n), int(coarse), level == 0, jnp.asarray(S0, f32),
        jnp.asarray(R, f32), jnp.asarray(SIG, f32), jnp.asarray(T, f32)))


@pytest.mark.parametrize("cid,k,call,shift", IS_CASES,
                         ids=[c[0] for c in IS_CASES])
def test_importance_sampling_on_jax_normals(cid, k, call, shift):
    from finmath_tpu.models.importance_sampling import (
        mc_european_price_importance_sampled as jis)

    jv, je = jis(SEED, N, S0, R, SIG, T, k, is_call=call, drift_shift=shift)
    v, e = tis.mc_european_price_importance_sampled(
        SEED, N, S0, R, SIG, T, k, is_call=call, drift_shift=shift,
        device=CPU, normals=jax_is_normals(SEED, N))
    assert v == pytest.approx(jv, rel=2e-6)
    assert abs(v - jv) < 1e-4 * je
    assert e == pytest.approx(je, rel=2e-6)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_mlmc_level_sums_on_jax_normals(level):
    n, draw = 20_000, 1
    coarse = 4 * 2 ** max(level - 1, 0)
    want = jax_level_sums(SEED, level, draw, n)
    z = jax_level_normals(SEED, level, draw, coarse, n)
    f32 = np.float32
    got = tml._lookback_level_kernel(
        n, coarse, level == 0, f32(S0), f32(R), f32(SIG), f32(T),
        normals=tuple(torch.as_tensor(x) for x in z))
    assert got.dtype == torch.float64 and tuple(got.shape) == (4,)
    # sum_Y of a correction level is a small difference of large
    # payoffs: its gap is held on the scale of the level's payoff sum
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * want[2])


def test_mlmc_adaptive_loop_on_jax_level_sums(monkeypatch):
    from finmath_tpu.models.mlmc import mlmc_lookback_call as jmlmc

    want = jmlmc(S0, R, SIG, T, **ADAPTIVE)

    def level_sums(level, n, draw, seed, m0, *args):
        return jax_level_sums(seed, level, draw, n, m0)

    monkeypatch.setattr(tml, "_level_sums", level_sums)
    got = tml.mlmc_lookback_call(S0, R, SIG, T, device=CPU, **ADAPTIVE)
    assert isinstance(got, tml.MLMCResult)
    assert got.levels == want.levels and got.samples == want.samples
    for key in ("value", "stderr", "total_fine_steps", "bias_estimate"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=1e-12), key
    np.testing.assert_allclose(got.level_means, want.level_means, rtol=1e-12)
    np.testing.assert_allclose(got.level_vars, want.level_vars, rtol=1e-12)


def test_importance_sampling_bounds_on_the_port_stream():
    def price(seed, k, **kw):
        return tis.mc_european_price_importance_sampled(
            seed, N, S0, R, SIG, T, k, device=CPU, **kw)

    v, e = price(7, 100.0)
    an = tanalytic.black_scholes_option_value(S0, R, SIG, T, 100.0)
    assert abs(v - an) < 4 * e
    for mult in (2.0, 3.0, 4.0):
        v, e = price(7, mult * S0)
        an = tanalytic.black_scholes_option_value(S0, R, SIG, T, mult * S0)
        assert e < 0.05 * an and abs(v - an) < 4 * e
    an = tanalytic.black_scholes_option_value(S0, R, SIG, T, 120.0)
    for mu in (0.0, 0.5, 1.5):
        v, e = price(11, 120.0, drift_shift=mu)
        assert abs(v - an) < 4 * e, mu
    _, e_plain = price(13, 300.0, drift_shift=0.0)
    _, e_is = price(13, 300.0)
    assert e_is < e_plain / 10
    v, e = price(17, 40.0, is_call=False)
    an = tanalytic.black_scholes_option_value(S0, R, SIG, T, 40.0,
                                              is_call=False)
    assert abs(v - an) < 4 * e and e < 0.05 * an
    with pytest.raises(ValueError, match="normals must be"):
        price(1, 100.0, normals=np.zeros(7, np.float32))


def test_mlmc_on_the_port_stream():
    res = tml.mlmc_lookback_call(S0, R, SIG, T, device=CPU, **ADAPTIVE)
    an = tanalytic.lookback_floating_strike_value(S0, R, SIG, T, True)
    assert abs(res.value - an) < 2.5 * ADAPTIVE["eps"]
    assert len(res.levels) >= 3 and res.samples[0] > 5 * res.samples[-1]
    v = res.level_vars
    assert all(b < 0.85 * a for a, b in zip(v[1:-1], v[2:]))
    fine_steps = 4 * 2 ** (len(res.levels) - 1)
    assert res.total_fine_steps < 0.5 * sum(res.samples) * fine_steps
    # one (level, draw) is one stream: equal calls, equal sums
    f32 = np.float32
    args = (2_000, 8, False, f32(S0), f32(R), f32(SIG), f32(T))
    a = tml._lookback_level_kernel(
        *args, generator=tml._level_generator(3, 2, 0, CPU), device=CPU)
    b = tml._lookback_level_kernel(
        *args, generator=tml._level_generator(3, 2, 0, CPU), device=CPU)
    c = tml._lookback_level_kernel(
        *args, generator=tml._level_generator(3, 2, 1, CPU), device=CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="normals must be"):
        tml._lookback_level_kernel(
            *args, normals=(torch.zeros(8, 5), torch.zeros(8, 5)))


def test_mlmc_telescoping_on_the_port_stream():
    """``tests/test_mlmc.py::test_telescoping_consistency`` on the port's
    streams: the corrections through level 3 sum to the direct level-3
    fine estimate within 6 standard errors."""
    f32 = np.float32
    args = (f32(S0), f32(R), f32(SIG), f32(T))
    n, total = 100_000, 0.0
    for lv in range(4):
        coarse = 4 * 2 ** max(lv - 1, 0)
        out = tml._lookback_level_kernel(
            n, coarse, lv == 0, *args,
            generator=tml._level_generator(3, lv, 0, CPU), device=CPU)
        total += float(out[0]) / n
    out3 = tml._lookback_level_kernel(
        n, 16, False, *args, generator=tml._level_generator(3, 99, 0, CPU),
        device=CPU).numpy()
    direct = out3[2] / n
    se = math.sqrt(out3[3] / n - direct ** 2) / math.sqrt(n)
    assert abs(total - direct) < 6 * se
