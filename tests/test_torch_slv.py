"""The port's Heston-SLV particle method (``finmath_tpu_torch/models/slv.py``)
against finmath_tpu's, on ``tests/test_slv.py``'s surfaces and Heston
parameters at a small size.

* The hat nodes bit for bit equal to ``jnp.linspace``'s (built as XLA
  compiles it on the CPU), the hat basis within an ulp.
* The regression on a shared particle cloud: ``_fit_conditional_variance``
  and ``_total_vol`` within 1e-5 relative of the JAX ones (the float32
  Gram sums in another order than XLA's CPU matmul; measured at most
  6.7e-7 on the total volatility).
* Step by step on shared states: the JAX facade's state at each step of
  the Mersenne paths, advanced one Euler step by the port, within 1e-5 of
  the JAX facade's next state (relative to the component's largest
  value; measured 8.7e-7 on log S, 7.5e-8 on V).
* End to end on the Mersenne increments (2 factors): the vanilla prices
  within 2 standard errors of the JAX facade's (the paths follow the
  leverage's last-bit gaps over the steps; measured at most 3.3e-4
  standard errors, the states 4.4e-6 apart after 20 steps),
  ``leverage_at`` within 1e-4 (measured 3.5e-6).
* The once-a-step fit (the ``_total_vol`` cache) bit-equal to fitting for
  the drift and again for the loadings; ``mixing=0`` on the flat surface
  against term-vol Black-Scholes (``tests/test_slv.py:70-86``) on the
  port's stream; the validation errors, the device rule, and on a mesh
  of one rank (``OneRankMesh``): the meshed fit's two all-reduces, a
  named ``axis_name`` (also one converted from a JAX model) bound by the
  meshed facade and refused unbound, and a foreign mesh object refused
  (``tests/test_torch_slv_products_mesh.py`` runs four ranks)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import heston as th  # noqa: E402
from finmath_tpu_torch.models import local_vol as tlv  # noqa: E402
from finmath_tpu_torch.models import slv as tslv  # noqa: E402
from finmath_tpu_torch.models.analytic import (  # noqa: E402
    black_scholes_option_value)
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)
from finmath_tpu_torch.parallel.mesh import PathMesh  # noqa: E402
from test_torch_fourier_bachelier import (  # noqa: E402, F401
    _raises_alike, one_blas_thread)

CPU = "cpu"
S0, R = 100.0, 0.03
FLAT = dict(sigma0=0.25, sigma_inf=0.20, tau=1.5, rho=0.0, eta=0.0)
SKEW = dict(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65, eta=0.6,
            gamma=0.4)
HESTON = dict(initial_value=S0, risk_free_rate=R, v0=0.04, kappa=1.5,
              theta=0.06, xi=0.8, rho=-0.7)
PATHS, STEPS, SEED = 20_000, 20, 8
STRIKES = [85.0, 92.5, 100.0, 110.0, 120.0]


def jslv():
    from finmath_tpu.models import slv
    return slv


def jax_model(td, surf=SKEW, **kw):
    from finmath_tpu.models import heston as jh
    from finmath_tpu.models import local_vol as jlv
    return jslv().HestonSLVModel(jh.HestonParams(**HESTON),
                                 jlv.SSVISurface(**surf), td, **kw)


def port_model(td, surf=SKEW, **kw):
    return tslv.HestonSLVModel(th.HestonParams(**HESTON),
                               tlv.SSVISurface(**surf), td, **kw)


def grids():
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)
    return (JTD(initial=0.0, num_steps=STEPS, step=1.0 / STEPS),
            TimeDiscretization(initial=0.0, num_steps=STEPS,
                               step=1.0 / STEPS))


@pytest.mark.parametrize("z_max,num_basis", [(3.0, 13), (2.0, 9), (1.0, 21),
                                             (3.0, 5)])
def test_nodes_bit_equal(z_max, num_basis):
    import jax.numpy as jnp

    want = np.asarray(jnp.linspace(-z_max, z_max, num_basis,
                                   dtype=jnp.float32))
    got = tslv._nodes(z_max, num_basis)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_hat_basis():
    import jax.numpy as jnp

    nodes = tslv._nodes(3.0, 13)
    z = np.linspace(-5.0, 5.0, 401).astype(np.float32)
    got = tslv.hat_basis(torch.as_tensor(z), torch.as_tensor(nodes)).numpy()
    want = np.asarray(jslv().hat_basis(jnp.asarray(z), jnp.asarray(nodes)))
    assert got.shape == want.shape == (13, 401)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
    np.testing.assert_allclose(got.sum(axis=0), 1.0, atol=1e-6)


def _cloud(paths=20_000, seed=4):
    rng = np.random.default_rng(seed)
    k = (0.25 * rng.standard_normal(paths) - 0.02).astype(np.float32)
    v = np.maximum(0.05 - 0.08 * k + 0.02 * rng.standard_normal(paths),
                   0.0).astype(np.float32)
    return k, v


def test_regression_on_a_shared_cloud():
    import jax.numpy as jnp

    k, v = _cloud()
    nodes = tslv._nodes(3.0, 13)
    beta, m, s = tslv._fit_conditional_variance(
        torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(nodes))
    jbeta, jm, js = jslv()._fit_conditional_variance(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(nodes))
    assert beta.dtype == torch.float64
    assert float(m) == pytest.approx(float(jm), rel=1e-5)
    assert float(s) == pytest.approx(float(js), rel=1e-6)
    # the fitted E[v | k] on the cloud
    z = (torch.as_tensor(k) - m) / s
    cond = (beta.float()[None] @ tslv.hat_basis(z, torch.as_tensor(nodes)))
    jz = (jnp.asarray(k) - jm) / js
    jcond = jbeta.astype(jnp.float32)[None] @ jslv().hat_basis(
        jz, jnp.asarray(nodes))
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), rtol=1e-5)
    jtd, td = grids()
    state = np.stack([np.log(S0) + k, v]).astype(np.float32)
    for i in (0, 5, STEPS - 1):
        got = port_model(td)._total_vol(i, torch.as_tensor(state))
        want = jax_model(jtd)._total_vol(i, jnp.asarray(state))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.fixture(scope="module")
def mersenne_pair():
    from finmath_tpu.models import brownian_motion as jbm

    jtd, td = grids()
    jsim = jslv().MonteCarloHestonSLVModel(
        jtd, PATHS, jax_model(jtd),
        brownian=jbm.BrownianMotionFinmathMersenne(jtd, 2, PATHS, SEED))
    tsim = tslv.MonteCarloHestonSLVModel(
        td, PATHS, port_model(td),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 2, PATHS, SEED,
                                                   device=CPU))
    from finmath_tpu.models.local_vol import european_call_values
    return dict(
        jsim=jsim, tsim=tsim,
        states=np.asarray(jsim.process._lazy_states()),
        inc=np.asarray(jsim.brownian.increments),
        prices=european_call_values(jsim, STRIKES, [0.5, 1.0]),
        leverage=jsim.leverage_at(0.5, STRIKES))


def test_step_by_step_on_shared_states(mersenne_pair):
    js, inc = mersenne_pair["states"], mersenne_pair["inc"]
    _, td = grids()
    model = port_model(td)
    dts = np.asarray(td.get_step_sizes(), dtype=np.float32)
    scale = np.abs(js).max(axis=(0, 2))
    worst = np.zeros(2)
    for i in range(STEPS):
        state = torch.as_tensor(js[i])
        mu = model.drift(i, state)
        lam = model.factor_loadings(i, state)
        nxt = state + mu * float(dts[i]) + torch.sum(
            lam * torch.as_tensor(inc[i])[None], dim=1)
        worst = np.maximum(worst, np.abs(nxt.numpy() - js[i + 1]).max(
            axis=1) / scale)
    assert np.all(worst < 1e-5), worst


def test_facades_end_to_end(mersenne_pair):
    tsim = mersenne_pair["tsim"]
    got = tlv.european_call_values(tsim, STRIKES, [0.5, 1.0])
    want = mersenne_pair["prices"]
    assert got.shape == want.shape == (2, 5, 2)
    assert np.all(np.abs(got[..., 0] - want[..., 0]) <= 2 * want[..., 1])
    lev = tsim.leverage_at(0.5, STRIKES)
    assert lev.shape == (5,) and lev.dtype == np.float32
    np.testing.assert_allclose(lev, mersenne_pair["leverage"], rtol=1e-4)
    v1 = tsim.get_variance_value(1.0)
    assert v1.size() == PATHS


def test_fit_once_a_step_is_bit_equal():
    _, td = grids()
    runs = []
    for cached in (True, False):
        model = port_model(td)
        if not cached:      # fit for the drift and again for the loadings
            model._total_vol = model._compute_total_vol
        sim = tslv.MonteCarloHestonSLVModel(td, 4_000, model, seed=3,
                                            device=CPU)
        runs.append(sim.process._lazy_states())
    assert torch.equal(runs[0], runs[1])
    # one fit a step: drift and loadings of one state share it
    model = port_model(td)
    calls = []
    real = model._compute_total_vol
    model._compute_total_vol = lambda i, s: calls.append(i) or real(i, s)
    state = model.initial_state(100, CPU)
    model.drift(0, state)
    model.factor_loadings(0, state)
    assert calls == [0]


def test_mixing_zero_is_black_scholes_on_flat_surface():
    p = dict(HESTON, v0=0.05, theta=0.05)
    td = TimeDiscretization(initial=0.0, num_steps=50, step=0.02)
    model = tslv.HestonSLVModel(th.HestonParams(**p),
                                tlv.SSVISurface(**FLAT), td, mixing=0.0)
    mc = tslv.MonteCarloHestonSLVModel(td, 30_000, model, seed=9,
                                       device=CPU)
    out = tlv.european_call_values(mc, [80.0, 100.0, 125.0], [1.0])
    sig = math.sqrt(tlv.SSVISurface(**FLAT).theta(1.0))
    for j, strike in enumerate([80.0, 100.0, 125.0]):
        v, e = out[0, j]
        an = black_scholes_option_value(S0, R, sig, 1.0, strike)
        assert abs(v - an) < 4 * e + 2e-3 * an


class OneRankMesh(PathMesh):
    """A ``PathMesh`` of one rank with no process group: its all-reduce
    returns a copy and counts the call, its gather a copy."""

    def __init__(self):
        super().__init__(None, 0, 1, torch.device(CPU), "gloo")

    def all_reduce(self, x, op="sum"):
        self.calls += 1
        return x.clone()

    def all_gather(self, x):
        return x.clone()


def test_converted_named_axis_binds_to_the_mesh():
    from finmath_tpu_torch import convert

    jtd, td = grids()
    model = convert.equity_model_from_jax(jax_model(jtd, axis_name="paths"))
    assert model.axis_name == "paths" and model.mesh is None
    assert model != port_model(td)
    with pytest.raises(ValueError, match="bound to no mesh"):
        model._total_vol(0, model.initial_state(16, CPU))
    one = OneRankMesh()
    bound = model.on_mesh(one)
    k, v = _cloud(512)
    state = torch.as_tensor(np.stack([np.log(S0) + k, v]).astype(np.float32))
    np.testing.assert_allclose(
        bound._total_vol(3, state).numpy(),
        convert.equity_model_from_jax(jax_model(jtd))._total_vol(
            3, state).numpy(), rtol=1e-6)
    assert one.calls == 2


def test_validation_and_device_rule(monkeypatch):
    jtd, td = grids()
    for kw in (dict(mixing=1.5), dict(mixing=-0.1), dict(num_basis=2)):
        _raises_alike(lambda: port_model(td, **kw),
                      lambda: jax_model(jtd, **kw))
    # a meshed fit: on a mesh of one rank the two all-reduces (count and
    # moments, then Gram and right-hand side) leave the fit as it is;
    # tests/test_torch_slv_products_mesh.py holds four ranks against it
    k, v = _cloud(2_000)
    nodes = torch.as_tensor(tslv._nodes(3.0, 13))
    one = OneRankMesh()
    meshed = tslv._fit_conditional_variance(
        torch.as_tensor(k), torch.as_tensor(v), nodes, axis_name=one)
    plain = tslv._fit_conditional_variance(
        torch.as_tensor(k), torch.as_tensor(v), nodes)
    assert one.calls == 2
    for a, b in zip(meshed, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    # a named axis is bound by the meshed facade, and raises unbound
    named = port_model(td, axis_name="paths")
    with pytest.raises(ValueError, match="bound to no mesh"):
        tslv.MonteCarloHestonSLVModel(td, 64, named, seed=1, device=CPU
                                      ).get_asset_value(1.0)
    one = OneRankMesh()
    sim = tslv.MonteCarloHestonSLVModel(td, 64, named, seed=1, mesh=one,
                                        device=CPU)
    assert sim.model.mesh is one and sim.mesh is one and named.mesh is None
    assert sim.model != named and sim.model.on_mesh(one) is sim.model
    free = tslv.MonteCarloHestonSLVModel(td, 64, port_model(td), seed=1,
                                         device=CPU)
    np.testing.assert_allclose(sim.get_asset_value(1.0).get_realizations(),
                               free.get_asset_value(1.0).get_realizations(),
                               rtol=1e-6)
    assert one.calls == 2 * STEPS
    with pytest.raises(ValueError, match="already"):
        sim.model.on_mesh(OneRankMesh())
    # a foreign mesh object is refused by parallel.mesh.check_mesh
    with pytest.raises(NotImplementedError, match="PathMesh"):
        port_model(td, axis_name=object())
    bm = tbm.BrownianMotion(td, 2, 256, 7, device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        tslv.MonteCarloHestonSLVModel(td, 512, port_model(td), brownian=bm)
    with pytest.raises(NotImplementedError, match="PathMesh"):
        tslv.MonteCarloHestonSLVModel(td, 8, port_model(td), mesh=object(),
                                      device=CPU)
    m1, m2 = port_model(td), port_model(td)
    assert m1 == m2 and hash(m1) == hash(m2)
    assert m1 != port_model(td, mixing=0.5)
    sim = tslv.MonteCarloHestonSLVModel(td, 64, m1, seed=1, device=CPU)
    with pytest.raises(ValueError, match="positive grid time"):
        sim.leverage_at(0.0, [100.0])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tslv.MonteCarloHestonSLVModel(td, 8, m1)
