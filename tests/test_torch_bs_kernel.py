"""The Monte-Carlo Black-Scholes path kernels' plain versions
(``ops/kernels.py``) and, on a card, the CUDA kernels against them.

On the CPU:
* the plain Philox4x32-10 against Random123's published known-answer
  vectors and against a NumPy uint64 Philox on random counters (exact);
* the plain side of the exhaustive Box-Muller check (``box_muller_parts``:
  the radius and the angle of the words ``m << 8``) against NumPy float64
  on 4,096 values of m up to 2^24 - 1, from the same float32 u1 and theta
  (the radius within 4 float32 ulps, the cosine and sine within 2e-7),
  the radius of the largest word -0 (u1 rounds to 1), and its wrapper's
  checks;
* the normals' moments at 1M samples (5-sigma bounds from the sample size);
* ``bs_payoffs_with_normals`` / ``asian_payoffs_with_normals`` against a
  float64 NumPy recurrence of the Pallas kernels' path arithmetic
  (finmath_tpu/ops/kernels.py:104-122, :192-216) on the same float32
  normals, 1e-6 * max(1, |payoff|) per path at up to 20 steps (float32
  rounding of log S grows like the square root of the step count: at 100
  steps its largest error over 4,096 paths reaches about 1.2e-6);
* the plain European price on the reference's Mersenne normals against the
  JAX object-API price on the same normals, 1e-5 relative (the kernel adds
  two steps' normals before scaling, the Euler scheme scales each step);
* the plain price against the analytic price, within 4 standard errors.

The Pallas kernels are not run: under the interpreter they do not honour
the seed (tests/test_pallas_kernels.py:1-10), and the TPU's random bits
cannot be reproduced anyway.

On a card (the ``gpu`` tests): the generator, the Box-Muller parts on a
strided subset of the 2^24 inputs and both path kernels, each bit for bit
against its plain version.

The ``gpu`` tests need a card and no JAX; on a machine with the card:
``python -m pytest tests/test_torch_bs_kernel.py -m gpu --noconftest``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models.analytic import (  # noqa: E402
    black_scholes_option_value)
from finmath_tpu_torch.native.host_rng import HostRandomGenerator  # noqa: E402
from finmath_tpu_torch.ops import kernels  # noqa: E402

S0, R, SIGMA, T, K = 1.0, 0.05, 0.30, 1.0, 1.05
CPU = "cpu"

KNOWN_ANSWERS = [   # Random123 kat_vectors, philox4x32_10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _numpy_philox(ctr, key):
    """Philox4x32-10 in NumPy uint64 arithmetic (independent of the port)."""
    m = np.uint64(0xFFFFFFFF)
    c = [np.asarray(x, dtype=np.uint64) for x in ctr]
    k = [np.asarray(x, dtype=np.uint64) for x in key]
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & m,
                 (k[1] + np.uint64(0xBB67AE85)) & m]
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & m,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & m]
    return c


@pytest.mark.parametrize("ctr,key,expected", KNOWN_ANSWERS,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, expected):
    out = kernels.philox4x32_10(
        [torch.tensor([c], dtype=torch.int64) for c in ctr],
        [torch.tensor([k], dtype=torch.int64) for k in key])
    assert [int(w[0]) for w in out] == list(expected)
    assert [int(w) for w in _numpy_philox(ctr, key)] == list(expected)


def test_philox_matches_numpy_on_random_counters():
    rng = np.random.default_rng(5)
    ctr = rng.integers(0, 2 ** 32, size=(4, 4096), dtype=np.uint64)
    key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64)
    got = kernels.philox4x32_10(
        [torch.from_numpy(c.astype(np.int64)) for c in ctr],
        [int(k) for k in key])
    ref = _numpy_philox(ctr, key)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.astype(np.int64))


def test_normals_layout_and_box_muller():
    seed = (17 << 32) | 9            # both key words in use
    z = kernels.normal_pairs(seed, 300, 3, CPU)
    assert tuple(z.shape) == (12, 300) and z.dtype == torch.float32
    # counter-based: a path's stream does not depend on the path count
    assert torch.equal(kernels.normal_pairs(seed, 100, 2, CPU), z[:8, :100])
    # rows 4d..4d+3: Box-Muller of words (0, 1) and (2, 3) of draw d,
    # here in float64 from the NumPy Philox words
    path = np.arange(300, dtype=np.uint64)
    w = _numpy_philox((path, np.full(300, 2, np.uint64), 0 * path, 0 * path),
                      (np.uint64(9), np.uint64(17)))
    zs = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        u1 = (a >> np.uint64(8)).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25
        u2 = (b >> np.uint64(8)).astype(np.float64) * 2.0 ** -24
        r = np.sqrt(-2.0 * np.log(u1))
        zs += [r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)]
    np.testing.assert_allclose(z[8:12].numpy(), np.stack(zs), rtol=0,
                               atol=2e-6)
    with pytest.raises(ValueError):
        kernels.normal_pairs(-1, 10, 1, CPU)


# m = 4097 i for i < 4096: 4,096 values spread over [0, 2^24), the last
# one 2^24 - 1, whose u1 rounds to 1
PARTS_COUNT, PARTS_STRIDE = 4096, 4097


def test_box_muller_parts_reference_against_numpy():
    parts = kernels.box_muller_parts_reference(PARTS_COUNT, PARTS_STRIDE,
                                               CPU)
    assert tuple(parts.shape) == (3, PARTS_COUNT)
    assert parts.dtype == torch.float32
    m = np.arange(PARTS_COUNT, dtype=np.int64) * PARTS_STRIDE
    assert m[-1] == 2 ** 24 - 1
    u1 = (m * 2.0 ** -24 + 2.0 ** -25).astype(np.float32).astype(np.float64)
    theta = (np.float32(2 * np.pi) * (m * 2.0 ** -24).astype(np.float32))
    theta = theta.astype(np.float64)
    radius = np.sqrt(-2.0 * np.log(u1))
    ulp = np.spacing(radius.astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(parts[0].numpy() - radius) <= 4 * ulp)
    np.testing.assert_allclose(parts[1].numpy(), np.cos(theta), rtol=0,
                               atol=2e-7)
    np.testing.assert_allclose(parts[2].numpy(), np.sin(theta), rtol=0,
                               atol=2e-7)
    # the largest word: u1 = 1, radius -0, so both normals are zeros
    assert u1[-1] == 1.0 and math.copysign(1.0, float(parts[0, -1])) == -1.0
    # the normals are the radius times the angle, as the kernels form them
    w = torch.from_numpy(m << 8)
    z_cos, z_sin = kernels.box_muller(w, w)
    assert torch.equal(z_cos, parts[0] * parts[1])
    assert torch.equal(z_sin, parts[0] * parts[2])


@pytest.mark.parametrize("count,stride", [(0, 1), (1, 0), (2 ** 24 + 1, 1),
                                          (4097, 4096)])
def test_box_muller_parts_checks(count, stride):
    launches = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.box_muller_parts(8, 3, CPU),
                       kernels.box_muller_parts_reference(8, 3, CPU))
    assert kernels.LAUNCHES == launches       # CPU: the plain version
    with pytest.raises(ValueError):
        kernels.box_muller_parts(count, stride, CPU)


def test_normals_moments():
    z = kernels.philox_normals(2718, 250_000, 1, CPU).reshape(-1).double()
    n = z.numel()
    assert n == 1_000_000
    assert abs(float(z.mean())) < 5 / math.sqrt(n)
    assert abs(float((z * z).mean()) - 1) < 5 * math.sqrt(2 / n)
    assert abs(float((z ** 4).mean()) - 3) < 5 * math.sqrt(96 / n)


def _numpy_paths(z, params, asian):
    """The Pallas kernels' path arithmetic in float64 on the same inputs."""
    z = z.astype(np.float64)
    log_s0, drift, vol, strike = (float(v) for v in params[:4])
    steps = z.shape[0]
    log_s = np.full(z.shape[1], log_s0)
    if asian:
        total = np.zeros(z.shape[1])
        for i in range(steps):
            log_s = log_s + drift + vol * z[i]
            total += np.exp(log_s)
        return np.maximum(total / steps - strike, 0.0)
    for j in range(steps // 2):
        log_s = log_s + 2 * drift + vol * (z[2 * j] + z[2 * j + 1])
    if steps % 2:
        log_s = log_s + drift + vol * z[steps - 1]
    return np.maximum(np.exp(log_s) - strike, 0.0)


@pytest.mark.parametrize("steps", [1, 7, 20])
@pytest.mark.parametrize("asian", [False, True], ids=["european", "asian"])
def test_path_arithmetic_matches_float64(steps, asian):
    rng = np.random.default_rng(steps)
    z = rng.standard_normal((steps, 4096)).astype(np.float32)
    params = kernels.path_params(steps, S0, R, SIGMA, T, 1.0)
    fn = (kernels.asian_payoffs_with_normals if asian
          else kernels.bs_payoffs_with_normals)
    got = fn(torch.from_numpy(z), params)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4096,)
    ref = _numpy_paths(z, params.numpy(), asian)
    assert np.count_nonzero(ref) > 1000
    np.testing.assert_array_less(np.abs(got.numpy() - ref),
                                 1e-6 * np.maximum(1.0, np.abs(ref)))


def test_plain_price_matches_jax_object_api_on_mersenne_normals():
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models import time_discretization as jtd

    paths, steps, seed = 16_384, 20, 3141
    td = jtd.TimeDiscretization(initial=0.0, num_steps=steps, step=T / steps)
    sim = jbs.MonteCarloBlackScholesModel(
        td, paths, jbs.BlackScholesModel(S0, R, SIGMA),
        brownian=jbm.BrownianMotionFinmathMersenne(td, 1, paths, seed))
    jax_price = jbs.EuropeanOption(T, K).get_value(sim)
    # the same stream as standard normals: path-major, [steps, paths]
    z = HostRandomGenerator(seed, "finmath_mersenne").normals_f64(
        paths * steps).reshape(paths, steps).T.astype(np.float32)
    payoffs = kernels.bs_payoffs_with_normals(
        torch.from_numpy(np.ascontiguousarray(z)),
        kernels.path_params(steps, S0, R, SIGMA, T, K))
    price = float(payoffs.double().mean()) * math.exp(-R * T)
    assert price == pytest.approx(jax_price, rel=1e-5)


def test_plain_prices_against_analytic_and_wrappers():
    paths, steps = 100_000, 50
    launches = dict(kernels.LAUNCHES)
    price = kernels.mc_european_call_price_kernel(3141, paths, steps, S0, R,
                                                  SIGMA, T, K, device=CPU)
    pay = kernels.bs_paths_reference(
        3141, paths, steps, kernels.path_params(steps, S0, R, SIGMA, T, K),
        CPU).double()
    df = math.exp(-R * T)
    assert price == float(pay.sum() / paths) * df
    se = float(pay.std()) * df / math.sqrt(paths)
    analytic = black_scholes_option_value(S0, R, SIGMA, T, K)
    assert abs(price - analytic) < 4 * se
    asian = kernels.mc_asian_call_price_kernel(3141, paths, steps, S0, R,
                                               SIGMA, T, K, device=CPU)
    assert 0 < asian < price
    assert kernels.LAUNCHES == launches       # CPU: the plain versions
    assert kernels.mc_european_call_price_pallas is \
        kernels.mc_european_call_price_kernel
    assert kernels.mc_asian_call_price_pallas is \
        kernels.mc_asian_call_price_kernel


def test_wrapper_rejects_bad_inputs():
    params = kernels.path_params(4, S0, R, SIGMA, T, K)
    with pytest.raises(ValueError):                  # seed out of range
        kernels.bs_payoffs(-1, 10, 4, params, CPU)
    with pytest.raises(ValueError):                  # no paths
        kernels.asian_payoffs(1, 0, 4, params, CPU)
    with pytest.raises(ValueError):                  # no steps
        kernels.bs_payoffs(1, 10, 0, params, CPU)
    with pytest.raises(ValueError):                  # float64 params
        kernels.bs_payoffs(1, 10, 4, params.double(), CPU)
    with pytest.raises(ValueError):                  # another device type
        kernels.bs_payoffs(1, 10, 4, params, "meta")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
def test_cuda_generator_matches_plain_bitwise():
    _needs_card()
    seed = (3 << 32) | 3141
    got = kernels.philox_normals(seed, 5003, 3, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.normal_pairs(seed, 5003, 3, "cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 2, 7, 8])
@pytest.mark.parametrize("asian", [False, True], ids=["european", "asian"])
def test_cuda_kernel_matches_plain_version(steps, asian):
    _needs_card()
    params = kernels.path_params(steps, S0, R, SIGMA, T, K)
    run = kernels.asian_payoffs if asian else kernels.bs_payoffs
    plain = (kernels.asian_paths_reference if asian
             else kernels.bs_paths_reference)
    name = "asian_paths" if asian else "bs_paths"
    launches = kernels.LAUNCHES[name]
    got = run(11, 5003, steps, params, "cuda")
    again = run(11, 5003, steps, params, "cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == launches + 2
    assert torch.equal(got, again)
    ref = plain(11, 5003, steps, params, "cuda")
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [97, PARTS_STRIDE])
def test_cuda_box_muller_parts_equal_plain_version(stride):
    _needs_card()
    count = (2 ** 24 - 1) // stride + 1
    launches = kernels.LAUNCHES["box_muller_parts"]
    got = kernels.box_muller_parts(count, stride, "cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["box_muller_parts"] == launches + 1
    ref = kernels.box_muller_parts_reference(count, stride, "cuda")
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
