"""The port's tridiagonal solver (``finmath_tpu_torch/ops/tridiagonal.py``)
against a dense NumPy solve, against its own sequential Thomas sweep and
against finmath_tpu's solver.

Tolerances:
* both methods against ``numpy.linalg.solve`` at n in {2, 3, 17, 128, 513}:
  rtol 1e-11, atol 1e-12 (``tests/test_tridiagonal.py:46-47``);
* prefix against scan at n = 801: rtol 1e-11, atol 1e-13 (``:56-57``);
* the port's prefix against the JAX prefix on the same systems: 1e-12
  relative to each system's largest |x| (the two doubling orders round
  differently; measured 4.1e-16 at n = 513);
* autograd through the prefix solve against ``jax.grad`` of the JAX one:
  1e-9 relative to the largest gradient entry, the JAX file's own bound
  for prefix against scan (``:91``; measured 4.4e-16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.ops import tridiagonal as tt  # noqa: E402
from finmath_tpu_torch.ops.tridiagonal import (  # noqa: E402
    tridiagonal_matvec, tridiagonal_solve)

#: the systems held against the JAX prefix: (seed, batch, n)
JAX_CASES = ((7, (3,), 17), (8, (3,), 128), (9, (3,), 513))
GRAD_N = 33


def _random_system(rng, batch, n, dominance=2.5):
    lo = rng.standard_normal((*batch, n))
    up = rng.standard_normal((*batch, n))
    di = (np.abs(lo) + np.abs(up) + dominance
          + rng.random((*batch, n))) * np.where(
              rng.random((*batch, n)) > 0.5, 1.0, -1.0)
    rhs = rng.standard_normal((*batch, n))
    lo[..., 0] = 0.0
    up[..., -1] = 0.0
    return lo, di, up, rhs


def _dense_solve(lo, di, up, rhs):
    n = di.shape[-1]
    flat = [v.reshape(-1, n) for v in (lo, di, up, rhs)]
    out = np.empty_like(flat[3])
    for b in range(flat[0].shape[0]):
        a = np.zeros((n, n))
        a[np.arange(n), np.arange(n)] = flat[1][b]
        a[np.arange(1, n), np.arange(n - 1)] = flat[0][b][1:]
        a[np.arange(n - 1), np.arange(1, n)] = flat[2][b][:-1]
        out[b] = np.linalg.solve(a, flat[3][b])
    return out.reshape(rhs.shape)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _grad_system():
    return _random_system(np.random.default_rng(5), (), GRAD_N)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX prefix solves of ``JAX_CASES`` and ``jax.grad`` of the sum of
    squares through the JAX prefix solve (d/d di, d/d rhs), once."""
    import jax
    import jax.numpy as jnp

    from finmath_tpu.ops import tridiagonal as jt

    solves = {}
    for seed, batch, n in JAX_CASES:
        system = _random_system(np.random.default_rng(seed), batch, n)
        solves[n] = np.asarray(jax.jit(jt.tridiagonal_solve)(
            *(jnp.asarray(v) for v in system)))
    lo, di, up, rhs = _grad_system()

    def loss(di_v, rhs_v):
        x = jt.tridiagonal_solve(jnp.asarray(lo), di_v, jnp.asarray(up),
                                 rhs_v)
        return jnp.sum(x ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(di),
                                                    jnp.asarray(rhs))
    return solves, tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("method", ["prefix", "scan"])
@pytest.mark.parametrize("n", [2, 3, 17, 128, 513])
def test_matches_dense_solve(method, n):
    rng = np.random.default_rng(7 + n)
    lo, di, up, rhs = _random_system(rng, (3,), n)
    x = tridiagonal_solve(*_t(lo, di, up, rhs), method=method)
    expected = _dense_solve(lo, di, up, rhs)
    np.testing.assert_allclose(x.numpy(), expected, rtol=1e-11, atol=1e-12)


def test_prefix_agrees_with_scan_large():
    rng = np.random.default_rng(3)
    args = _t(*_random_system(rng, (4, 5), 801))
    xp = tridiagonal_solve(*args, method="prefix")
    xs = tridiagonal_solve(*args, method="scan")
    np.testing.assert_allclose(xp.numpy(), xs.numpy(), rtol=1e-11,
                               atol=1e-13)


def test_residual_and_matvec_roundtrip():
    rng = np.random.default_rng(11)
    lo, di, up, rhs = _random_system(rng, (2,), 257)
    args = _t(lo, di, up, rhs)
    x = tridiagonal_solve(*args)
    back = tridiagonal_matvec(args[0], args[1], args[2], x)
    np.testing.assert_allclose(back.numpy(), rhs, rtol=1e-10, atol=1e-11)


def test_weak_dominance_crank_nicolson_regime():
    # the matrices the theta scheme builds: I - 0.5 dt L with L a
    # convection-diffusion stencil; barely dominant rows
    n = 401
    dx = 8.0 / (n - 1)
    dt = 1.0 / 200
    x = np.linspace(-4.0, 4.0, n)
    sig2, r = 0.4 ** 2, 0.05
    drift = r - 0.5 * sig2
    lo = -0.5 * dt * (0.5 * sig2 / dx ** 2 - drift / (2 * dx)) * np.ones(n)
    up = -0.5 * dt * (0.5 * sig2 / dx ** 2 + drift / (2 * dx)) * np.ones(n)
    di = 1.0 - 0.5 * dt * (-sig2 / dx ** 2 - r) * np.ones(n)
    rhs = np.maximum(np.exp(x) - 1.0, 0.0)
    lo[0] = up[-1] = 0.0
    got = tridiagonal_solve(*_t(lo, di, up, rhs))
    np.testing.assert_allclose(got.numpy(), _dense_solve(lo, di, up, rhs),
                               rtol=1e-12, atol=1e-14)


def test_gradients_flow_through_solver():
    lo, di, up, rhs = _grad_system()

    def grads(method):
        d = torch.tensor(di, requires_grad=True)
        r = torch.tensor(rhs, requires_grad=True)
        x = tridiagonal_solve(torch.as_tensor(lo), d, torch.as_tensor(up), r,
                              method=method)
        torch.sum(x ** 2).backward()
        return d.grad.numpy(), r.grad.numpy()

    gp, gs = grads("prefix"), grads("scan")
    for a, b in zip(gp, gs):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10)
    # and against a central difference on one coordinate
    eps = 1e-6

    def loss(d):
        return float(torch.sum(tridiagonal_solve(
            *_t(lo, d, up, rhs)) ** 2))

    dp, dm = di.copy(), di.copy()
    dp[13] += eps
    dm[13] -= eps
    np.testing.assert_allclose(gp[0][13], (loss(dp) - loss(dm)) / (2 * eps),
                               rtol=1e-5)


def test_batch_rows_and_vmap_equal_single_solves():
    # each batch row is its own system: a batched solve, a torch.func.vmap
    # over the rows and a loop of single solves give the same bits (the
    # JAX file's jit and vmap check)
    rng = np.random.default_rng(9)
    args = _t(*_random_system(rng, (6,), 65))
    direct = tridiagonal_solve(*args)
    rows = torch.stack([tridiagonal_solve(*(a[i] for a in args))
                        for i in range(6)])
    mapped = torch.func.vmap(tridiagonal_solve)(*args)
    assert torch.equal(direct, rows)
    assert torch.equal(direct, mapped)


def test_factored_solve_equals_fresh_solve():
    # factoring once and reusing the factors (the PDE loop's reuse) gives
    # the bits of a fresh solve, the factors broadcast over the batch
    rng = np.random.default_rng(4)
    lo, di, up, _ = _random_system(rng, (), 129)
    rhs = rng.standard_normal((5, 129))
    factors = tt._factor(*_t(lo, di, up))
    got = tt._solve_factored(factors, torch.as_tensor(rhs))
    assert torch.equal(got, tridiagonal_solve(*_t(lo, di, up, rhs)))


def test_unknown_method_raises():
    args = _t(*_random_system(np.random.default_rng(1), (), 4))
    with pytest.raises(ValueError, match="unknown method"):
        tridiagonal_solve(*args, method="lu")


@pytest.mark.parametrize("seed,batch,n", JAX_CASES)
def test_prefix_matches_jax(jax_side, seed, batch, n):
    system = _random_system(np.random.default_rng(seed), batch, n)
    got = tridiagonal_solve(*_t(*system)).numpy()
    want = jax_side[0][n]
    scale = np.max(np.abs(want), axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-12 * scale)


def test_gradients_match_jax(jax_side):
    lo, di, up, rhs = _grad_system()
    d = torch.tensor(di, requires_grad=True)
    r = torch.tensor(rhs, requires_grad=True)
    x = tridiagonal_solve(torch.as_tensor(lo), d, torch.as_tensor(up), r)
    torch.sum(x ** 2).backward()
    for got, want in zip((d.grad.numpy(), r.grad.numpy()), jax_side[1]):
        assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))


@pytest.mark.gpu
def test_solve_on_card_matches_cpu():
    """Both methods on the card against the same solve on the CPU: the
    prefix solve within 1e-13 relative of each system's largest |x| (the
    card's division and the CPU's round alike; the bound leaves room for
    a contracted multiply-add), the scan within the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(21)
    args = _t(*_random_system(rng, (4, 81), 401))
    for method in ("prefix", "scan"):
        cpu = tridiagonal_solve(*args, method=method).numpy()
        card = tridiagonal_solve(*(a.cuda() for a in args),
                                 method=method).cpu().numpy()
        scale = np.max(np.abs(cpu), axis=-1, keepdims=True)
        assert np.all(np.abs(card - cpu) <= 1e-13 * scale), method
