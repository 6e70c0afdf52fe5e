"""The port's lazy engine (``ops/lazy.py``): the cases of
tests/test_lazy.py that do not depend on the JAX pytree, on the port.

A flush runs the eager type's own array functions, so every chain here
equals the strict ``RandomVariableTorch`` chain bit for bit (compared as
int32 views), including exp, log and pow: stricter than the JAX package's
own lazy contract (1e-6 * (1 + |x|), tests/test_lazy.py:24-31). Against
the JAX package's lazy chains on the same seeded inputs, the values agree
within 2.5e-7 relative (the port's op-parity bound,
tests/test_torch_random_variable.py; sqrt, log and pow 5e-7 per
operation). The program cache is keyed by structure
(``program_cache_size``); on the CPU a program is one pass over the DAG.

On a card (the ``gpu`` tests, no JAX needed): the flush as a CUDA graph,
bit for bit against eager on the card, scalars as graph inputs (a
second run with new scalars replays the same graph), and one graph for a
batch of chains through ``averages``."""

import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models.lmm.eager import (  # noqa: E402
    eager_swaption_valuation)
from finmath_tpu_torch.ops import (RandomVariableFloat,  # noqa: E402
                                   RandomVariableTorch,
                                   RandomVariableTorchFactory)
from finmath_tpu_torch.ops import lazy as lz  # noqa: E402
from finmath_tpu_torch.ops.aad import RandomVariableDifferentiable  # noqa: E402
from finmath_tpu_torch.ops.lazy import (LazyArray,  # noqa: E402
                                        RandomVariableTorchLazy,
                                        RandomVariableTorchLazyFactory,
                                        averages, flush, program_cache_size)

CPU, N = "cpu", 10_000


def _bits(rv):
    return np.asarray(rv.get_realizations(), np.float32).view(np.int32)


def _bits_equal(a, b):
    return np.array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).uniform(0.5, 2.0, N).astype(np.float32)


@pytest.fixture()
def pair(x):
    return (RandomVariableTorchLazy(0.0, x, device=CPU),
            RandomVariableTorch(0.0, x, device=CPU))


def _bench_chain(v):
    """bench.py:862 bench_eager_ops' chain (BASELINE configuration 1)."""
    y = v.mult(1.01).add(0.02).exp().log().discount(v, 0.5)
    return y.add_product(v, v).cap(3.0).floor(0.1).sqrt()


# (id, chain, relative bound against the JAX package's lazy chain)
CHAINS = [
    ("arithmetic", lambda v: (v.mult(2.0).add(0.3).sub(v).div(v.add(3.0))
                              .floor(0.01).cap(5.0).abs().squared()), 2.5e-7),
    ("transcendental", lambda v: v.exp().log().sqrt().pow(1.3).mult(v), 1e-6),
    ("fused_financial", lambda v: (
        v.accrue(v.mult(0.1), 0.5).discount(v.mult(0.1), 0.5)
        .add_product(v, 0.3).add_ratio(v, v.add(2.0))
        .sub_ratio(v, v.add(3.0))), 2.5e-7),
    ("choose", lambda v: v.sub(1.2).choose(v.mult(2.0), v.mult(-1.0)), 2.5e-7),
    ("scalar_division", lambda v: v.div(2.71828).vid(3.5).bus(0.25)
     .invert().mult(7.0), 5e-7),
    ("scalar_fused", lambda v: v.accrue(v, 0.25).discount(0.03, 0.5)
     .add_product(v, 2.0), 2.5e-7),
    ("trig_nan", lambda v: v.sin().add(v.cos()).mult(v.is_nan().add(1.0))
     .add(v.sub(1.0).ge_zero()), 2.5e-7),
    ("bench_eager_ops", _bench_chain, 5e-7),
]


@pytest.mark.parametrize("name,chain,bound", CHAINS, ids=[c[0] for c in CHAINS])
def test_chain_equals_eager_bitwise_and_jax(pair, x, name, chain, bound):
    lazy, strict = pair
    out = chain(lazy)
    assert isinstance(out, RandomVariableTorchLazy)
    assert isinstance(out._values, LazyArray)
    assert _bits_equal(out, chain(strict))
    from finmath_tpu.ops.lazy import RandomVariableTPULazy
    want = chain(RandomVariableTPULazy(0.0, x)).get_realizations()
    np.testing.assert_allclose(out.get_realizations(), np.asarray(want),
                               rtol=bound, atol=0)


def test_ops_are_recorded_not_dispatched(pair):
    lazy, _ = pair
    out = lazy.mult(2.0).add(1.0).exp()
    assert isinstance(out._values, LazyArray)
    assert out.size() == N and out.device.type == "cpu"
    assert "pending" in repr(out)
    assert isinstance(out.values, torch.Tensor)   # .values flushes
    assert not isinstance(out._values, LazyArray)


def test_deterministic_fast_path_is_host_math():
    d = RandomVariableTorchLazy(0.0, 3.0).mult(2.0).add(1.0)
    assert d.is_deterministic() and d.double_value() == 7.0


def test_reductions_equal_eager(pair):
    lazy, strict = pair
    a, b = lazy.exp().mult(0.5), strict.exp().mult(0.5)
    assert a.get_average() == b.get_average()
    assert lazy.log().get_min() == strict.log().get_min()
    assert lazy.log().get_max() == strict.log().get_max()
    assert a.get_variance() == b.get_variance()
    assert a.get_quantile(0.25) == b.get_quantile(0.25)
    w_l, w_s = lazy.mult(1e-4), strict.mult(1e-4)
    assert lazy.exp().get_average(w_l) == strict.exp().get_average(w_s)
    half = RandomVariableTorch(0.0, 0.5)
    assert lazy.exp().get_average(half) == strict.exp().get_average(half)
    # reductions of a materialized lazy variable, weighted by a lazy one
    a.cache()
    w_l.cache()
    assert a.get_average(w_l) == b.get_average(w_s)
    assert a.get_variance(w_l) == b.get_variance(w_s)
    assert a.get_quantile(0.5, w_l) == b.get_quantile(0.5, w_s)
    assert a.get_quantile_expectation(0.2, 0.8) == \
        b.get_quantile_expectation(0.2, 0.8)


def test_filtration_time_apply_and_flush_points(pair, x):
    lazy, strict = pair
    a = RandomVariableTorchLazy(1.0, x, device=CPU)
    b = RandomVariableTorchLazy(2.5, x, device=CPU)
    assert a.add(b).get_filtration_time() == 2.5
    got = lazy.apply(lambda u, v: u * v + 1.0, lazy.exp())
    want = strict.apply(lambda u, v: u * v + 1.0, strict.exp())
    assert isinstance(got, RandomVariableTorchLazy) and _bits_equal(got, want)
    assert lazy.mult(2.0).equals(RandomVariableTorch(0.0, x * 2.0, device=CPU))
    c = lazy.add(1.0)
    assert c.get(3) == float(x[3] + np.float32(1.0))
    rv2 = pickle.loads(pickle.dumps(lazy.mult(2.0)))
    assert np.array_equal(np.asarray(rv2.get_realizations()), x * 2.0)
    f = RandomVariableTorchLazyFactory(device=CPU)
    assert isinstance(f.create_random_variable(1.0, x), RandomVariableTorchLazy)
    assert f.createRandomVariable(0.0, 2.0).is_deterministic()


def test_priorities(pair, x):
    lazy, strict = pair
    out = strict.mult(2.0).add(lazy.exp())        # strict defers to lazy
    assert isinstance(out, RandomVariableTorchLazy)
    assert _bits_equal(out, strict.mult(2.0).add(strict.exp()))
    flipped = strict.sub(lazy.exp())              # sub defers as bus
    assert _bits_equal(flipped, strict.sub(strict.exp()))
    oracle = RandomVariableFloat(0.0, x).mult(2.0).add(lazy)
    assert isinstance(oracle, RandomVariableTorchLazy)
    acc = lazy.accrue(lazy.mult(0.1), 0.5)
    assert isinstance(acc._values, LazyArray)
    aad = RandomVariableDifferentiable(RandomVariableTorch(0.0, 2.0))
    assert isinstance(lazy.mult(aad), RandomVariableDifferentiable)
    assert isinstance(aad.mult(lazy), RandomVariableDifferentiable)
    assert lz.TYPE_PRIORITY_LAZY == 25 == lazy.get_type_priority()


def test_program_cache_keyed_by_structure(x):
    def chain(v, k):
        return v.mult(k).add(k).mult(0.05).exp().mult(v).squared()

    chain(RandomVariableTorchLazy(0.0, x, device=CPU), 2.0).get_average()
    n = program_cache_size()
    r2 = chain(RandomVariableTorchLazy(0.0, x, device=CPU), 9.0)
    assert r2.get_average() == chain(
        RandomVariableTorch(0.0, x, device=CPU), 9.0).get_average()
    assert program_cache_size() == n              # new scalars, same program
    chain(RandomVariableTorchLazy(0.0, x, device=CPU), 9.0).add(1.0).cache()
    assert program_cache_size() == n + 1          # another structure
    chain(RandomVariableTorchLazy(0.0, x[:100], device=CPU), 9.0).cache()
    assert program_cache_size() == n + 2          # another leaf shape


def test_multi_root_flush_and_averages_one_program(x):
    lazy = RandomVariableTorchLazy(0.0, x, device=CPU)
    strict = RandomVariableTorch(0.0, x, device=CPU)
    u, v, w = lazy.mult(2.0), lazy.add(1.0), lazy.sub(0.5)
    n = program_cache_size()
    flush(u, v, w)
    assert program_cache_size() == n + 1
    assert not isinstance(u._values, LazyArray)
    assert np.array_equal(v.get_realizations(), x + 1.0)
    chains = [lazy.mult(k).add(1.0).exp() for k in (0.1, 0.2, 0.3)]
    n = program_cache_size()
    got = averages(*chains)
    assert program_cache_size() == n + 1
    assert got == [strict.mult(k).add(1.0).exp().get_average()
                   for k in (0.1, 0.2, 0.3)]
    got2 = averages(strict.exp(), lazy.exp())     # a strict entry falls back
    assert got2[0] == got2[1] == strict.exp().get_average()
    # the bench's 8-chain batch: one program, the eager averages bit for bit
    leaves = [RandomVariableTorchLazy(0.0, x * (1.0 + 0.01 * k), device=CPU)
              for k in range(8)]
    n = program_cache_size()
    got = averages(*[_bench_chain(leaf) for leaf in leaves])
    assert program_cache_size() == n + 1
    assert got == [_bench_chain(RandomVariableTorch(
        0.0, x * (1.0 + 0.01 * k), device=CPU)).get_average() for k in range(8)]


def test_incremental_flush_reuses_prefix(x):
    lazy = RandomVariableTorchLazy(0.0, x, device=CPU)
    a = lazy.mult(2.0).add(1.0)
    a.cache()
    b = a.mult(3.0)
    assert isinstance(b._values, LazyArray)
    assert np.array_equal(b.get_realizations(), (x * 2.0 + 1.0) * 3.0)


def test_eager_lmm_valuation_equals_strict():
    rng = np.random.default_rng(7)
    inc = (rng.standard_normal((10, 4096)) * math.sqrt(0.5)).astype(np.float32)
    fwds, deltas = np.full(10, 0.02), np.full(10, 0.5)
    v_strict = eager_swaption_valuation(RandomVariableTorchFactory(CPU), fwds,
                                        deltas, 0.005, inc, 4, 6, 0.02)
    v_lazy = eager_swaption_valuation(RandomVariableTorchLazyFactory(CPU),
                                      fwds, deltas, 0.005, inc, 4, 6, 0.02)
    assert isinstance(v_lazy._values, LazyArray)
    assert v_lazy.get_average() == v_strict.get_average()
    assert _bits_equal(v_lazy, v_strict)


# ---------------------------------------------------------------------------
# on a card: the flush as a CUDA graph
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flush graph has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("name,chain,bound", CHAINS, ids=[c[0] for c in CHAINS])
def test_cuda_graph_flush_equals_eager_bitwise(x, name, chain, bound):
    _needs_card()
    dev = torch.device("cuda")
    lazy = RandomVariableTorchLazy(0.0, x, device=dev)
    strict = RandomVariableTorch(0.0, x, device=dev)
    captures = lz.GRAPH_COUNTS["captures"]
    replays = lz.GRAPH_COUNTS["replays"]
    assert _bits_equal(chain(lazy), chain(strict))
    assert chain(lazy).get_average() == chain(strict).get_average()
    assert lz.GRAPH_COUNTS["captures"] == captures + 2
    assert lz.GRAPH_COUNTS["replays"] == replays + 2


@pytest.mark.gpu
def test_cuda_graph_scalars_are_inputs_and_averages_one_graph(x):
    _needs_card()
    dev = torch.device("cuda")
    leaves = [RandomVariableTorchLazy(0.0, x * (1.0 + 0.01 * k), device=dev)
              for k in range(8)]
    for leaf in leaves:
        leaf.cache()

    def chain(v, a, b):
        return v.mult(a).add(b).exp().log().discount(v, 0.5).div(a)

    n = program_cache_size()
    got = averages(*[chain(leaf, 1.01, 0.02) for leaf in leaves])
    assert program_cache_size() == n + 1
    captures = lz.GRAPH_COUNTS["captures"]
    got2 = averages(*[chain(leaf, 1.5, -0.1) for leaf in leaves])
    assert program_cache_size() == n + 1
    assert lz.GRAPH_COUNTS["captures"] == captures
    for k, leaf in enumerate(leaves):
        strict = RandomVariableTorch(0.0, leaf.values)
        assert got[k] == chain(strict, 1.01, 0.02).get_average()
        assert got2[k] == chain(strict, 1.5, -0.1).get_average()


@pytest.mark.gpu
def test_cuda_graph_memory_bounded_over_many_structures(monkeypatch):
    """Forty structures (a pow exponent is part of the key) over 1M paths,
    each flushed to its path vector: the graphs share their static inputs
    and at most ``MAX_LIVE_GRAPHS`` (4 here) keep a capture, so device
    memory after forty equals that after eight within one path vector, and
    an evicted structure is captured again, bit-equal to eager."""
    _needs_card()
    monkeypatch.setattr(lz, "MAX_LIVE_GRAPHS", 4)
    dev = torch.device("cuda")
    paths = 1 << 20
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 2.0, paths).astype(np.float32)).to(dev)
    lazy = RandomVariableTorchLazy(0.0, x)

    def run(k):
        out = lazy.pow(1.0 + k / 64.0).add(0.5).mult(lazy)
        out.cache()
        return out

    for k in range(8):
        run(k)
    torch.cuda.synchronize()
    after_8 = torch.cuda.memory_allocated(dev)
    for k in range(8, 40):
        run(k)
    torch.cuda.synchronize()
    assert len(lz._LIVE) <= 4
    assert torch.cuda.memory_allocated(dev) - after_8 <= 4 * paths
    captures = lz.GRAPH_COUNTS["captures"]
    strict = RandomVariableTorch(0.0, x)
    assert _bits_equal(run(0), strict.pow(1.0).add(0.5).mult(strict))
    assert lz.GRAPH_COUNTS["captures"] == captures + 1
