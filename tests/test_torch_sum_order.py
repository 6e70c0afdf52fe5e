"""The order of float32 additions that the two LMM products kernels use and
their plain versions repeat (``finmath_tpu_torch/ops/_products.py``,
``csrc/lmm_sweep.cuh``): one thread a path, every running sum over the
libors taken one addition after another from 0, the bond product and
annuity one period after another.

``ordered_running_sums`` and ``ordered_bond_prefix`` below take that order
one addition at a time in NumPy float32 (vectorised only over independent
columns). The tests here hold the plain versions' helpers to them, and to
NumPy's float32 ``cumsum``, bit for bit on random inputs; ``recording`` and
``assert_kernel_order`` let the kernel test files do the same for every
running sum of a whole plain sweep. The packing tests hold the parameter
table a kernel block stages to the layout the kernels read. The partials
tests hold ``_products.tile_partials`` to the kernels' float64 path
reduction (a warp's ``__shfl_down_sync`` tree, then the warps of a tile
one after another), emulated lane by lane in NumPy."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.ops import _cuda_build, _products  # noqa: E402


def ordered_running_sums(c, first):
    """``c`` float32 ``[n, columns]``: the inclusive running sums along
    axis 0 from row ``first`` on, one addition at a time; rows before
    ``first`` left 0."""
    out = np.zeros_like(c)
    acc = np.zeros(c.shape[1], np.float32)
    for i in range(first, c.shape[0]):
        acc = acc + c[i]
        out[i] = acc
    return out


def ordered_bond_prefix(L, d, first, last):
    """The running bond product and annuity of the curve ``L`` float32
    ``[n, columns]`` with period lengths ``d`` ``[n, 1]``, one period after
    another from ``first``, at the periods ``first .. last`` (1 and 0
    elsewhere)."""
    one = np.float32(1.0)
    out_c, out_a = np.ones_like(L), np.zeros_like(L)
    cp = np.ones(L.shape[1], np.float32)
    ann = np.zeros(L.shape[1], np.float32)
    for i in range(first, last + 1):
        cp = cp * (one / (one + d[i] * L[i]))
        ann = ann + cp * d[i]
        out_c[i], out_a[i] = cp, ann
    return out_c, out_a


def _columns(t):
    """``[..., libors, paths]`` -> float32 ``[libors, columns]``."""
    x = np.moveaxis(np.asarray(t.detach().cpu().numpy(), np.float32), -2, 0)
    return np.ascontiguousarray(x.reshape(x.shape[0], -1))


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


@contextlib.contextmanager
def recording(module):
    """Record every call of ``module``'s two ordered-sum helpers as
    ``(kind, inputs, output)``."""
    calls = []
    sums, bonds = module.running_sums, module.bond_prefix

    def rec_sums(c, first=0):
        out = sums(c, first)
        calls.append(("sums", (c, first), out))
        return out

    def rec_bonds(L, d, first, last):
        out = bonds(L, d, first, last)
        calls.append(("bonds", (L, d, first, last), out))
        return out

    module.running_sums, module.bond_prefix = rec_sums, rec_bonds
    try:
        yield calls
    finally:
        module.running_sums, module.bond_prefix = sums, bonds


@contextlib.contextmanager
def cumsum_order(module):
    """Within the block ``module``'s plain version takes its running sums
    with ``torch.cumsum`` and ``torch.cumprod``, as the plain versions did
    before they followed the kernels' order (on the CPU those accumulate
    float32 in float64)."""
    sums, bonds = module.running_sums, module.bond_prefix

    def cum_sums(c, first=0):
        out = torch.zeros_like(c)
        out[..., first:, :] = torch.cumsum(c[..., first:, :], dim=-2)
        return out

    def cum_bonds(L, d, first, last):
        span = slice(first, last + 1)
        dd = d[..., span, :]
        cp = torch.cumprod(1.0 / (1.0 + dd * L[..., span, :]), dim=-2)
        out_c, out_a = torch.ones_like(L), torch.zeros_like(L)
        out_c[..., span, :] = cp
        out_a[..., span, :] = torch.cumsum(cp * dd, dim=-2)
        return out_c, out_a

    module.running_sums, module.bond_prefix = cum_sums, cum_bonds
    try:
        yield
    finally:
        module.running_sums, module.bond_prefix = sums, bonds


def assert_kernel_order(calls):
    """Every recorded running sum equals the one-addition-at-a-time sum in
    the kernels' order, bit for bit."""
    assert {kind for kind, _, _ in calls} == {"sums", "bonds"}
    for kind, inputs, out in calls:
        if kind == "sums":
            c, first = inputs
            assert _bits_equal(_columns(out),
                               ordered_running_sums(_columns(c), first))
        else:
            L, d, first, last = inputs
            dd = d.reshape(-1, L.shape[-2], 1)[0].numpy()      # [n, 1]
            want = ordered_bond_prefix(_columns(L), dd, first, last)
            for got, ref in zip(out, want):
                assert _bits_equal(_columns(got)[first:last + 1],
                                   ref[first:last + 1])


@pytest.mark.parametrize("n,first", [(5, 0), (13, 1), (37, 9), (80, 79)])
def test_running_sums_bitwise(n, first):
    """``running_sums`` is the one-addition-at-a-time float32 sum, which
    NumPy's float32 ``cumsum`` also is; dead libors before ``first`` give
    0."""
    rng = np.random.default_rng(n)
    c = rng.standard_normal((2, n, 9)).astype(np.float32)
    got = _products.running_sums(torch.from_numpy(c), first)
    want = ordered_running_sums(_columns(torch.from_numpy(c)), first)
    assert _bits_equal(_columns(got), want)
    assert _bits_equal(got.numpy()[:, first:],
                       np.cumsum(c[:, first:], axis=1, dtype=np.float32))
    assert not got.numpy()[:, :first].any()


@pytest.mark.parametrize("n,first,last", [(8, 0, 7), (13, 3, 9),
                                          (40, 1, 39), (80, 20, 77)])
def test_bond_prefix_bitwise(n, first, last):
    """``bond_prefix`` is the period-by-period float32 product and annuity;
    outside ``first .. last`` it is the identity."""
    rng = np.random.default_rng(10 + n)
    L = (0.02 + 0.01 * rng.standard_normal((3, n, 7))).astype(np.float32)
    d = np.full((n, 1), 0.5, np.float32)
    pc, pa = _products.bond_prefix(torch.from_numpy(L), torch.from_numpy(d),
                                   first, last)
    want_c, want_a = ordered_bond_prefix(_columns(torch.from_numpy(L)), d,
                                         first, last)
    span = slice(first, last + 1)
    assert _bits_equal(_columns(pc)[span], want_c[span])
    assert _bits_equal(_columns(pa)[span], want_a[span])
    outside = np.r_[0:first, last + 1:n]
    assert np.all(pc.numpy()[:, outside] == 1.0)
    assert not pa.numpy()[:, outside].any()
    # the bond product of the span, in float64, within float32 rounding
    np.testing.assert_allclose(
        pc.numpy()[:, last],
        np.prod(1.0 / (1.0 + 0.5 * L[:, span].astype(np.float64)), axis=1),
        rtol=1e-5)


@pytest.mark.parametrize("F", [1, 2, 3, 5, 8])
def test_packed_parameter_sets(F):
    """The packed sets hold the scalars, the per-libor columns and the
    loadings step-major with F padded to 1, 2, 4 or 8, the libors padded to
    a multiple of 4, padding zero; every set is whole 16-byte chunks."""
    rng = np.random.default_rng(3 + F)
    B, n, S = 2, 11, 4
    volT = torch.from_numpy(rng.random((B, F * n, S)).astype(np.float32))
    scal = torch.from_numpy(rng.random((B, 8)).astype(np.float32))
    col = torch.arange(1, n + 1, dtype=torch.float32)
    packed = _products.pack_parameter_sets(volT, scal, (col, 2 * col),
                                           num_factors=F)
    NP = _products.padded_libors(n)
    C, V = _products.loading_layout(F)
    fp = {1: 1, 2: 2, 3: 4, 5: 8, 8: 8}[F]
    assert NP == 12 and C * V == fp and V == min(fp, 4)
    assert packed.shape == (B, 8 + 2 * NP + S * C * NP * V)
    assert packed.shape[1] % 4 == 0 and packed.is_contiguous()
    assert torch.equal(packed[:, :8], scal)
    cols = packed[:, 8:8 + 2 * NP].view(B, NP, 2)
    assert torch.equal(cols[0, :n, 0], col)
    assert torch.equal(cols[1, :n, 1], 2 * col) and not cols[:, n:].any()
    tab = packed[:, 8 + 2 * NP:].view(B, S, C, NP, V)
    vol = volT.view(B, F, n, S)
    for f in range(F):
        assert torch.equal(tab[:, :, f // V, :n, f % V],
                           vol[:, f].transpose(1, 2))
    loadings = tab.permute(0, 1, 3, 2, 4).reshape(B, S, NP, C * V)
    assert not loadings[..., F:].any() and not loadings[:, :, n:].any()


def test_sweep_variant():
    """One instantiation for each (libors, factors): K = n libors in
    registers, chunks of 8 rows at one factor and 4 above."""
    assert _products.sweep_variant(80, 1) == (80, 1, 8)
    assert _products.sweep_variant(40, 5) == (40, 5, 4)
    assert _products.sweep_variant(37, 2) == (37, 2, 4)
    assert _products.sweep_defines(40, 5, 4) == (
        ("LMM_K", 40), ("LMM_F", 5), ("LMM_R", 4))
    assert _products.MAX_LIBORS == 128 and _products.THREADS == 256


def emulated_tile_partials(values):
    """The products kernels' reduction of ``values`` float64 ``[B, R,
    paths]``, lane by lane: each warp's ``__shfl_down_sync`` tree (lane
    ``i`` adds lane ``i + offset``, a lane past 31 reading its own value),
    lane 0's sum per warp, then ``acc = warp 0; acc += warp 1 .. 7`` per
    tile; paths past the end are 0.0. Returns ``[B, tiles, R]``."""
    B, R, paths = values.shape
    threads, warp = _products.THREADS, 32
    tiles = -(-paths // threads)
    v = np.zeros((B, R, tiles * threads))
    v[..., :paths] = values
    out = np.zeros((B, tiles, R))
    for t in range(tiles):
        acc = None
        for w in range(threads // warp):
            lanes = v[..., t * threads + w * warp:
                      t * threads + (w + 1) * warp].copy()
            for off in (16, 8, 4, 2, 1):
                other = lanes.copy()
                other[..., :warp - off] = lanes[..., off:]
                lanes = lanes + other
            acc = lanes[..., 0] if acc is None else acc + lanes[..., 0]
        out[:, t] = acc
    return out


@pytest.mark.parametrize("paths", [1, 255, 256, 600])
def test_tile_partials_follow_kernel_order(paths):
    """``tile_partials`` is the kernels' reduction bit for bit; its tiles
    sum to the float64 path sum within 1e-12 relative, and the tail past
    the last path adds nothing."""
    rng = np.random.default_rng(paths)
    values = rng.standard_normal((2, 3, paths)) * 10.0 ** rng.integers(
        -3, 4, (2, 3, paths))
    got = _products.tile_partials(torch.from_numpy(values))
    tiles = -(-paths // _products.THREADS)
    assert got.dtype == torch.float64 and tuple(got.shape) == (2, tiles, 3)
    want = emulated_tile_partials(values)
    assert np.array_equal(got.numpy().view(np.uint64), want.view(np.uint64))
    np.testing.assert_allclose(got.numpy().sum(axis=1), values.sum(axis=-1),
                               rtol=1e-12, atol=1e-12 * np.abs(values).sum())
    padded = np.concatenate([values, np.zeros((2, 3, 7))], axis=-1)
    assert torch.equal(_products.tile_partials(torch.from_numpy(padded))[
        :, :tiles], got)


def test_products_build_without_contraction():
    """The two products sources build with ``-fmad=false``, which names
    another library than the same source without it; the path and pricer
    sources keep the default flags (they round explicitly)."""
    from finmath_tpu_torch.ops import (_swaption_paths, kernels, lmm_kernel,
                                       lmm_stochvol_kernel)

    assert _products.SWEEP_FLAGS == ("-fmad=false",)
    assert lmm_kernel.FLAGS == lmm_stochvol_kernel.FLAGS == \
        _products.SWEEP_FLAGS
    assert kernels.FLAGS == _swaption_paths.FLAGS == ()
    defines = _products.sweep_defines(80, 1, 8)
    plain = _cuda_build.library_path(lmm_kernel.SOURCE, defines)
    no_fma = _cuda_build.library_path(lmm_kernel.SOURCE, defines,
                                      lmm_kernel.FLAGS)
    assert plain != no_fma and plain.parent == no_fma.parent
    assert no_fma == _cuda_build.library_path(lmm_kernel.SOURCE, defines,
                                              ("-fmad=false",))
