"""The single-swaption LMM pricers (1-factor and stoch-vol): the port's plain
PyTorch versions against the JAX package's Pallas kernels (run under the
TPU interpreter on the CPU) and against both packages' scan engines, on the
same seeded normals; the PRNG entry points against the injected ones on
their own stream; and the CUDA kernels against the plain versions on a
card.

Sizes stay small (the interpreter's cost grows with the kernel's unroll):
8 libors, 4 steps, 250 paths (not a multiple of 128) for the interpreter;
the full-width ATM (80 libors, 1 factor) and benchmark (40 libors, 5
factors) setups at 512 paths for the engines. Tolerances are the JAX
package's own (``tests/test_pallas_kernels.py:212, :294, :385``): rel 2e-5
for the 1-factor price, 5e-5 for the stoch-vol one and for engine against
kernel. Both sides run in float32; the drift's prefix sum runs in another
order (sequential here, Hillis-Steele in the Pallas kernel), and the
engines collect in float64.

The port fixes the sign of each eigen-reduced factor; where the benchmark
setup crosses the packages, the loaded JAX module is given the port's
signs (a patch of the loaded module only), so that both price one model.

The table a kernel block stages is held to the inputs it packs; the
``gpu`` tests hold each launcher to its plain version bit for bit (also on a
cut and on a whole curve at 1,003 paths, a ragged last block); the
pricers sweep the libors that reach the payoff alone, and a
test holds the plain payoffs on those libors to the whole curve's. The
``gpu`` tests need a card and no JAX; on a machine with the card:
``python -m pytest tests/test_torch_swaption_pricers.py -m gpu --noconftest``."""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.ops import _cuda_build  # noqa: E402
from finmath_tpu_torch.ops import _swaption_paths as sp  # noqa: E402
from finmath_tpu_torch.ops import lmm_kernel as k1  # noqa: E402
from finmath_tpu_torch.ops import lmm_stochvol_kernel as ksv  # noqa: E402
from finmath_tpu_torch.ops.kernels import normal_pairs  # noqa: E402

N_LIBORS, STEPS, PATHS, FACTORS = 8, 4, 250, 2
EXERCISE, PERIODS, STRIKE, DT = 2, 5, 0.025, 0.5
BLEND, NU, RHO = 0.7, 0.4, -0.3


def _grid(uniform):
    """Deltas: the uniform grid, or alternating 0.4 / 0.6 (the spot account
    must accrue each period over its own fraction, not dt)."""
    if uniform:
        return np.full(N_LIBORS, DT)
    return np.where(np.arange(N_LIBORS) % 2 == 0, 0.4, 0.6)


def _one_factor_inputs(seed=5):
    rng = np.random.default_rng(seed)
    vol_table = (0.008 + 0.004 * rng.random((STEPS, N_LIBORS))).astype(
        np.float32)
    l0 = 0.02 + 0.002 * np.arange(N_LIBORS)
    z = rng.standard_normal((STEPS, PATHS)).astype(np.float32)
    return z, vol_table, l0


def _stochvol_inputs(seed=17):
    rng = np.random.default_rng(seed)
    vol_table = (0.1 + 0.2 * rng.random((STEPS, N_LIBORS))).astype(np.float32)
    A = rng.standard_normal((N_LIBORS, FACTORS))
    R = (A / np.linalg.norm(A, axis=1, keepdims=True)).astype(np.float32)
    l0 = np.full(N_LIBORS, 0.024)
    z = rng.standard_normal((STEPS * (FACTORS + 1), PATHS)).astype(np.float32)
    return z, vol_table, R, l0


def _interpret(fn, *args):
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    with pltpu.force_tpu_interpret_mode():
        return float(fn(*args))


@pytest.mark.parametrize("uniform", [True, False])
def test_one_factor_plain_matches_pallas_kernel(uniform):
    jk = pytest.importorskip("finmath_tpu.ops.lmm_kernel")
    z, vol_table, l0 = _one_factor_inputs()
    deltas = _grid(uniform)
    ref = _interpret(jk.lmm_swaption_kernel_with_normals, z, N_LIBORS,
                     EXERCISE, PERIODS, vol_table, l0, deltas, DT, STRIKE)
    launches = dict(sp.LAUNCHES)
    got = k1.lmm_swaption_kernel_with_normals(
        torch.from_numpy(z), N_LIBORS, EXERCISE, PERIODS, vol_table, l0,
        deltas, DT, STRIKE)
    assert sp.LAUNCHES == launches              # CPU tensors: plain version
    assert got.dtype == torch.float64 and got.dim() == 0
    assert ref > 0
    assert float(got) == pytest.approx(ref, rel=2e-5)


@pytest.mark.parametrize("uniform", [True, False])
def test_stochvol_plain_matches_pallas_kernel(uniform):
    jk = pytest.importorskip("finmath_tpu.ops.lmm_stochvol_kernel")
    z, vol_table, R, l0 = _stochvol_inputs()
    deltas = _grid(uniform)
    args = (N_LIBORS, FACTORS, EXERCISE, PERIODS, vol_table, R, l0, deltas,
            DT, STRIKE, BLEND, NU, RHO)
    ref = _interpret(jk.lmm_stochvol_swaption_kernel_with_normals, z, *args)
    got = ksv.lmm_stochvol_swaption_kernel_with_normals(torch.from_numpy(z),
                                                        *args)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert ref > 0
    assert float(got) == pytest.approx(ref, rel=5e-5)


# -- the slice as a whole: plain pricer against both engines ---------------

E, M, ENGINE_PATHS = 10, 20, 512


@pytest.fixture
def jax_fixed_signs():
    """The JAX package's factor reduction with the port's column signs."""
    jnp = pytest.importorskip("jax.numpy")
    jcov = pytest.importorskip("finmath_tpu.models.lmm.covariance")
    from finmath_tpu_torch.models.lmm.covariance import FACTOR_SIGNS

    reduce = jcov.factor_reduce

    def fixed(corr, num_factors):
        R = reduce(corr, num_factors)
        signs = jnp.asarray((FACTOR_SIGNS + (1.0,) * num_factors)[:num_factors])
        return R * jnp.where(R[..., :1, :] * signs < 0, -1.0, 1.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcov, "factor_reduce", fixed)
        yield


def _engines(jax_model, torch_model, strike, num_factors, inc):
    """Both packages' engines valuing one swaption on the increments."""
    jmodel = pytest.importorskip("finmath_tpu.models.lmm.model")
    from finmath_tpu_torch.models.lmm import model as tmodel

    je = jmodel.LMMValuationEngine(
        jax_model, [jmodel.SwaptionProduct(E, M, strike, 0.0,
                                           value_unit="VALUE")],
        ENGINE_PATHS, num_factors, 99, scan_mode="segmented", increments=inc)
    te = tmodel.LMMValuationEngine(
        torch_model, [tmodel.SwaptionProduct(E, M, strike, 0.0,
                                             value_unit="VALUE")],
        ENGINE_PATHS, num_factors, device="cpu", increments=inc)
    return je, te


def test_one_factor_slice_matches_engines_on_shared_normals():
    """The ATM setup (80 libors, 1 factor) at its initial parameters, the
    5Y x 10Y ATM swaption; both engines without the numeraire adjustment,
    which the kernel does not apply (tests/test_pallas_kernels.py:146)."""
    jatm = pytest.importorskip("finmath_tpu.models.lmm.atm_calibration")
    jmodel = pytest.importorskip("finmath_tpu.models.lmm.model")
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm.model import LIBORMarketModelTorch

    a = jatm.build_atm_calibration(num_paths=256, num_factors=1)
    ta = build_atm_calibration(num_paths=8, num_factors=1, device="cpu")
    cov = ta.covariance
    p0 = np.asarray(cov.initial_parameters)
    prep = cov.prepare(torch.as_tensor(p0))
    vol_table = (cov.vol_table(prep)
                 * cov.factor_matrix(prep)[:, 0][None, :]).numpy()
    strike = next(p.strike for p in ta.products
                  if p.exercise_index == E and p.num_periods == M)
    z = np.random.default_rng(7).standard_normal(
        (E, ENGINE_PATHS)).astype(np.float32)
    inc = convert.increments_from_normals(z, 1, DT)
    jm, tm = a.model, ta.model
    je, te = _engines(
        jmodel.LIBORMarketModelTPU(jm.libor_td, jm.forward_curve,
                                   jm.discount_curve, jm.covariance,
                                   use_numeraire_adjustment=False),
        LIBORMarketModelTorch(tm.libor_td, tm.forward_curve,
                              tm.discount_curve, tm.covariance,
                              use_numeraire_adjustment=False),
        strike, 1, inc)
    v_jax, v_torch = float(je.values(p0)[0]), float(te.values(p0)[0])
    v_kernel = float(k1.lmm_swaption_kernel_with_normals(
        torch.from_numpy(z), tm.num_libors, E, M, vol_table,
        tm.initial_forwards, tm.deltas, DT, strike))
    assert v_kernel > 0
    assert v_kernel == pytest.approx(v_jax, rel=5e-5)
    assert v_kernel == pytest.approx(v_torch, rel=5e-5)


def test_stochvol_slice_matches_engines_on_shared_normals(jax_fixed_signs):
    """The benchmark setup (40 libors, 5 factors, blended local vol,
    stochastic vol) at its initial parameters, the 5Y x 10Y smile node
    (``TestSameNormalsEngineVsKernel`` at 512 paths)."""
    jbench = pytest.importorskip(
        "finmath_tpu.models.lmm.benchmark_calibration")
    from finmath_tpu_torch.models.lmm import build_benchmark_calibration

    b = jbench.build_benchmark_calibration(num_paths=256)
    tb = build_benchmark_calibration(num_paths=8, device="cpu")
    cov = tb.covariance
    p0 = np.asarray(cov.initial_parameters)
    prep = cov.prepare(torch.as_tensor(p0))
    vol_table = cov.vol_table(prep).numpy()
    R = cov.factor_matrix(prep).numpy()
    nu, rho = (float(x) for x in cov.stoch_vol_params(prep))
    strike = tb.products[4].strike
    F = R.shape[1]
    z = np.random.default_rng(99).standard_normal(
        (E * (F + 1), ENGINE_PATHS)).astype(np.float32)
    inc = convert.increments_from_normals(z, F + 1, DT)
    je, te = _engines(b.model, tb.model, strike, F, inc)
    v_jax, v_torch = float(je.values(p0)[0]), float(te.values(p0)[0])
    v_kernel = float(ksv.lmm_stochvol_swaption_kernel_with_normals(
        torch.from_numpy(z), tb.model.num_libors, F, E, M, vol_table, R,
        tb.model.initial_forwards, tb.model.deltas, DT, strike, float(p0[5]),
        nu, rho))
    assert v_kernel > 0
    assert v_kernel == pytest.approx(v_jax, rel=5e-5)
    assert v_kernel == pytest.approx(v_torch, rel=5e-5)


# -- the PRNG entry points ---------------------------------------------------

def _packed(kind, uniform=True):
    """Packed CPU inputs of one pricer and its normal rows per step."""
    if kind == "one_factor":
        _, vol_table, l0 = _one_factor_inputs()
        return k1.lmm_swaption_inputs(vol_table, l0, _grid(uniform), STEPS,
                                      DT, STRIKE, "cpu"), 1
    _, vol_table, R, l0 = _stochvol_inputs()
    return ksv.lmm_stochvol_swaption_inputs(
        vol_table, R, l0, _grid(uniform), STEPS, DT, STRIKE, BLEND, NU, RHO,
        "cpu"), FACTORS + 1


PRICERS = {
    "one_factor": (k1.lmm_swaption_payoffs, k1.lmm_swaption_payoffs_injected),
    "stochvol": (ksv.lmm_stochvol_swaption_payoffs,
                 ksv.lmm_stochvol_swaption_payoffs_injected),
}
SWAP = dict(exercise=EXERCISE, periods=PERIODS)


@pytest.mark.parametrize("kind", sorted(PRICERS))
def test_prng_pricer_equals_injected_pricer_on_its_stream(kind):
    (volT, l0, deltas, scal), k = _packed(kind, uniform=False)
    prng, injected = PRICERS[kind]
    rows = STEPS * k
    z = normal_pairs(2024, PATHS, -(-rows // 4))[:rows].contiguous()
    got = prng(2024, PATHS, volT, l0, deltas, scal, **SWAP)
    ref = injected(z, volT, l0, deltas, scal, **SWAP)
    assert got.dtype == torch.float32 and tuple(got.shape) == (PATHS,)
    assert bool(torch.isfinite(got).all()) and float(got.max()) > 0
    assert torch.equal(got, ref)
    assert torch.equal(got, prng(2024, PATHS, volT, l0, deltas, scal, **SWAP))
    assert not torch.equal(got, prng(2025, PATHS, volT, l0, deltas, scal,
                                     **SWAP))


def test_prng_entry_points_take_the_jax_signatures():
    z, vol_table, l0 = _one_factor_inputs()
    deltas = _grid(True)
    v = k1.lmm_swaption_kernel(7, PATHS, N_LIBORS, EXERCISE, PERIODS, STEPS,
                               vol_table, l0, deltas, DT, STRIKE,
                               device="cpu")
    (volT, l0_t, d_t, scal), _ = _packed("one_factor")
    pay = k1.lmm_swaption_paths_reference(7, PATHS, volT, l0_t, d_t, scal,
                                          **SWAP)
    assert v.dtype == torch.float64 and v.dim() == 0
    assert float(v) == float(pay.double().sum()) / PATHS
    _, vt2, R, l02 = _stochvol_inputs()
    v2 = ksv.lmm_stochvol_swaption_kernel(
        7, PATHS, N_LIBORS, FACTORS, EXERCISE, PERIODS, STEPS, vt2, R, l02,
        deltas, DT, STRIKE, BLEND, NU, RHO, device="cpu")
    assert v2.dtype == torch.float64 and float(v2) > 0
    # the scalars as the JAX wrappers pack them: sqrt(dt) in float64 for
    # one factor (lmm_kernel.py:136), in float32 for stoch vol (:131)
    assert float(scal[1]) == float(np.float32(np.sqrt(DT)))
    (_, _, _, scal_sv), _ = _packed("stochvol")
    assert float(scal_sv[1]) == float(np.sqrt(np.float32(DT)))
    assert float(scal_sv[6]) == float(np.sqrt(np.float32(1.0)
                                              - np.float32(RHO) ** 2))


def test_entry_points_check_their_inputs(monkeypatch):
    z, vol_table, R, l0 = _stochvol_inputs()
    deltas = _grid(True)
    with pytest.raises(ValueError, match=r"num_steps \* \(num_factors\+1\)"):
        ksv.lmm_stochvol_swaption_kernel_with_normals(
            torch.from_numpy(z[:-1]), N_LIBORS, FACTORS, EXERCISE, PERIODS,
            vol_table, R, l0, deltas, DT, STRIKE, BLEND, NU, RHO)
    (volT, l0_t, d_t, scal), _ = _packed("one_factor")
    with pytest.raises(ValueError):                 # beyond the curve
        k1.lmm_swaption_payoffs(1, PATHS, volT, l0_t, d_t, scal, exercise=4,
                                periods=5)
    with pytest.raises(ValueError):                 # float64 normals
        k1.lmm_swaption_payoffs_injected(
            torch.zeros((STEPS, PATHS), dtype=torch.float64), volT, l0_t, d_t,
            scal, **SWAP)
    with pytest.raises(ValueError):                 # negative seed
        k1.lmm_swaption_payoffs(-1, PATHS, volT, l0_t, d_t, scal, **SWAP)
    if not torch.cuda.is_available():
        # no device given and no card: no quiet fallback to the CPU
        monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
        _, vt1, l01 = _one_factor_inputs()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            k1.lmm_swaption_kernel(7, PATHS, N_LIBORS, EXERCISE, PERIODS,
                                   STEPS, vt1, l01, deltas, DT, STRIKE)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ksv.lmm_stochvol_swaption_kernel(
                7, PATHS, N_LIBORS, FACTORS, EXERCISE, PERIODS, STEPS,
                vol_table, R, l0, deltas, DT, STRIKE, BLEND, NU, RHO)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            k1.lmm_swaption_kernel_with_normals(
                np.zeros((STEPS, PATHS), np.float32), N_LIBORS, EXERCISE,
                PERIODS, vt1, l01, deltas, DT, STRIKE)


def test_increments_from_normals():
    z = np.random.default_rng(3).standard_normal((12, 5)).astype(np.float32)
    inc = convert.increments_from_normals(z, 3, DT)
    assert inc.dtype == np.float32 and inc.shape == (4, 3, 5)
    np.testing.assert_array_equal(
        inc, z.reshape(4, 3, 5) * np.float32(np.sqrt(DT)))
    t = convert.increments_from_normals(torch.from_numpy(z), 3, DT)
    assert t.dtype == torch.float32 and tuple(t.shape) == (4, 3, 5)
    np.testing.assert_array_equal(t.numpy(), inc)
    with pytest.raises(ValueError):
        convert.increments_from_normals(z, 5, DT)


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A source's library is named by a hash that covers every header in
    ``csrc/``: an edited header builds anew instead of reusing a stale
    library (on a copy of ``csrc``)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "_build")
    before = {src: _cuda_build.library_path(src)
              for src in ("mc_paths.cu", "lmm_swaption_paths.cu")}
    header = csrc / "philox.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {src: _cuda_build.library_path(src) for src in before}
    for src in before:
        assert before[src] != after[src]
        assert before[src].parent == tmp_path / "_build"
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _cuda_build.library_path("mc_paths.cu") != after["mc_paths.cu"]


# -- the kernels' instantiations and staged tables ---------------------------

def test_pricer_variant():
    """The 1-factor kernels: one instantiation a model (libors, factors);
    the stoch-vol ones: a curve of the swept libors rounded up to 8, at
    most the model's; a launch sweeps the libors up to the swap's end and
    the last step's fixing; the kernels refuse more than 128 libors or 8
    factors."""
    assert sp.pricer_variant(80, 1) == (80, 1)
    assert sp.pricer_variant(40, 5, 30) == (32, 5)
    assert sp.pricer_variant(40, 5, 21) == (24, 5)
    assert sp.pricer_variant(40, 5, 40) == (40, 5)
    assert sp.pricer_variant(37, 3, 37) == (37, 3)
    assert sp.pricer_variant(40, 1, 16) == (16, 1)
    assert sp.pricer_defines(40, 5) == (("LMM_K", 40), ("LMM_F", 5))
    assert sp.swept_libors(10, 10, 20) == 30          # the main path
    assert sp.swept_libors(1, 1, 20) == 21
    assert sp.swept_libors(35, 10, 20) == 35          # steps past the swap
    sp.check_kernel_shape(128, 8)
    for n, F in ((129, 1), (40, 9), (40, 0)):
        with pytest.raises(ValueError):
            sp.check_kernel_shape(n, F)


@pytest.mark.parametrize("kind,n,F,e,m", [("one_factor", 8, 1, 2, 4),
                                          ("one_factor", 37, 1, 6, 20),
                                          ("stochvol", 13, 3, 3, 5),
                                          ("stochvol", 40, 5, 10, 20)])
def test_pricer_table_packing(kind, n, F, e, m):
    """The table a block stages: per libor (L0, delta) or (L0, delta,
    blend L0, 0), the libors padded to a multiple of 4, the loadings
    step-major [S][C][NP][V] with F padded to 1, 2, 4 or 8, padding zero;
    16-byte aligned, a whole number of 16-byte chunks; the values read back
    equal the pricer's inputs, and the scalars and the swept libors go as
    launch arguments."""
    from finmath_tpu_torch.ops._products import loading_layout

    rng = np.random.default_rng(n + F)
    S_ = 6
    l0 = 0.02 + 0.002 * np.sin(np.arange(n))
    deltas = np.where(np.arange(n) % 2 == 0, 0.4, 0.6)
    vol_table = (0.01 + 0.2 * rng.random((S_, n))).astype(np.float32)
    if kind == "one_factor":
        volT, l0_t, d_t, scal = k1.lmm_swaption_inputs(
            vol_table, l0, deltas, S_, DT, STRIKE, "cpu")
        launch = k1.lmm_swaption_packed(volT, l0_t, d_t, scal, exercise=e,
                                       periods=m)
        Q = 2
    else:
        A = rng.standard_normal((n, F))
        R = (A / np.linalg.norm(A, axis=1, keepdims=True)).astype(np.float32)
        volT, l0_t, d_t, scal = ksv.lmm_stochvol_swaption_inputs(
            vol_table, R, l0, deltas, S_, DT, STRIKE, BLEND, NU, RHO, "cpu")
        launch = ksv.lmm_stochvol_swaption_packed(volT, l0_t, d_t, scal,
                                                 exercise=e, periods=m)
        Q = 4
    swept = max(e + m, S_)
    K = n if Q == 2 else min(n, -(-swept // 8) * 8)   # the curve's libors
    table = launch.table
    assert launch.variant == ((K, F) if Q == 2
                              else sp.pricer_variant(n, F, swept))
    assert launch.ints == ((K, swept, S_, e, m) if Q == 2
                           else (K, F, swept, S_, e, m))
    assert launch.scalars == tuple(float(v) for v in
                                   scal[:3 if Q == 2 else 7].tolist())
    NP = -(-K // 4) * 4
    C, V = loading_layout(F)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert tuple(table.shape) == (Q * NP + S_ * C * NP * V,)
    assert table.shape[0] % 4 == 0 and table.data_ptr() % 16 == 0
    cols = table[:Q * NP].view(NP, Q)
    assert torch.equal(cols[:K, 0], l0_t[:K])
    assert torch.equal(cols[:K, 1], d_t[:K]) and not cols[K:].any()
    if Q == 4:
        assert torch.equal(cols[:K, 2], scal[3] * l0_t[:K])
        assert not cols[:, 3].any()
    tab = table[Q * NP:].view(S_, C, NP, V)
    vol = volT.view(F, n, S_)
    for f in range(F):
        assert torch.equal(tab[:, f // V, :K, f % V], vol[f, :K].T)
    loadings = tab.permute(0, 2, 1, 3).reshape(S_, NP, C * V)
    assert not loadings[..., F:].any() and not loadings[:, K:].any()


@pytest.mark.parametrize("kind", sorted(PRICERS))
def test_swept_libors_give_the_same_payoffs(kind):
    """The libors above the swap's end and the last fixing reach neither
    the numeraire nor the payoff: the plain pricer on the swept libors
    alone gives every path's payoff bit for bit."""
    (volT, l0, deltas, scal), k = _packed(kind, uniform=False)
    swap = dict(exercise=1, periods=3)
    K = sp.swept_libors(STEPS, **swap)
    assert K < N_LIBORS
    F = volT.shape[0] // N_LIBORS
    cut = (volT.view(F, N_LIBORS, STEPS)[:, :K].reshape(F * K, STEPS),
           l0[:K], deltas[:K], scal)
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (STEPS * k, PATHS)).astype(np.float32))
    injected = PRICERS[kind][1]
    full = injected(z, volT, l0, deltas, scal, **swap)
    assert bool(torch.isfinite(full).all()) and float(full.max()) > 0
    assert torch.equal(injected(z, *cut, **swap), full)


# -- the CUDA kernels on a card ------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(PRICERS))
def test_cuda_kernels_match_plain_versions(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    (volT, l0, deltas, scal), k = _packed(kind, uniform=False)
    volT, l0, deltas = (t.cuda() for t in (volT, l0, deltas))
    prng, injected = PRICERS[kind]
    plain_prng = {"one_factor": k1.lmm_swaption_paths_reference,
                  "stochvol": ksv.lmm_stochvol_swaption_paths_reference}[kind]
    plain_injected = {
        "one_factor": k1.lmm_swaption_payoffs_with_normals,
        "stochvol": ksv.lmm_stochvol_swaption_payoffs_with_normals}[kind]
    rows = STEPS * k
    z = normal_pairs(11, PATHS, -(-rows // 4), "cuda")[:rows].contiguous()
    launches = dict(sp.LAUNCHES)
    got = prng(11, PATHS, volT, l0, deltas, scal, **SWAP)
    got_z = injected(z, volT, l0, deltas, scal, **SWAP)
    torch.cuda.synchronize()
    assert sum(sp.LAUNCHES.values()) == sum(launches.values()) + 2
    assert torch.equal(got, got_z)
    assert torch.equal(got, plain_prng(11, PATHS, volT, l0, deltas, scal,
                                       **SWAP))
    assert torch.equal(got_z, plain_injected(z, volT, l0, deltas, scal,
                                             **SWAP))


@pytest.mark.gpu
@pytest.mark.parametrize("exercise", [6, 17])
@pytest.mark.parametrize("kind", sorted(PRICERS))
def test_cuda_kernels_equal_plain_versions_on_a_cut_curve(kind, exercise):
    """At 37 libors, 1,003 paths (a ragged last block) and 6 steps, a
    20-period swap from libor 6 (26 libors swept, the curve cut) or from
    libor 17 (ending on the last libor, every libor swept): each of the
    two launchers of the kind equals its plain version bit for bit, and
    the PRNG launch the injected one on its own stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    n, paths, steps, F = 37, 1003, 6, 3
    swap = dict(exercise=exercise, periods=20)
    rng = np.random.default_rng(37)
    l0 = 0.02 + 0.002 * np.sin(np.arange(n))
    deltas = np.where(np.arange(n) % 2 == 0, 0.4, 0.6)
    if kind == "one_factor":
        vol_table = (0.008 + 0.004 * rng.random((steps, n))).astype(
            np.float32)
        args = k1.lmm_swaption_inputs(vol_table, l0, deltas, steps, DT,
                                      STRIKE, "cuda")
        rows = steps
        plain_prng = k1.lmm_swaption_paths_reference
        plain_injected = k1.lmm_swaption_payoffs_with_normals
    else:
        vol_table = (0.1 + 0.2 * rng.random((steps, n))).astype(np.float32)
        A = rng.standard_normal((n, F))
        R = (A / np.linalg.norm(A, axis=1, keepdims=True)).astype(np.float32)
        args = ksv.lmm_stochvol_swaption_inputs(
            vol_table, R, l0, deltas, steps, DT, STRIKE, BLEND, NU, RHO,
            "cuda")
        rows = steps * (F + 1)
        plain_prng = ksv.lmm_stochvol_swaption_paths_reference
        plain_injected = ksv.lmm_stochvol_swaption_payoffs_with_normals
    prng, injected = PRICERS[kind]
    z = normal_pairs(5, paths, -(-rows // 4), "cuda")[:rows].contiguous()
    got = prng(5, paths, *args, **swap)
    got_z = injected(z, *args, **swap)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and float(got.max()) > 0
    assert torch.equal(got, got_z)
    assert torch.equal(got, plain_prng(5, paths, *args, **swap))
    assert torch.equal(got_z, plain_injected(z, *args, **swap))
