"""The stoch-vol path sweep: the port's plain PyTorch version against the
JAX package's Pallas kernel (run under the TPU interpreter on the CPU), on
the same seeded normals, and the CUDA kernel against the plain version on a
card.

Kept small because the interpreter's cost grows superlinearly with the
kernel's unroll (tests/test_kernel_backend.py:8-15): 8 libors, 2 factors,
4 steps, 250 paths (not a multiple of 128, so the padded tail must
contribute nothing), products over three exercise steps, B = 3 parameter
sets from benign to a curated-basin-like (blend 1.4, nu -1.4, rho -0.76).
The Pallas kernel returns per-path values; they are reduced here as its
caller reduces them (non-finite values dropped, float64 sum). Tolerance
on every row's path sum: rtol 1e-5, atol 1e-7 * paths — both sides
simulate in float32, but the spot drift's prefix sum runs in another order
(sequential here, Hillis-Steele there).

The ``gpu`` tests need a card and no JAX; on a machine with the card:
``python -m pytest tests/test_torch_stochvol_kernel.py -m gpu --noconftest``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.ops import lmm_stochvol_kernel as svk  # noqa: E402

N_LIBORS, FACTORS, PATHS, B, S = 8, 2, 250, 3, 4
PRODUCTS = ((2, 4, 0.021), (3, 3, 0.0205), (4, 2, 0.025), (4, 4, 0.018))
RTOL, ATOL = 1e-5, 1e-7 * PATHS
# (blend, nu, rho) per parameter set
STOCH_VOL = ((0.2, 0.3, 0.2), (0.6, 0.8, -0.4), (1.4, -1.4, -0.76))


def _inputs(seed=31):
    """Seeded NumPy inputs in the kernel's layout (standard normals)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((S * (FACTORS + 1), PATHS)).astype(np.float32)
    volT = (0.1 + 0.2 * rng.random((B, FACTORS * N_LIBORS, S))).astype(
        np.float32)
    scal = np.zeros((B, 8), np.float32)
    for b, (blend, nu, rho) in enumerate(STOCH_VOL):
        scal[b, :6] = (0.5, np.sqrt(0.5), blend, nu, rho,
                       np.sqrt(max(1.0 - rho * rho, 1e-12)))
    l0 = (0.02 + 0.002 * np.arange(N_LIBORS)).astype(np.float32)
    deltas = np.full(N_LIBORS, 0.5, np.float32)
    return z, volT, scal, l0, deltas


KW = dict(num_libors=N_LIBORS, num_factors=FACTORS, products=PRODUCTS,
          num_paths=PATHS)


def _jax_sums(z, volT, scal, l0, deltas):
    jax_kernel = pytest.importorskip("finmath_tpu.ops.lmm_stochvol_kernel")
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    tiles = -(-PATHS // 128)
    zt = np.zeros((S * (FACTORS + 1), tiles * 128), np.float32)
    zt[:, :PATHS] = z
    zt = zt.reshape(S * (FACTORS + 1), tiles, 128).transpose(1, 0, 2)
    with pltpu.force_tpu_interpret_mode():
        out = jax_kernel.lmm_stochvol_swaptions_batch(
            zt, volT, scal, l0, deltas, num_libors=N_LIBORS,
            num_factors=FACTORS, products=PRODUCTS)
    out = np.asarray(out)                          # [B, tiles, p_pad, 128]
    per_path = out.transpose(0, 2, 1, 3).reshape(B, out.shape[2], -1)
    per_path = per_path[:, :len(PRODUCTS), :PATHS]
    return np.where(np.isfinite(per_path), per_path, 0.0).astype(
        np.float64).sum(axis=-1)


def test_plain_version_matches_pallas_kernel():
    inputs = _inputs()
    ref = _jax_sums(*inputs)
    launches = svk.LAUNCHES
    got = svk.lmm_stochvol_swaptions_batch(
        *(torch.from_numpy(a) for a in inputs), **KW)
    assert svk.LAUNCHES == launches            # CPU tensors: plain version
    assert got.dtype == torch.float64
    assert tuple(got.shape) == (B, len(PRODUCTS))
    assert np.all(np.isfinite(ref)) and np.all(ref > 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_pad_paths_contribute_nothing_and_nonfinite_paths_drop():
    z, volT, scal, l0, deltas = _inputs()
    args = [torch.from_numpy(a) for a in (volT, scal, l0, deltas)]
    full = svk.lmm_stochvol_swaptions_batch_reference(
        torch.from_numpy(z), *args, **KW)
    wide = np.concatenate([z, 50.0 * np.ones((z.shape[0], 6), np.float32)],
                          axis=1)
    cut = svk.lmm_stochvol_swaptions_batch_reference(
        torch.from_numpy(wide), *args, **KW)
    np.testing.assert_array_equal(full.numpy(), cut.numpy())
    # a path driven to NaN contributes 0, the others are unchanged
    bad = z.copy()
    bad[0, 7] = np.nan
    out = svk.lmm_stochvol_swaptions_batch_reference(
        torch.from_numpy(bad), *args, **KW).numpy()
    assert np.all(np.isfinite(out))
    keep = np.ones(PATHS, bool)
    keep[7] = False
    alone = svk.lmm_stochvol_swaptions_batch_reference(
        torch.from_numpy(np.ascontiguousarray(z[:, keep])), *args,
        **dict(KW, num_paths=PATHS - 1)).numpy()
    np.testing.assert_allclose(out, alone, rtol=1e-12)


def test_wrapper_rejects_bad_inputs():
    z, volT, scal, l0, deltas = (torch.from_numpy(a) for a in _inputs())
    call = svk.lmm_stochvol_swaptions_batch
    with pytest.raises(ValueError):                 # float64 normals
        call(z.double(), volT, scal, l0, deltas, **KW)
    with pytest.raises(ValueError):                 # no V-driver rows
        call(z[:S * FACTORS].contiguous(), volT, scal, l0, deltas, **KW)
    with pytest.raises(ValueError):                 # non-contiguous
        call(z.t().contiguous().t(), volT, scal, l0, deltas, **KW)
    with pytest.raises(ValueError):                 # not in engine order
        call(z, volT, scal, l0, deltas, **dict(KW, products=PRODUCTS[::-1]))
    with pytest.raises(ValueError):                 # swap beyond the grid
        call(z, volT, scal, l0, deltas,
             **dict(KW, products=((4, 5, 0.02),)))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cuda = [torch.from_numpy(a).cuda() for a in _inputs()]
    launches = svk.LAUNCHES
    got = svk.lmm_stochvol_swaptions_batch(*cuda, **KW)
    again = svk.lmm_stochvol_swaptions_batch(*cuda, **KW)
    torch.cuda.synchronize()
    assert svk.LAUNCHES == launches + 2
    assert torch.equal(got, again)      # fixed-order reduction, no atomics
    ref = svk.lmm_stochvol_swaptions_batch_reference(*cuda, **KW)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_backend_matches_cpu_backend():
    """The stoch-vol kernel backend on a card (CUDA kernel) against the same
    backend on the CPU (plain version), same Mersenne realization, at the
    benchmark's full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from finmath_tpu_torch.models.lmm import (StochVolKernelCalibration,
                                              build_benchmark_calibration)

    res = {}
    for device in ("cpu", "cuda"):
        setup = build_benchmark_calibration(
            num_paths=1000, brownian="finmath_mersenne", device=device)
        kb = StochVolKernelCalibration(setup.engine)
        x = np.asarray(setup.covariance.initial_parameters) * 1.05
        res[device] = (kb.residuals(x), kb.jacobian(x),
                       setup.engine.residuals(x))
    for a, b in zip(res["cpu"], res["cuda"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-5 * max(
            1.0, float(np.abs(a).max())))
