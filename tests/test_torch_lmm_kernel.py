"""The ATM-surface path sweep: the port's plain PyTorch version against the
JAX package's Pallas kernel (run under the TPU interpreter on the CPU), on
the same seeded normals, and the CUDA kernel against the plain version on a
card.

Small config of tests/test_kernel_backend.py's ATM section: 12 libors,
2 factors, 250 paths (not a multiple of 128, so the padded tail must
contribute nothing), products (2,4), (4,4), (6,4), (6,6) over three
exercise events, B = 3 parameter sets. Tolerance on every row's path sum:
rtol 1e-5, atol 1e-7 * paths — both sides simulate in float32, but the
spot drift's prefix sum runs in another order (sequential here,
Hillis-Steele there) and the Pallas kernel sums lanes in float32.

The ``gpu`` tests need a card and no JAX; on a machine with the card:
``python -m pytest tests/test_torch_lmm_kernel.py -m gpu --noconftest``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.ops import lmm_kernel  # noqa: E402

N_LIBORS, FACTORS, PATHS, B = 12, 2, 250, 3
PRODUCTS = ((2, 4, 0.021), (4, 4, 0.0195), (6, 4, 0.022), (6, 6, 0.0205))
EVENTS = (2, 4, 6)
S = 6
RTOL, ATOL = 1e-5, 1e-7 * PATHS


def _inputs(displaced, seed=23):
    """Seeded NumPy inputs in the kernel's layout."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((S * FACTORS, PATHS)).astype(np.float32)
    sigma = 0.004 + 0.002 * rng.random((B, N_LIBORS, S))       # [B, n, S]
    R = np.stack([np.ones(N_LIBORS),
                  np.linspace(-0.6, 0.6, N_LIBORS)], axis=1)
    R /= np.linalg.norm(R, axis=1, keepdims=True)              # [n, F]
    disp = 4.0 if displaced else 0.0
    if displaced:
        sigma = sigma / 4.02
    volT = (sigma[:, None, :, :] * R.T[None, :, :, None]).reshape(
        B, FACTORS * N_LIBORS, S).astype(np.float32)
    scal = np.zeros((B, 8), np.float32)
    scal[:, 0], scal[:, 1], scal[:, 2] = 0.5, np.sqrt(0.5), disp
    l0 = (0.02 + 0.002 * np.sin(np.arange(N_LIBORS))).astype(np.float32)
    deltas = np.full(N_LIBORS, 0.5, np.float32)
    return z, volT, scal, l0, deltas


def _kw(displaced):
    return dict(num_libors=N_LIBORS, num_factors=FACTORS, products=PRODUCTS,
                events=EVENTS, displaced=displaced, num_paths=PATHS)


def _jax_sums(z, volT, scal, l0, deltas, displaced):
    jax_kernel = pytest.importorskip("finmath_tpu.ops.lmm_kernel")
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    tiles = -(-PATHS // 128)
    zt = np.zeros((S * FACTORS, tiles * 128), np.float32)
    zt[:, :PATHS] = z
    zt = zt.reshape(S * FACTORS, tiles, 128).transpose(1, 0, 2)
    with pltpu.force_tpu_interpret_mode():
        out = jax_kernel.lmm_atm_swaptions_batch(zt, volT, scal, l0, deltas,
                                                 **_kw(displaced))
    lanes = np.asarray(out, dtype=np.float64).sum(axis=-1)
    return lanes[:, :len(PRODUCTS) + len(EVENTS)]


@pytest.mark.parametrize("displaced", [False, True])
def test_plain_version_matches_pallas_kernel(displaced):
    z, volT, scal, l0, deltas = _inputs(displaced)
    ref = _jax_sums(z, volT, scal, l0, deltas, displaced)
    launches = lmm_kernel.LAUNCHES
    got = lmm_kernel.lmm_atm_swaptions_batch(
        *(torch.from_numpy(a) for a in (z, volT, scal, l0, deltas)),
        **_kw(displaced))
    assert lmm_kernel.LAUNCHES == launches     # CPU tensors: plain version
    assert got.dtype == torch.float64
    assert tuple(got.shape) == (B, len(PRODUCTS) + len(EVENTS))
    assert np.all(np.isfinite(ref)) and np.all(ref[:, :4] > 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_pad_paths_contribute_nothing():
    """Extra columns of z beyond num_paths never enter the sums."""
    z, volT, scal, l0, deltas = _inputs(False)
    args = [torch.from_numpy(a) for a in (volT, scal, l0, deltas)]
    full = lmm_kernel.lmm_atm_swaptions_batch_reference(
        torch.from_numpy(z), *args, **_kw(False))
    wide = np.concatenate([z, 50.0 * np.ones((S * FACTORS, 6), np.float32)],
                          axis=1)
    cut = lmm_kernel.lmm_atm_swaptions_batch_reference(
        torch.from_numpy(wide), *args, **_kw(False))
    np.testing.assert_array_equal(full.numpy(), cut.numpy())


def test_wrapper_rejects_bad_inputs():
    z, volT, scal, l0, deltas = (torch.from_numpy(a) for a in _inputs(False))
    call = lmm_kernel.lmm_atm_swaptions_batch
    with pytest.raises(ValueError):                 # float64 normals
        call(z.double(), volT, scal, l0, deltas, **_kw(False))
    with pytest.raises(ValueError):                 # wrong path count
        call(z[:, :200], volT, scal, l0, deltas, **_kw(False))
    with pytest.raises(ValueError):                 # non-contiguous
        call(z.t().contiguous().t(), volT, scal, l0, deltas, **_kw(False))
    kw = _kw(False)
    kw["products"] = PRODUCTS[::-1]
    with pytest.raises(ValueError):                 # not in engine order
        call(z, volT, scal, l0, deltas, **kw)
    kw = _kw(False)
    kw["events"] = (2, 6)
    with pytest.raises(ValueError):                 # events != products'
        call(z, volT, scal, l0, deltas, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("displaced", [False, True])
def test_cuda_kernel_matches_plain_version(displaced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cuda = [torch.from_numpy(a).cuda() for a in _inputs(displaced)]
    launches = lmm_kernel.LAUNCHES
    got = lmm_kernel.lmm_atm_swaptions_batch(*cuda, **_kw(displaced))
    again = lmm_kernel.lmm_atm_swaptions_batch(*cuda, **_kw(displaced))
    torch.cuda.synchronize()
    assert lmm_kernel.LAUNCHES == launches + 2
    assert torch.equal(got, again)      # fixed-order reduction, no atomics
    ref = lmm_kernel.lmm_atm_swaptions_batch_reference(*cuda,
                                                       **_kw(displaced))
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_backend_matches_cpu_backend():
    """The ATM kernel backend on a card (CUDA kernel) against the same
    backend on the CPU (plain version), same injected normals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from finmath_tpu_torch.models.lmm import (ATMKernelCalibration,
                                              LMMValuationEngine,
                                              build_atm_calibration)

    rng = np.random.default_rng(29)
    inc = (np.sqrt(0.5) * rng.standard_normal((60, 1, 1000))).astype(
        np.float32)
    res = {}
    for device in ("cpu", "cuda"):
        setup = build_atm_calibration(num_paths=8, device=device)
        engine = LMMValuationEngine(setup.model, setup.products, 1000, 1,
                                    device=device, increments=inc)
        kb = ATMKernelCalibration(engine)
        x = np.asarray(setup.covariance.initial_parameters) * 1.1
        res[device] = (kb.residuals(x), kb.jacobian(x), engine.residuals(x))
    for a, b in zip(res["cpu"], res["cuda"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-5 * max(
            1.0, float(np.abs(a).max())))
