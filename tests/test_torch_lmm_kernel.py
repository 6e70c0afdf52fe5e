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

The plain version takes its running sums in the kernel's order, one
float32 addition after another (``ops/_products.py``). Two tests hold that
order (13 libors, so no row chunk divides them, F = 1 and 2, B = 3,
DISPLACED, 37 paths): bit for bit against a float32 sum taken one addition
at a time, and against the earlier ``torch.cumsum`` / ``torch.cumprod``
order within the bound above.

The ``gpu`` tests need a card and no JAX; on a machine with the card:
``python -m pytest tests/test_torch_lmm_kernel.py -m gpu --noconftest``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.ops import lmm_kernel  # noqa: E402
from test_torch_sum_order import (assert_kernel_order,  # noqa: E402
                                  cumsum_order, recording)

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


ODD_N, ODD_PATHS = 13, 37
ODD_PRODUCTS = ((1, 5, 0.02), (3, 10, 0.021), (3, 4, 0.0195), (7, 6, 0.022),
                (7, 3, 0.02))
ODD_EVENTS = (1, 3, 7)


def _odd_inputs(F, displaced, B_=B, seed=41):
    """Seeded inputs at 13 libors (no row chunk divides them)."""
    rng = np.random.default_rng(seed)
    S_ = ODD_PRODUCTS[-1][0]
    z = rng.standard_normal((S_ * F, ODD_PATHS)).astype(np.float32)
    volT = (0.003 + 0.004 * rng.random((B_, F * ODD_N, S_))).astype(
        np.float32)
    if displaced:
        volT /= 4.02
    scal = np.zeros((B_, 8), np.float32)
    scal[:, 0], scal[:, 1], scal[:, 2] = 0.5, np.sqrt(0.5), \
        (4.0 if displaced else 0.0)
    l0 = (0.02 + 0.003 * np.cos(np.arange(ODD_N))).astype(np.float32)
    deltas = np.full(ODD_N, 0.5, np.float32)
    return [torch.from_numpy(a) for a in (z, volT, scal, l0, deltas)], dict(
        num_libors=ODD_N, num_factors=F, products=ODD_PRODUCTS,
        events=ODD_EVENTS, displaced=displaced, num_paths=ODD_PATHS)


@pytest.mark.parametrize("F,displaced", [(1, False), (2, True)])
def test_plain_running_sums_follow_kernel_order(F, displaced):
    """Every running sum of the plain version, through the wrapper, equals
    a float32 sum taken one addition at a time in the kernel's order."""
    args, kw = _odd_inputs(F, displaced)
    with recording(lmm_kernel) as calls:
        lmm_kernel.lmm_atm_swaptions_batch(*args, **kw)
    assert_kernel_order(calls)


@pytest.mark.parametrize("F,displaced", [(1, False), (2, True)])
def test_plain_version_matches_cumsum_order(F, displaced):
    """The kernel's order of additions against the earlier plain version's
    ``cumsum`` / ``cumprod`` order, within the kernel-vs-plain bound."""
    args, kw = _odd_inputs(F, displaced)
    got = lmm_kernel.lmm_atm_swaptions_batch_reference(*args, **kw).numpy()
    with cumsum_order(lmm_kernel):
        ref = lmm_kernel.lmm_atm_swaptions_batch_reference(*args,
                                                           **kw).numpy()
    assert np.all(np.isfinite(got)) and not np.array_equal(got, ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7 * ODD_PATHS)


@pytest.mark.parametrize("F,displaced", [(1, False), (2, True)])
def test_partials_reference_sums_to_reference(F, displaced):
    """The plain partials (the kernel's order of float64 additions) sum
    over the tiles to the plain path sums within 1e-12 relative."""
    args, kw = _odd_inputs(F, displaced)
    partials = lmm_kernel.lmm_atm_swaptions_partials_reference(*args, **kw)
    ref = lmm_kernel.lmm_atm_swaptions_batch_reference(*args, **kw)
    assert partials.dtype == torch.float64
    assert tuple(partials.shape) == (B, 1, len(ODD_PRODUCTS)
                                     + len(ODD_EVENTS))
    np.testing.assert_allclose(partials.sum(dim=1).numpy(), ref.numpy(),
                               rtol=1e-12)


def _launch_partials(args, kw):
    """The partials ``[B, tiles, P + E]`` of one kernel launch."""
    go, partials = lmm_kernel.prepare(*args, **kw)
    go()
    return partials


@pytest.mark.gpu
@pytest.mark.parametrize("displaced", [False, True])
def test_cuda_kernel_matches_plain_version(displaced):
    """Through the wrapper, and at 13 libors (a partial row chunk) at B = 3
    and at the FD batch B = 87, each against the plain version; a second
    launch is bitwise equal, and a launch's partials equal the plain
    partials bit for bit (no FMA contraction)."""
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
    assert torch.equal(
        _launch_partials(cuda, _kw(displaced)),
        lmm_kernel.lmm_atm_swaptions_partials_reference(*cuda,
                                                        **_kw(displaced)))
    for batch in (B, 87):
        args, kw = _odd_inputs(1 if displaced else 2, displaced, B_=batch)
        args = [a.cuda() for a in args]
        assert torch.equal(
            _launch_partials(args, kw),
            lmm_kernel.lmm_atm_swaptions_partials_reference(*args, **kw))
        got = lmm_kernel.lmm_atm_swaptions_batch(*args, **kw)
        assert torch.equal(got, lmm_kernel.lmm_atm_swaptions_batch(*args,
                                                                   **kw))
        ref = lmm_kernel.lmm_atm_swaptions_batch_reference(*args, **kw)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=RTOL, atol=1e-7 * ODD_PATHS)


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
