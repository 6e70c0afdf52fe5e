"""The meshed LMM engine and the meshed swap exposure engine on a CUDA
device (``gpu`` tests; no JAX needed, run with ``-m gpu --noconftest``;
each skips without a card): a world of one rank under NCCL on ``cuda:0``
prices one injected block with the meshed engine, against the unsharded
engine on the same block and card. With one rank the all-reduce adds
nothing, so the values differ by the order of the float64 sums only:
1e-12 relative, and residuals and the Jacobian 1e-9 absolute (the float64
reduction gap of ``tests/test_torch_parallel.py``); the exposure profile's
EE, ENE, forward value and PFE 1e-12, its CVA 1e-10 relative
(``tests/test_torch_exposure_mesh.py``'s bounds)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.parallel.launch import run_world  # noqa: E402

PATHS, STEPS, SEED = 8_192, 60, 7
SWAP = dict(first_index=4, last_index=20, strike=0.02)


def _block() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return (np.sqrt(0.5) * rng.standard_normal((STEPS, 1, PATHS))
            ).astype(np.float32)


def atm_on_the_card(mesh):
    """The ATM engine's values, residuals and Jacobian on the card, with
    ``mesh`` (a world of one) or without (``mesh=None``)."""
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm.model import LMMValuationEngine

    setup = build_atm_calibration(num_paths=8, num_factors=1, device="cuda")
    engine = LMMValuationEngine(setup.model, setup.products, PATHS, 1,
                                increments=_block(), mesh=mesh,
                                device=None if mesh is not None else "cuda")
    x0 = np.asarray(setup.covariance.initial_parameters)
    return dict(device=str(engine.device), values=engine.values(x0),
                residuals=engine.residuals(x0), jacobian=engine.jacobian(x0),
                calls=None if mesh is None else mesh.calls,
                backend=None if mesh is None else mesh.backend)


@pytest.mark.gpu
def test_meshed_atm_engine_on_the_card_matches_unsharded(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the engine run on the "
                    "card")
    (meshed,) = run_world(f"{__name__}:atm_on_the_card", 1, backend="nccl",
                          device="cuda:0", timeout=600, directory=tmp_path)
    plain = atm_on_the_card(None)
    assert meshed["backend"] == "nccl" and meshed["device"] == "cuda:0"
    assert meshed["calls"] == 3
    np.testing.assert_allclose(meshed["values"], plain["values"],
                               rtol=1e-12, atol=0)
    for name in ("residuals", "jacobian"):
        np.testing.assert_allclose(meshed[name], plain[name], rtol=0,
                                   atol=1e-9)


def swap_profile_on_the_card(mesh):
    """The 10Y swap's exposure profile and CVA on the card on one injected
    block, with ``mesh`` (a world of one) or without (``mesh=None``)."""
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm.exposure import SwapExposureEngine

    setup = build_atm_calibration(num_paths=8, num_factors=1, device="cuda")
    engine = SwapExposureEngine(
        setup.model, num_paths=PATHS, num_factors=1, increments=_block()[:40],
        quantiles=(0.95, 0.99), mesh=mesh,
        device=None if mesh is not None else "cuda", **SWAP)
    x0 = np.asarray(setup.covariance.initial_parameters)
    prof = engine.profile(x0)
    return dict(device=str(engine.device), ee=prof.ee, ene=prof.ene,
                forward_value=prof.forward_value, pfe=prof.pfe,
                cva=engine.cva(x0, hazard_rate=0.012),
                backend=None if mesh is None else mesh.backend)


@pytest.mark.gpu
def test_meshed_swap_exposure_on_the_card_matches_unsharded(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the engine run on the "
                    "card")
    (meshed,) = run_world(f"{__name__}:swap_profile_on_the_card", 1,
                          backend="nccl", device="cuda:0", timeout=600,
                          directory=tmp_path)
    plain = swap_profile_on_the_card(None)
    assert meshed["backend"] == "nccl" and meshed["device"] == "cuda:0"
    for name in ("ee", "ene", "forward_value"):
        np.testing.assert_allclose(meshed[name], plain[name], rtol=0,
                                   atol=1e-12)
    for q, want in plain["pfe"].items():
        np.testing.assert_allclose(meshed["pfe"][q], want, rtol=0, atol=1e-12)
    assert meshed["cva"] == pytest.approx(plain["cva"], rel=1e-10)
