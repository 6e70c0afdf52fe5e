"""The hand-written path kernels and a Bermudan swaption by
Longstaff-Schwartz.

Run: python finmath_tpu_torch/examples/05_pallas_kernels_and_bermudan.py [--cpu]

Counterpart of ``examples/05_pallas_kernels_and_bermudan.py``, whose
kernel sections run only on a TPU. Here all three sections run on every
device: on the card the fused pricers are launches of the CUDA kernels,
on the CPU their plain PyTorch versions.

1. The fused Black-Scholes pricer (``ops.kernels.
   mc_european_call_price_kernel``: one ``bs_paths_kernel`` launch,
   Philox, Box-Muller and the whole Euler loop in the kernel) against the
   step-loop pricer and the analytic value.
2. The one-factor LMM swaption kernel (``ops.lmm_kernel.
   lmm_swaption_kernel``: one ``lmm_swaption_paths`` launch) against the
   valuation engine; the two draw different streams, so they agree
   statistically.
3. A Bermudan swaption by Longstaff-Schwartz regression against the
   European with the same underlying.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

S0, R, SIGMA, T, K = 1.0, 0.05, 0.30, 1.0, 1.05
E, M = 10, 20           # the 5Y x 10Y swaption on the 0.5Y grid


def main(fused_paths: int = 1_000_000, swaption_paths: int = 204_800,
         bermudan_paths: int = 50_000, device=None) -> dict:
    """The three sections on ``device`` (default: the CUDA card); returns
    the prices."""
    import torch

    from finmath_tpu_torch.models.analytic import black_scholes_option_value
    from finmath_tpu_torch.models.black_scholes import mc_european_call_price
    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)
    from finmath_tpu_torch.models.lmm.bermudan import (BermudanSwaption,
                                                       BermudanSwaptionPricer)
    from finmath_tpu_torch.models.lmm.model import (LMMValuationEngine,
                                                    SwaptionProduct)
    from finmath_tpu_torch.ops.kernels import mc_european_call_price_kernel
    from finmath_tpu_torch.ops.lmm_kernel import lmm_swaption_kernel
    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)

    # ---- 1. BS kernel vs step loop vs analytic --------------------------
    analytic = black_scholes_option_value(S0, R, SIGMA, T, K)
    v_scan = mc_european_call_price(7, fused_paths, 100, S0, R, SIGMA, T, K,
                                    device=device)
    print(f"analytic {analytic:.6f} | step loop {v_scan:.6f}")
    v_kernel = mc_european_call_price_kernel(7, fused_paths, 100, S0, R,
                                             SIGMA, T, K, device=device)
    print(f"fused kernel {v_kernel:.6f} ({fused_paths:,} paths x 100 steps "
          f"in one launch on {device})")
    assert abs(v_kernel - analytic) < 0.005

    # ---- 2. LMM swaption kernel vs valuation engine ---------------------
    a = build_atm_calibration(num_paths=256, num_factors=1, device=device)
    cov = a.model.covariance
    p0 = np.asarray(cov.initial_parameters)
    prep = cov.prepare(torch.as_tensor(p0))
    vol1 = (cov.vol_table(prep)
            * cov.factor_matrix(prep)[:, 0][None, :]).cpu().numpy()
    strike = next(p.strike for p in a.products
                  if p.exercise_index == E and p.num_periods == M)
    eng = LMMValuationEngine(
        a.model, [SwaptionProduct(E, M, strike, 0.0, value_unit="VALUE")],
        swaption_paths, 1, 99, device=device)
    v_eng = float(eng.values(p0)[0])
    v_k = float(lmm_swaption_kernel(
        7, swaption_paths, a.model.num_libors, E, M, E, vol1,
        np.asarray(a.model.initial_forwards), np.asarray(a.model.deltas),
        0.5, strike, device=device))
    rel_dev = abs(v_k - v_eng) / v_eng
    print(f"LMM 5Yx10Y swaption: engine {v_eng:.6f} | kernel {v_k:.6f} "
          f"(rel dev {rel_dev:.3%}, different streams)")

    # ---- 3. Bermudan swaption (Longstaff-Schwartz) ----------------------
    setup = build_atm_calibration(num_paths=bermudan_paths, num_factors=1,
                                  device=device)
    p0 = setup.covariance.initial_parameters
    euro = BermudanSwaptionPricer(
        setup.model, BermudanSwaption((8,), 20, 0.01), bermudan_paths, 1,
        device=device).get_value(p0)
    berm = BermudanSwaptionPricer(
        setup.model, BermudanSwaption((4, 8, 12, 16), 20, 0.01),
        bermudan_paths, 1, device=device).get_value(p0)
    print(f"payer swaption 4Yx6Y strike 1%: European {euro:.6f} | "
          f"Bermudan (4 rights) {berm:.6f}")
    assert berm >= euro - 1e-4  # more rights are worth more
    return {"analytic": analytic, "scan": v_scan, "fused": v_kernel,
            "swaption_engine": v_eng, "swaption_kernel": v_k,
            "swaption_rel_dev": rel_dev, "european": euro, "bermudan": berm}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
