"""Exercise-aware Bermudan exposure, netting, and the regulatory stack
(SA-CCR EAD, then capital, then KVA).

Run: python finmath_tpu_torch/examples/15_bermudan_exposure_kva.py [--cpu]

Counterpart of ``examples/15_bermudan_exposure_kva.py``. A Bermudan
swaption's close-out value depends on an exercise policy: the netting
engine fits it by Longstaff-Schwartz backward induction inside the one
profile sweep, then every path carries its stopping time (post-exercise
paths expose the underlying swap, live paths the regressed continuation
value). The profile feeds CVA and, through SA-CCR, the capital profile
and KVA.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def main(num_paths: int = 20_000, device=None) -> dict:
    """The Bermudan's profile, the pricer's bracket, CVA, netting, SA-CCR
    EAD, capital and KVA on ``device`` (default: the CUDA card); returns
    the numbers printed."""
    import torch

    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)
    from finmath_tpu_torch.models.lmm.bermudan import (BermudanSwaption,
                                                       BermudanSwaptionPricer)
    from finmath_tpu_torch.models.lmm.exposure import (
        BermudanSwaptionTrade, NettingSetExposureEngine, SwapTrade,
        cva_from_profile)
    from finmath_tpu_torch.models.regulatory import (
        SACCRTrade, ccr_capital_profile, cva_capital_profile, kva,
        kva_from_capital_profile, saccr_ead_profile)
    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    setup = build_atm_calibration(num_paths=num_paths, num_factors=1,
                                  device=device)
    params = setup.covariance.initial_parameters
    model = setup.model
    notional = 1_000_000.0

    # 4Y-into-8Y Bermudan payer swaption, annual exercise, struck at par
    x0, last = 8, 24
    par = float(par_swap_rate(model.forward_curve, model.discount_curve,
                              model.tenor_times[x0:last + 1]))
    exercises = tuple(range(x0, last, 2))         # every year (0.5y grid)
    print(f"underlying par rate: {par * 100:.4f}%  "
          f"exercises at tenor indices {exercises}")

    # -- exposure profile of the Bermudan alone ------------------------
    berm = BermudanSwaptionTrade(exercises, last, par, notional=notional)
    eng = NettingSetExposureEngine(model, [berm], num_paths=num_paths,
                                   num_factors=1, seed=42, device=device)
    prof = eng.profile(params)
    t = prof.times
    print(f"\nBermudan t=0 value (forward_value[0]): "
          f"{prof.forward_value[0]:,.0f}")

    # cross-check against the dedicated pricer's duality bracket
    pricer = BermudanSwaptionPricer(
        model, BermudanSwaption(exercises, last, par), num_paths=num_paths,
        num_factors=1, seed=42, device=device)
    lo, hi = pricer.get_value_bounds(params)
    print(f"BermudanSwaptionPricer bracket: [{lo * notional:,.0f}, "
          f"{hi * notional:,.0f}]")

    peak = int(np.argmax(prof.ee))
    print(f"peak EE {prof.ee[peak]:,.0f} at t={t[peak]:.1f}y; "
          f"post-exercise ENE (two-way swap) min {np.min(prof.ene):,.0f}")
    cva = cva_from_profile(prof, hazard_rate=0.02, recovery=0.4)
    print(f"CVA (2% hazard, 40% recovery): {cva:,.0f}")

    # -- netting: Bermudan + offsetting receiver swap ------------------
    nset = NettingSetExposureEngine(
        model, [berm, SwapTrade(x0, last, par, payer=False,
                                notional=notional)],
        num_paths=num_paths, num_factors=1, seed=42, device=device)
    nprof = nset.profile(params)
    netted_cva = cva_from_profile(nprof, hazard_rate=0.02)
    print(f"\nnetting benefit (peak): {np.max(nprof.netting_benefit):,.0f}"
          f"  netted CVA: {netted_cva:,.0f}")

    # -- SA-CCR EAD profile -> capital -> KVA ---------------------------
    tenor = model.tenor_times
    trades = [SACCRTrade(notional, float(tenor[x0]), float(tenor[last]),
                         delta=0.6, hedging_set="EUR")]
    ead = saccr_ead_profile(prof, trades)
    cap = (ccr_capital_profile(ead, risk_weight=1.0)
           + cva_capital_profile(ead, t, maturity=float(tenor[last])))
    print(f"\nSA-CCR EAD at first obs: {ead[0]:,.0f}; "
          f"peak capital: {np.max(cap):,.0f}")
    k = kva_from_capital_profile(t, cap, cost_of_capital=0.10,
                                 counterparty_hazard_rate=0.02)
    print(f"KVA (10% cost of capital): {k:,.0f}")
    k_one = kva(prof, trades, counterparty_hazard_rate=0.02)
    print(f"one-call kva(): {k_one:,.0f}")
    return {"par": par, "exercises": exercises, "profile": prof,
            "bracket": (lo, hi), "cva": cva, "netting_profile": nprof,
            "netted_cva": netted_cva, "ead": np.asarray(ead),
            "capital": np.asarray(cap), "kva": k, "kva_one_call": k_one}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
