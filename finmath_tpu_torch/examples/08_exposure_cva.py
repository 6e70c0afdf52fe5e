"""Counterparty exposure profiles and CVA on the LIBOR Market Model.

Run: python finmath_tpu_torch/examples/08_exposure_cva.py [--cpu]

Counterpart of ``examples/08_exposure_cva.py``. The exposure collector
rides the same simulation as the pricer (``models/lmm/exposure.py``):
one sweep gives EE(t), ENE(t) and the PFE quantiles at every tenor date,
and the CVA integral from them; nothing is simulated again for an
observation date.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def main(num_paths: int = 20_000, device=None) -> dict:
    """The swap profile and its CVA, the three-trade netting set with its
    CVA ladder, the mixed set's bilateral CVA and the physical swaption's
    profile on ``device`` (default: the CUDA card); returns the numbers
    printed."""
    import torch

    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)
    from finmath_tpu_torch.models.lmm.exposure import (
        NettingSetExposureEngine, SwapExposureEngine, SwaptionExposureEngine,
        SwaptionTrade, SwapTrade, bilateral_cva_from_profile)
    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)

    # the ATM workload's 40Y EUR model (bootstrapped curves and piecewise
    # vol); exposure of a 2Y-forward-starting 8Y payer swap struck at par
    setup = build_atm_calibration(num_paths=num_paths, num_factors=1,
                                  device=device)
    params = setup.covariance.initial_parameters
    model = setup.model
    par = par_swap_rate(model.forward_curve, model.discount_curve,
                        model.tenor_times[4:21])
    print(f"par rate of the underlying swap: {par * 100:.4f}%")

    engine = SwapExposureEngine(
        model, first_index=4, last_index=20, strike=par, payer=True,
        notional=1_000_000.0, num_paths=num_paths, num_factors=1,
        quantiles=(0.95, 0.99), device=device)
    prof = engine.profile(params)
    analytic = engine.analytic_forward_values()

    print(f"{'t':>5} {'EE':>12} {'ENE':>12} {'fwd value':>12} "
          f"{'analytic':>12} {'PFE 95%':>12} {'PFE 99%':>12}")
    for i, t in enumerate(prof.times):
        print(f"{t:5.1f} {prof.ee[i]:12.0f} {prof.ene[i]:12.0f} "
              f"{prof.forward_value[i]:12.0f} {analytic[i]:12.0f} "
              f"{prof.pfe[0.95][i]:12.0f} {prof.pfe[0.99][i]:12.0f}")

    martingale = float(np.max(np.abs(prof.forward_value - analytic)))
    print(f"\npeak EE {np.max(prof.ee):,.0f} at "
          f"t={prof.times[np.argmax(prof.ee)]}")
    print(f"peak PFE(99%) {prof.max_pfe(0.99):,.0f}")
    print(f"martingale check: max |fwd - analytic| = {martingale:,.1f} "
          f"(Monte-Carlo error on a {engine.notional:,.0f} notional)")

    # unilateral CVA against a flat-hazard counterparty, 40% recovery
    cva_by_hazard = {}
    for h in (0.004, 0.012, 0.03):
        cva_by_hazard[h] = engine.cva(params, hazard_rate=h, recovery=0.4)
        print(f"CVA @ hazard {h * 1e4:5.0f} bp: {cva_by_hazard[h]:12,.0f}")

    # ---- netting set: offsetting trades share one close-out value -------
    netting = NettingSetExposureEngine(
        model,
        trades=[
            SwapTrade(4, 20, par, payer=True, notional=1_000_000.0),
            SwapTrade(2, 12, 0.002, payer=False, notional=700_000.0),
            SwapTrade(6, 16, 0.004, payer=True, notional=300_000.0),
        ],
        num_paths=num_paths, num_factors=1, device=device)
    nprof = netting.profile(params)
    netted_cva = netting.cva(params, hazard_rate=0.012)
    print("\nnetting set (3 trades):")
    print(f"  peak netted EE     {np.max(nprof.ee):12,.0f}")
    print(f"  peak standalone EE {np.max(nprof.ee_standalone):12,.0f}")
    print(f"  peak netting benefit {np.max(nprof.netting_benefit):10,.0f}")
    print(f"  netted CVA @120bp  {netted_cva:12,.0f}")

    # ---- CVA delta ladder: one reverse pass, all curve buckets ----------
    ladder_cva, ladder = netting.cva_forward_deltas(params, hazard_rate=0.012)
    hot = int(np.argmax(np.abs(ladder)))
    print(f"  CVA delta ladder ({ladder.shape[0]} buckets, one reverse "
          f"pass): hottest bucket T={model.tenor_times[hot]:.1f}y "
          f"dCVA/dL0 = {ladder[hot]:,.0f}")

    # ---- mixed netting set: swaps and swaptions share one close-out -----
    k10 = par_swap_rate(model.forward_curve, model.discount_curve,
                        model.tenor_times[10:21])
    mixed = NettingSetExposureEngine(
        model,
        trades=[
            SwapTrade(4, 20, par, payer=True, notional=1_000_000.0),
            SwaptionTrade(10, 10, float(k10), notional=600_000.0,
                          physical=True),
            SwaptionTrade(6, 6, 0.004, notional=-400_000.0,
                          physical=False),
        ],
        num_paths=num_paths, num_factors=1, device=device)
    mprof = mixed.profile(params)
    bilateral = bilateral_cva_from_profile(mprof, 0.02, 0.008)
    print("\nmixed netting set (swap + long physical swaption + short "
          "cash swaption):")
    print(f"  peak netted EE {np.max(mprof.ee):12,.0f}   "
          f"peak benefit {np.max(mprof.netting_benefit):10,.0f}")
    print(f"  bilateral CVA (cpty 200bp / own 80bp): {bilateral:10,.0f}")

    # ---- swaption exposure: conditional value by LS regression ----------
    x, m_per = 10, 10
    k_sw = par_swap_rate(model.forward_curve, model.discount_curve,
                         model.tenor_times[x:x + m_per + 1])
    sw = SwaptionExposureEngine(model, x, m_per, float(k_sw), physical=True,
                                notional=1_000_000.0, num_paths=num_paths,
                                num_factors=1, device=device)
    sprof = sw.profile(params)
    ev_x = sw._ev_x
    print(f"\n5Y-into-5Y payer swaption (physical): value "
          f"{sprof.forward_value[ev_x]:,.0f}")
    print(f"  EE at first obs / expiry / after exercise: "
          f"{sprof.ee[0]:,.0f} / {sprof.ee[ev_x]:,.0f} / "
          f"{sprof.ee[ev_x + 1]:,.0f}")
    print(f"  post-exercise ENE (two-way swap): {sprof.ene[-1]:,.0f}")
    return {"par": float(par), "profile": prof, "analytic": analytic,
            "martingale": martingale, "cva": cva_by_hazard,
            "netting_profile": nprof, "netted_cva": netted_cva,
            "ladder_cva": float(ladder_cva), "ladder": np.asarray(ladder),
            "mixed_profile": mprof, "bilateral_cva": bilateral,
            "swaption_profile": sprof, "swaption_expiry_index": ev_x}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
