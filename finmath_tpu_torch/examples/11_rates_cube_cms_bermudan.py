"""Rates on a calibrated curve: a SABR swaption cube, CMS replication
under a linear TSR annuity mapping, a Hull-White Bermudan swaption by
Longstaff-Schwartz against the Crank-Nicolson PDE, and the delta hedge
and variance swap.

Run: python finmath_tpu_torch/examples/11_rates_cube_cms_bermudan.py [--cpu]

Counterpart of ``examples/11_rates_cube_cms_bermudan.py``. The cube, the
CMS replication and the PDE are host float64; the Bermudan, the hedge
and the variance swap simulate on the device.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import time  # noqa: E402

import numpy as np  # noqa: E402


def cube_and_cms() -> dict:
    from finmath_tpu_torch.models.cube import (
        CMSReplicationPricer, LinearTSRAnnuityMapping, SwaptionCube,
        SwaptionSmile, flat_lognormal_convexity_adjustment)
    from finmath_tpu_torch.models.curves import DiscountCurve, swap_annuity
    from finmath_tpu_torch.models.sabr import (
        SABRParams, sabr_lognormal_implied_volatility)

    ts = np.arange(0.5, 30.1, 0.5)
    curve = DiscountCurve(list(ts), list(np.exp(-0.025 * ts)))
    expiry, tenor, delta = 5.0, 10.0, 0.5
    pay = [expiry + (i + 1) * delta for i in range(int(tenor / delta))]
    a0 = swap_annuity(curve, pay, [delta] * len(pay))
    s0 = float((curve.get_discount_factor(expiry)
                - curve.get_discount_factor(pay[-1])) / a0)
    print(f"[curve]     5y10y par swap rate {s0:.4%}, annuity {a0:.4f}")

    # calibrate a cube cell from synthetic smile quotes
    cube = SwaptionCube()
    true = SABRParams(alpha=0.25 * s0 ** 0.3, beta=0.7, rho=-0.25, nu=0.25)
    ks = s0 * np.array([0.6, 0.8, 1.0, 1.3, 1.7])
    quotes = [sabr_lognormal_implied_volatility(true, s0, k, expiry)
              for k in ks]
    smile = cube.calibrate_cell(expiry, tenor, s0, ks, quotes, beta=0.7)
    atm = cube.get_volatility(expiry, tenor, s0)
    print(f"[cube]      5y10y SABR fit: alpha {smile.params.alpha:.4f} "
          f"rho {smile.params.rho:+.3f} nu {smile.params.nu:.3f}; "
          f"ATM vol {atm:.4f}")

    mapping = LinearTSRAnnuityMapping.from_curve(
        curve, s0, pay, payment_time=expiry + delta, period_length=delta)
    pricer = CMSReplicationPricer(smile, mapping, a0)
    ca = pricer.convexity_adjustment()
    cms = pricer.cms_rate()
    print(f"[cms]       convexity adjustment {ca*1e4:.2f} bp "
          f"(CMS rate {cms:.4%} vs forward {s0:.4%})")
    k = s0
    cap, flo, swp = (pricer.caplet_value(k), pricer.floorlet_value(k),
                     pricer.swaplet_value(k))
    print(f"            ATM caplet {cap:.6f}, floorlet {flo:.6f}, "
          f"parity |cap-flo-swaplet| = {abs(cap-flo-swp):.2e}")
    flat = SwaptionSmile(forward=s0, expiry=expiry,
                         params=SABRParams(alpha=0.25, beta=1.0,
                                           rho=0.0, nu=0.0))
    pr_flat = CMSReplicationPricer(flat, mapping, a0)
    exact = flat_lognormal_convexity_adjustment(s0, 0.25, expiry, mapping)
    flat_dev = abs(pr_flat.convexity_adjustment() - exact)
    print(f"            flat-smile quadrature vs EXACT closed form: "
          f"|dev| = {flat_dev:.2e}")
    return {"par": s0, "annuity": float(a0),
            "fit": (smile.params.alpha, smile.params.rho, smile.params.nu),
            "atm_vol": float(atm), "convexity": float(ca), "cms": float(cms),
            "caplet": float(cap), "floorlet": float(flo),
            "swaplet": float(swp), "flat_dev": float(flat_dev)}


def hull_white_bermudan(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.hull_white import (HullWhiteModel,
                                                     HullWhiteSimulation)
    from finmath_tpu_torch.models.hw_bermudan import (
        BermudanSwaption, hw_bermudan_swaption_pde)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    ts = np.arange(0.5, 20.1, 0.5)
    hw = HullWhiteModel(DiscountCurve(list(ts), list(np.exp(-0.022 * ts))),
                        0.1, [0.01])
    ex = [2.0 + 0.5 * i for i in range(10)]
    td = TimeDiscretization(initial=0.0, num_steps=14, step=0.5)
    sim = HullWhiteSimulation(hw, td, num_paths=num_paths, seed=11,
                              antithetic=True, device=device)
    prod = BermudanSwaption(ex, 7.0, 0.025)
    v, e = prod.get_value_and_error(sim)     # warm
    t0 = time.perf_counter()
    v, e = prod.get_value_and_error(sim)     # returns host floats
    ms = (time.perf_counter() - t0) * 1e3
    pde = hw_bermudan_swaption_pde(hw, ex, 7.0, 0.025, nx=601,
                                   steps_per_year=100)
    eur = max(hw.swaption(t, list(prod.remaining_payments(i)), 0.025)
              for i, t in enumerate(ex))
    print(f"[bermudan]  LS {num_paths // 1000}k x 10 dates: {v:.6f} +- "
          f"{e:.6f}  ({ms:.0f} ms)")
    print(f"            PDE oracle {pde:.6f} ({(v-pde)/e:+.1f} sigma); "
          f"best European {eur:.6f}")
    return {"value": v, "stderr": e, "pde": float(pde),
            "best_european": float(eur), "ms": ms}


def hedge_and_variance(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.hedging import (DeltaHedgedPortfolio,
                                                  VarianceSwap)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    td = TimeDiscretization(initial=0.0, num_steps=250, step=1.0 / 250)
    sim = MonteCarloBlackScholesModel(td, num_paths,
                                      BlackScholesModel(100.0, 0.05, 0.3),
                                      seed=42, device=device)
    res = DeltaHedgedPortfolio(1.0, 105.0).simulate(sim)
    print(f"[hedge]     250 rebalances: portfolio value {res['value']:.4f} "
          f"(premium {res['premium']:.4f}), residual std "
          f"{res['hedge_error_std']:.4f}")
    fair = VarianceSwap(1.0).fair_strike(sim)
    print(f"[varswap]   fair strike {fair:.6f} (sigma^2 = {0.3**2})")
    return {"hedge": res, "variance_strike": fair}


def main(bermudan_paths: int = 500_000, hedge_paths: int = 500_000,
         device=None) -> dict:
    """The cube and CMS, the Hull-White Bermudan and the hedge and
    variance swap in the JAX script's order on ``device`` (default: the
    CUDA card); returns what each printed."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    print(f"devices: [{device}] ({name})\n")
    out = {"cube": cube_and_cms()}
    print()
    out["bermudan"] = hull_white_bermudan(device, bermudan_paths)
    print()
    out["hedge"] = hedge_and_variance(device, hedge_paths)
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
