"""Credit and multi-currency layers: a CDS bootstrap, CIR++ doubly
stochastic default intensity, wrong-way-risk CVA (joint Hull-White and
CIR++ simulation), the two-economy cross-currency model (FX options under
stochastic rates, CCS par identities), and one-factor copula portfolio
credit (CDO tranches) at index scale.

Run: python finmath_tpu_torch/examples/13_credit_xccy_portfolio.py [--cpu]

Counterpart of ``examples/13_credit_xccy_portfolio.py``. The bootstrap,
the tranche recursion and the closed forms are host float64; the
simulations run on the device. Each part prints its wall, read after the
device's queue has drained.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import math  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

PATHS = 200_000

T_GRID = np.arange(0.0, 31.0)


def _curves():
    from finmath_tpu_torch.models.curves import DiscountCurve
    dc_d = DiscountCurve(T_GRID, np.exp(-0.03 * T_GRID))
    dc_f = DiscountCurve(T_GRID, np.exp(-0.01 * T_GRID))
    return dc_d, dc_f


def single_name_credit(device, num_paths=PATHS):
    from finmath_tpu_torch.models import (CIRPPIntensityModel,
                                          CIRPPSimulation, TimeDiscretization,
                                          bootstrap_survival_curve,
                                          cds_par_spread, cds_value)
    dc, _ = _curves()
    mats = [1.0, 3.0, 5.0, 7.0, 10.0]
    spreads = [0.006, 0.009, 0.012, 0.014, 0.016]
    curve = bootstrap_survival_curve(dc, mats, spreads, recovery=0.4)
    worst = max(abs(cds_value(dc, curve, m, s))
                for m, s in zip(mats, spreads))
    print(f"[cds]      bootstrapped 5 quotes; worst reprice {worst:.1e}; "
          f"hazards {np.round(curve.hazards * 1e4).astype(int)} bp")
    par4 = cds_par_spread(dc, curve, 4.0, recovery=0.4)
    print(f"[cds]      4y par spread (interpolated credit): "
          f"{1e4 * par4:.1f} bp")

    intensity = CIRPPIntensityModel(curve, kappa=0.5, theta=0.015,
                                    sigma=0.08, y0=0.01)
    td = TimeDiscretization(initial=0.0, num_steps=40, step=0.25)
    sim = CIRPPSimulation(intensity, td, num_paths=num_paths, seed=7,
                          antithetic=True, substeps=4, device=device)
    survival = {}
    for t in (5.0, 10.0):
        survival[t] = (sim.expected_survival(t),
                       float(curve.get_survival_probability(t)))
        print(f"[cir++]    E[S({t:.0f}y)] = {survival[t][0]:.6f}"
              f" vs market {survival[t][1]:.6f}"
              " (doubly-stochastic martingale)")
    out = {"hazards": np.asarray(curve.hazards), "worst_reprice": worst,
           "par_4y": float(par4), "survival": survival}
    return out, (dc, intensity)


def wrong_way_cva(device, dc, intensity, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models import (HullWhiteModel,
                                          WrongWayRiskCVAEngine,
                                          par_swap_rate)
    hw = HullWhiteModel(dc, mean_reversion=0.1, volatility=0.01)
    pay = np.arange(1, 21) * 0.5
    k = par_swap_rate(dc, pay)
    print(f"[wwr]      10y semiannual par payer swap, K = {k:.4%}")
    results = {}
    for rho in (0.0, 0.6, -0.6):
        eng = WrongWayRiskCVAEngine(hw, intensity, pay, k,
                                    num_paths=num_paths, correlation=rho,
                                    recovery=0.4, seed=31, antithetic=True,
                                    substeps=4, device=device)
        r = eng.compute()
        results[rho] = (r.cva, r.cva_independent, r.wwr_ratio)
        print(f"[wwr]      rho={rho:+.1f}: CVA {1e4 * r.cva:.2f} bp "
              f"(vs independent {1e4 * r.cva_independent:.2f} bp, "
              f"ratio {r.wwr_ratio:.3f})")
    return {"strike": float(k), "by_rho": results}


def cross_currency(device, dc_d, dc_f, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models import (CrossCurrencyModel,
                                          CrossCurrencySimulation,
                                          HullWhiteModel, TimeDiscretization)
    m = CrossCurrencyModel(HullWhiteModel(dc_d, 0.1, 0.01),
                           HullWhiteModel(dc_f, 0.05, 0.008),
                           fx_spot=1.25, fx_vol=0.10, rho_df=0.3,
                           rho_dx=-0.2, rho_fx=0.25)
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)
    sim = CrossCurrencySimulation(m, td, num_paths=num_paths, seed=5,
                                  antithetic=True, device=device)
    d = sim.martingale_diagnostics(5.0, 10.0)
    parity = abs(d["covered_parity"][0] / d["covered_parity"][1] - 1)
    print(f"[xccy]     covered interest parity rel err {parity:.1e}"
          " (exact joint transitions)")
    strikes = [1.0, 1.25, 1.5]
    _, prices, se = sim.mc_fx_option_prices(5.0, strikes)
    closed = []
    for k, p, s in zip(strikes, prices, se):
        cf = m.fx_option(5.0, k)
        closed.append(float(cf))
        print(f"[xccy]     5y FX call K={k}: MC {p:.5f} +- {s:.5f} vs "
              f"hump-vol closed form {cf:.5f}")
    dom, fgn = sim.mc_ccs_legs(np.arange(1, 11) * 1.0)
    print(f"[xccy]     CCS legs: domestic {dom:.5f} (par 1), foreign/X0 "
          f"{fgn / 1.25:.5f} (par 1)")
    return {"parity": float(parity), "prices": np.asarray(prices),
            "stderr": np.asarray(se), "closed_form": closed,
            "ccs": (float(dom), float(fgn))}


def portfolio_credit(device, dc, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models import (GaussianCopulaPortfolio,
                                          GaussianCopulaSimulation,
                                          SurvivalCurve,
                                          lhp_expected_tranche_loss)
    rng = np.random.default_rng(1)
    hazards = rng.uniform(0.005, 0.06, 125)
    betas = rng.uniform(0.3, 0.7, 125)
    pf = GaussianCopulaPortfolio(
        [SurvivalCurve([0.0], [h]) for h in hazards], betas=betas,
        recoveries=0.4, notionals=np.full(125, 1 / 125))
    spreads = {}
    for a, d in ((0.0, 0.03), (0.03, 0.07), (0.07, 0.15)):
        spreads[(a, d)] = pf.tranche_par_spread(dc, a, d, 5.0)
        print(f"[cdo]      {a:.0%}-{d:.0%} tranche 5y par spread "
              f"{1e4 * spreads[(a, d)]:.0f} bp (exact recursion)")
    sim = GaussianCopulaSimulation(pf, num_paths=num_paths, seed=7,
                                   device=device)
    st = sim.tranche_statistics([5.0], 0.03, 0.07, ks=(1, 10))
    ex = pf.expected_tranche_loss(5.0, 0.03, 0.07)
    print(f"[cdo]      MC 3-7% ETL(5y) {st['etl'][0]:.6f} +- "
          f"{st['etl_stderr'][0]:.6f} vs exact {ex:.6f}")
    hom = GaussianCopulaPortfolio([SurvivalCurve([0.0], [0.02])] * 200,
                                  betas=0.5, notionals=1 / 200)
    pd5 = float(1 - math.exp(-0.02 * 5.0))
    exact200 = hom.expected_tranche_loss(5.0, 0.03, 0.07)
    lhp = lhp_expected_tranche_loss(pd5, 0.5, 0.03, 0.07)
    print(f"[cdo]      200-name exact vs Vasicek LHP: {exact200:.6f} vs "
          f"{lhp:.6f}")
    return {"spreads": spreads, "etl_mc": float(st["etl"][0]),
            "etl_stderr": float(st["etl_stderr"][0]), "etl_exact": float(ex),
            "exact_200": float(exact200), "lhp": float(lhp)}


def main(num_paths: int = PATHS, device=None) -> dict:
    """The CDS bootstrap with CIR++, WWR CVA by rho, cross-currency and the
    copula in the JAX script's order on ``device`` (default: the CUDA
    card), each with its wall; returns what each printed and the walls."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    walls = {}
    t0 = time.perf_counter()
    out = {}
    out["single_name_credit"], (dc, intensity) = single_name_credit(
        device, num_paths)
    sync()
    walls["single_name_credit"] = time.perf_counter() - t0
    print(f"--- single_name_credit: {walls['single_name_credit']:.1f} s\n")
    dc_d, dc_f = _curves()
    for name, step in (
            ("wrong_way_cva",
             lambda: wrong_way_cva(device, dc, intensity, num_paths)),
            ("cross_currency",
             lambda: cross_currency(device, dc_d, dc_f, num_paths)),
            ("portfolio_credit",
             lambda: portfolio_credit(device, dc, num_paths))):
        t0 = time.perf_counter()
        out[name] = step()
        sync()
        walls[name] = time.perf_counter() - t0
        print(f"--- {name}: {walls[name]:.1f} s\n")
    out["walls"] = walls
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
