"""Inflation (Jarrow-Yildirim), commodities (Schwartz-Smith) and the
market-risk engine.

Run: python finmath_tpu_torch/examples/14_inflation_commodity_risk.py [--cpu]

Counterpart of ``examples/14_inflation_commodity_risk.py``. The ZCIS and
YoY rates, the futures curve, the closed forms and Kupiec's test are host
float64; the simulations and the full revaluation of the book run on the
device. Each part prints its wall, read after the device's queue has
drained.
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


def inflation(device, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models import (HullWhiteModel, JarrowYildirimModel,
                                          JarrowYildirimSimulation,
                                          TimeDiscretization)
    from finmath_tpu_torch.models.curves import DiscountCurve

    t = np.arange(0.0, 21.0)
    nominal = HullWhiteModel(DiscountCurve(t, np.exp(-0.03 * t)), 0.1, 0.01)
    real = HullWhiteModel(DiscountCurve(t, np.exp(-0.01 * t)), 0.2, 0.006)
    jy = JarrowYildirimModel(nominal, real, cpi_initial=100.0,
                             cpi_vol=0.012, rho_nr=0.3, rho_ni=0.1,
                             rho_ri=-0.3)
    zcis = {T: jy.zcis_par_rate(T) for T in (2.0, 5.0, 10.0)}
    print("[infl]  ZCIS par rates: "
          + ", ".join(f"{T:.0f}y {r:.4%}" for T, r in zcis.items()))
    k = jy.yoy_swap_par_rate(np.arange(1.0, 11.0))
    print(f"[infl]  10y YoY swap par rate {k:.4%} (convexity-corrected)")
    naive = float(real.df(5.0) / real.df(4.0)
                  * nominal.df(4.0) / nominal.df(5.0))
    yoy = jy.yoy_forward(4.0, 5.0)
    print(f"[infl]  YoY fwd 4y-5y {yoy:.6f} vs naive ratio {naive:.6f} "
          f"(the JY convexity correction)")
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)
    sim = JarrowYildirimSimulation(jy, td, num_paths=num_paths, seed=3,
                                   device=device)
    mc, se = sim.mc_yoy_forward(4.0, 5.0)
    print(f"[infl]  exact MC confirms: {mc:.6f} +- {se:.6f}")
    caplets = {}
    for strike in (0.01, 0.03):
        an = jy.yoy_caplet(4.0, 5.0, strike)
        mc_c, se_c = sim.mc_yoy_caplet(4.0, 5.0, strike)
        caplets[strike] = (float(an), mc_c, se_c)
        print(f"[infl]  YoY caplet k={strike:.0%}: analytic {an:.6f} "
              f"MC {mc_c:.6f} +- {se_c:.6f}")
    return {"zcis": zcis, "yoy_swap": float(k), "yoy_forward": float(yoy),
            "naive": naive, "mc_yoy": (mc, se), "caplets": caplets}


def commodity(device, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models import (SchwartzSmithModel,
                                          SchwartzSmithSimulation,
                                          TimeDiscretization)

    m = SchwartzSmithModel(chi0=0.1, xi0=math.log(60.0), kappa=1.5,
                           sigma_chi=0.35, sigma_xi=0.15, rho=0.3,
                           mu_star=0.01, lambda_chi=0.05)
    mats = np.array([0.25, 0.5, 1.0, 2.0, 5.0])
    futures = [float(m.futures_price(T)) for T in mats]
    print("[cmdty] futures curve:",
          ", ".join(f"{T}y {f:.2f}" for T, f in zip(mats, futures)))
    # Samuelson: near futures are the most volatile
    vols = [math.sqrt(m.log_futures_variance(0.25, 0.25 + u) / 0.25)
            for u in (0.0, 1.0, 4.0)]
    print("[cmdty] 3m-horizon futures vols by maturity gap 0/1/4y: "
          + "/".join(f"{v:.1%}" for v in vols) + " (Samuelson)")
    td = TimeDiscretization(initial=0.0, num_steps=24, step=1 / 12)
    sim = SchwartzSmithSimulation(m, td, num_paths=num_paths, seed=2,
                                  device=device)
    pr, se = sim.mc_option_on_future(1.0, 2.0, [55.0, 65.0], 0.97)
    black = []
    for k, p, s in zip((55.0, 65.0), pr, se):
        black.append(float(m.option_on_future(1.0, 2.0, k, 0.97)))
        print(f"[cmdty] option on F(1,2) K={k}: MC {p:.4f} +- {s:.4f} "
              f"vs Black {black[-1]:.4f}")
    sp, spe = sim.mc_calendar_spread(1.0, 1.5, 2.0, 0.0, 0.97)
    margrabe = float(m.calendar_spread_margrabe(1.0, 1.5, 2.0, 0.97))
    print(f"[cmdty] calendar spread (1.5y vs 2y): MC {sp:.4f} +- "
          f"{spe:.4f} vs Margrabe {margrabe:.4f}")
    return {"futures": futures, "vols": vols, "options": np.asarray(pr),
            "option_stderr": np.asarray(se), "black": black,
            "spread": (sp, spe), "margrabe": margrabe}


def risk(device, num_scenarios=PATHS) -> dict:
    from finmath_tpu_torch.models import (MarketRiskEngine, OptionBook,
                                          kupiec_pvalue)

    book = OptionBook(spots=[100.0, 50.0], rate=0.02,
                      underlying_index=[0, 0, 1, 1],
                      strikes=[100.0, 110.0, 50.0, 45.0],
                      expiries=[0.5, 1.0, 0.25, 1.0],
                      vols=[0.2, 0.22, 0.3, 0.28],
                      notionals=[100.0, -50.0, 80.0, 40.0],
                      is_call=[True, True, True, False])
    cov = np.array([[0.04, 0.012], [0.012, 0.09]])
    eng = MarketRiskEngine(book, horizon=1 / 252, device=device)
    rep = eng.parametric_mc(cov, num_scenarios=num_scenarios, quantile=0.99,
                            seed=5, vol_covariance=np.diag([0.5, 0.5]))
    print(f"[risk]  1-day VaR99 {rep.var:.2f} +- {rep.stderr_var:.2f}, "
          f"ES {rep.expected_shortfall:.2f} (full revaluation, spot+vol "
          "shocks)")
    names = ["call 100", "call 110 (short)", "call 50", "put 45"]
    for n, c in zip(names, rep.component_es):
        print(f"[risk]    ES component {n}: {c:+.2f}")
    dn = eng.delta_normal_var(cov, 0.99)
    print(f"[risk]  delta-normal control {dn:.2f} (long-gamma book "
          "prices below it)")
    p_value = kupiec_pvalue(10, 1000, 0.99)
    print(f"[risk]  Kupiec p-value for 10 breaches / 1000 days: "
          f"{p_value:.3f} (model accepted)")
    return {"var": rep.var, "stderr_var": rep.stderr_var,
            "es": rep.expected_shortfall,
            "component_es": np.asarray(rep.component_es),
            "delta_normal": float(dn), "kupiec": float(p_value)}


def main(num_paths: int = PATHS, device=None) -> dict:
    """Jarrow-Yildirim, Schwartz-Smith and market risk in the JAX
    script's order on ``device`` (default: the CUDA card), each with its
    wall; returns what each printed and the walls."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    out, walls = {}, {}
    for name, step in (("inflation", inflation), ("commodity", commodity),
                       ("risk", risk)):
        t0 = time.perf_counter()
        out[name] = step(device, num_paths)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls[name] = time.perf_counter() - t0
        print(f"--- {name}: {walls[name]:.1f} s\n")
    out["walls"] = walls
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
