"""Exotic products: path-dependent payoffs (digital, Asian, barrier,
lookback) on an equity facade, multi-asset rainbows (exchange, best-of
and worst-of, basket, spread) on the correlated Black-Scholes facade,
and the SABR smile (Hagan vols, Monte Carlo, calibration).

Run: python finmath_tpu_torch/examples/10_exotics_and_rainbows.py [--cpu]

Counterpart of ``examples/10_exotics_and_rainbows.py``. Each product's
value and standard error stay on the device as one packed pair until one
copy; each is held against an independent closed form or a same-stream
no-arbitrage identity. Each wall is the second of two calls, read after
the device's queue has drained.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import time  # noqa: E402

import numpy as np  # noqa: E402

S0, R, SIG, T = 100.0, 0.05, 0.3, 1.0
N_PATHS = 500_000


def timed(device, fn):
    """``fn()`` and the wall of its second call in milliseconds."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def path_dependent(device, num_paths=N_PATHS) -> dict:
    from finmath_tpu_torch.models import (AsianOption, BarrierOption,
                                          DigitalOption, LookbackOption)
    from finmath_tpu_torch.models.analytic import (
        barrier_option_value, digital_option_value,
        geometric_asian_option_value, lookback_floating_strike_value)
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, EuropeanOption, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    n = 250
    td = TimeDiscretization(initial=0.0, num_steps=n, step=T / n)
    sim = MonteCarloBlackScholesModel(td, num_paths,
                                      BlackScholesModel(S0, R, SIG),
                                      seed=42, device=device)
    out = {}

    (v, e), ms = timed(device, lambda: DigitalOption(T, 105.0)
                       .get_value_and_error(sim))
    cf = digital_option_value(S0, R, SIG, T, 105.0)
    out["digital"] = (v, e, cf)
    print(f"[digital]   {v:.5f} +- {e:.5f}   closed form {cf:.5f}   "
          f"{ms:.0f} ms")

    dates = [round((i + 1) * T / 12 / (T / n)) * (T / n) for i in range(12)]
    (vp, ep), _ = timed(device, lambda: AsianOption(dates, 100.0)
                        .get_value_and_error(sim))
    (vc, ec), ms = timed(device, lambda: AsianOption(
        dates, 100.0, control_variate="geometric").get_value_and_error(sim))
    geo = geometric_asian_option_value(S0, R, SIG, dates, 100.0)
    out["asian"] = (vp, ep, vc, ec, geo)
    print(f"[asian]     plain {vp:.4f} +- {ep:.4f}  |  geometric-CV "
          f"{vc:.4f} +- {ec:.4f}  ({ep/ec:.0f}x stderr reduction, "
          f"geo oracle {geo:.4f})   {ms:.0f} ms")

    (v, e), ms = timed(device, lambda: BarrierOption(
        T, 100.0, 130.0, "up-out", monitoring="bridge")
        .get_value_and_error(sim))
    an = barrier_option_value(S0, R, SIG, T, 100.0, 130.0, "up-out")
    out["barrier"] = (v, e, an)
    print(f"[barrier]   up-out bridge {v:.5f} +- {e:.5f}   continuous "
          f"closed form {an:.5f}   {ms:.0f} ms")
    vi = BarrierOption(T, 100.0, 130.0, "up-in").get_value(sim)
    vo = BarrierOption(T, 100.0, 130.0, "up-out").get_value(sim)
    ve = EuropeanOption(T, 100.0).get_value(sim)
    out["parity"] = (vi, vo, ve)
    print(f"            same-stream in+out parity: {vi+vo:.6f} vs "
          f"vanilla {ve:.6f}")

    (v, e), ms = timed(device, lambda: LookbackOption(T, "floating-call")
                       .get_value_and_error(sim))
    an = lookback_floating_strike_value(S0, R, SIG, T, True)
    out["lookback"] = (v, e, an)
    print(f"[lookback]  floating call {v:.4f} +- {e:.4f}   continuous "
          f"GSG {an:.4f} (discrete < continuous by ~beta1*sig*sqrt(dt)*S)"
          f"   {ms:.0f} ms")
    out["model"] = sim
    return out


def rainbows(device, num_paths=N_PATHS) -> dict:
    from finmath_tpu_torch.models import (
        BasketOption, ExchangeOption, MonteCarloMultiAssetBlackScholesModel,
        MultiAssetBlackScholesModel, RainbowOption, SpreadOption)
    from finmath_tpu_torch.models.multi_asset import (
        geometric_basket_option_value, kirk_spread_approximation,
        margrabe_exchange_value, stulz_rainbow_value)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    s0 = [100.0, 95.0, 105.0]
    vols = [0.25, 0.35, 0.2]
    corr = [[1.0, 0.4, 0.2], [0.4, 1.0, 0.5], [0.2, 0.5, 1.0]]
    t = 1.5
    td = TimeDiscretization(initial=0.0, num_steps=30, step=t / 30)
    sim = MonteCarloMultiAssetBlackScholesModel(
        td, num_paths, MultiAssetBlackScholesModel(s0, R, vols, corr),
        seed=11, device=device)
    out = {}

    (v, e), ms = timed(device, lambda: ExchangeOption(t, 0, 1)
                       .get_value_and_error(sim))
    an = margrabe_exchange_value(s0[0], s0[1], vols[0], vols[1], 0.4, t)
    out["exchange"] = (v, e, an)
    print(f"[exchange]  S1 for S2: {v:.4f} +- {e:.4f}   Margrabe "
          f"{an:.4f}   {ms:.0f} ms")

    (v, e), ms = timed(device, lambda: RainbowOption(
        t, 100.0, "call-on-min", asset_indices=[0, 1])
        .get_value_and_error(sim))
    an = stulz_rainbow_value(s0[0], s0[1], R, vols[0], vols[1], 0.4, t,
                             100.0, "call-on-min")
    out["call_on_min"] = (v, e, an)
    print(f"[rainbow]   call-on-min(2): {v:.4f} +- {e:.4f}   Stulz "
          f"{an:.4f}   {ms:.0f} ms")
    v3 = RainbowOption(t, 100.0, "call-on-max").get_value(sim)
    out["call_on_max"] = v3
    print(f"            call-on-max over all 3 assets: {v3:.4f}")

    w = [0.4, 0.3, 0.3]
    (v, e), ms = timed(device, lambda: BasketOption(
        t, w, 100.0, control_variate="geometric").get_value_and_error(sim))
    geo = geometric_basket_option_value(s0, R, vols, corr, w, t, 100.0)
    out["basket"] = (v, e, geo)
    print(f"[basket]    arithmetic w/ geometric CV: {v:.4f} +- {e:.4f}"
          f"   (geo oracle {geo:.4f})   {ms:.0f} ms")

    (v, e), ms = timed(device, lambda: SpreadOption(t, 10.0)
                       .get_value_and_error(sim))
    kirk = kirk_spread_approximation(s0[0], s0[1], R, vols[0], vols[1], 0.4,
                                     t, 10.0)
    out["spread"] = (v, e, kirk)
    print(f"[spread]    K=10: {v:.4f} +- {e:.4f}   Kirk approx "
          f"{kirk:.4f}   {ms:.0f} ms")
    return out


def sabr(device, num_paths=N_PATHS) -> dict:
    from finmath_tpu_torch.models import (SABRParams, calibrate_sabr,
                                          mc_sabr_implied_vols,
                                          sabr_lognormal_implied_volatility)

    f, t = 0.03, 2.0
    p = SABRParams(alpha=0.035, beta=0.5, rho=-0.3, nu=0.4)
    ks = np.array([0.02, 0.025, 0.03, 0.04])
    hagan = [sabr_lognormal_implied_volatility(p, f, k, t) for k in ks]
    mc, ms = timed(device, lambda: mc_sabr_implied_vols(
        p, f, t, ks, num_paths=num_paths, num_steps=64, seed=5,
        device=device))
    print(f"[sabr]      Hagan  {np.round(hagan, 4)}")
    print(f"            MC     {np.round(mc, 4)}   ({ms:.0f} ms)")
    fit = calibrate_sabr(f, t, ks, mc, beta=0.5)
    print(f"            refit of the MC smile: alpha {fit.params.alpha:.4f} "
          f"rho {fit.params.rho:+.3f} nu {fit.params.nu:.3f} "
          f"(true 0.035 / -0.300 / 0.400), rms {fit.rms_vol_error:.1e}")
    return {"hagan": np.asarray(hagan), "mc": np.asarray(mc),
            "fit": (fit.params.alpha, fit.params.rho, fit.params.nu),
            "fit_rms": fit.rms_vol_error}


def main(num_paths: int = N_PATHS, device=None) -> dict:
    """The path-dependent set, the rainbows and SABR in the JAX script's
    order on ``device`` (default: the CUDA card); returns what each
    printed."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    print(f"devices: [{device}] ({name})\n")
    out = {"path_dependent": path_dependent(device, num_paths)}
    print()
    out["rainbows"] = rainbows(device, num_paths)
    print()
    out["sabr"] = sabr(device, num_paths)
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
