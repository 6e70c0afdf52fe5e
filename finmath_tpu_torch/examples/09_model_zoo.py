"""Model-family zoo: Heston, Bates, Heston-SLV, Merton, Variance-Gamma,
Bachelier and displaced lognormal, Hull-White and an American put by
Longstaff-Schwartz, each priced by Monte Carlo beside a host float64
analytic oracle.

Run: python finmath_tpu_torch/examples/09_model_zoo.py [--cpu]

Counterpart of ``examples/09_model_zoo.py``. Each wall is the second of
two calls (the first builds and warms), read after the device's queue
has drained.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import math  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

STRIKES = np.array([80.0, 90.0, 100.0, 110.0, 125.0])


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def timed(on, fn, *args, **kw):
    """``fn``'s result and the wall of its second call on device ``on``,
    in seconds."""
    fn(*args, **kw)                       # build and warm
    _sync(on)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(on)
    return out, time.perf_counter() - t0


def heston(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models import (HestonParams, calibrate_heston,
                                          heston_characteristic_prices,
                                          mc_heston_european_prices)
    p = HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05,
                     xi=0.6, rho=-0.7)
    ref = heston_characteristic_prices(p, 1.5, STRIKES)
    (px, fwd, _), wall = timed(device, mc_heston_european_prices, p, 1.5,
                               STRIKES, num_paths=num_paths, num_steps=64,
                               scheme="qe", antithetic=True, device=device)
    dev = float(np.abs(px - ref).max() / ref.min())
    print(f"[heston]   QE-M {num_paths // 1000}k x 64: {wall*1e3:6.0f} ms   "
          f"max rel dev vs CF {dev:.2e}   fwd err {fwd - 100:+.3f}")
    res = calibrate_heston(100.0, 0.03, [0.5, 1.5], [STRIKES, STRIKES],
                           [heston_characteristic_prices(p, t, STRIKES)
                            for t in (0.5, 1.5)])
    print(f"[heston]   surface calibration: rms {res.rms_price_error:.2e} "
          f"in {res.iterations} LM iterations")
    return {"prices": np.asarray(px), "cf": ref, "rel_dev": dev,
            "forward": float(fwd), "wall_s": wall,
            "calibration_rms": res.rms_price_error,
            "calibration_iterations": res.iterations}


def merton(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models import (MertonParams,
                                          mc_merton_european_prices,
                                          merton_series_prices)
    p = MertonParams(100.0, 0.05, 0.2, jump_intensity=0.6,
                     jump_size_mean=-0.15, jump_size_std=0.25)
    ref = merton_series_prices(p, 1.0, STRIKES)
    (px, fwd), wall = timed(device, mc_merton_european_prices, p, 1.0,
                            STRIKES, num_paths=num_paths, num_steps=16,
                            antithetic=True, device=device)
    dev = float(np.abs(px - ref).max() / ref.min())
    print(f"[merton]   jump-diffusion {num_paths // 1000}k x 16: "
          f"{wall*1e3:6.0f} ms   max rel dev vs series {dev:.2e}")
    return {"prices": np.asarray(px), "series": ref, "rel_dev": dev,
            "wall_s": wall}


def variance_gamma(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models import (VarianceGammaParams,
                                          mc_vg_european_prices,
                                          vg_analytic_prices)
    p = VarianceGammaParams(100.0, 0.04, sigma=0.18, theta=-0.14, nu=0.25)
    ref = vg_analytic_prices(p, 1.25, STRIKES)
    (px, fwd), wall = timed(device, mc_vg_european_prices, p, 1.25, STRIKES,
                            num_paths=num_paths, num_steps=16,
                            antithetic=True, device=device)
    dev = float(np.abs(px - ref).max() / ref.min())
    print(f"[vg]       gamma-subordinated {num_paths // 1000}k x 16: "
          f"{wall*1e3:6.0f} ms   max rel dev vs Fourier {dev:.2e}")
    return {"prices": np.asarray(px), "fourier": ref, "rel_dev": dev,
            "wall_s": wall}


def bachelier_and_displaced(device, num_paths=2_000_000) -> dict:
    from finmath_tpu_torch.models import (BachelierParams,
                                          DisplacedLognormalParams,
                                          bachelier_analytic_price,
                                          displaced_analytic_price,
                                          mc_bachelier_european_prices,
                                          mc_displaced_european_prices)
    b = BachelierParams(100.0, 0.03, volatility=15.0)
    ks = np.array([-20.0, 80.0, 100.0, 120.0])     # negative strike
    (px_b, _), wall_b = timed(device, mc_bachelier_european_prices, b, 1.25,
                              ks, num_paths=num_paths, antithetic=True,
                              device=device)
    ref_b = bachelier_analytic_price(b, 1.25, ks)
    dev_b = float(np.abs(px_b - ref_b).max())
    print(f"[bachelier] exact-terminal {num_paths / 1e6:g}M: "
          f"{wall_b*1e3:6.0f} ms   max abs dev {dev_b:.4f} "
          "(incl. strike -20)")
    d = DisplacedLognormalParams(100.0, 0.03, 0.2, displacement=30.0)
    (px_d, _), wall_d = timed(device, mc_displaced_european_prices, d, 1.25,
                              STRIKES, num_paths=num_paths, antithetic=True,
                              device=device)
    ref_d = displaced_analytic_price(d, 1.25, STRIKES)
    dev_d = float((np.abs(px_d - ref_d) / ref_d).max())
    print(f"[displaced] shifted-Black {num_paths / 1e6:g}M: "
          f"{wall_d*1e3:6.0f} ms   max rel dev {dev_d:.2e}")
    return {"bachelier": np.asarray(px_b), "bachelier_analytic": ref_b,
            "bachelier_abs_dev": dev_b, "displaced": np.asarray(px_d),
            "displaced_analytic": ref_d, "displaced_rel_dev": dev_d,
            "wall_s": (wall_b, wall_d)}


def hull_white(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models import HullWhiteModel, HullWhiteSimulation
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    pil = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 15.0, 20.0])
    zeros = np.array([0.010, 0.012, 0.015, 0.017, 0.020, 0.022, 0.024,
                      0.025, 0.0255])
    curve = DiscountCurve(list(pil), list(np.exp(-zeros * pil)))
    m = HullWhiteModel(curve, 0.12, [0.010, 0.014, 0.008],
                       vol_times=[0.0, 2.0, 5.0])
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)
    sim = HullWhiteSimulation(m, td, num_paths=num_paths, seed=7,
                              antithetic=True, device=device)
    got = sim.mc_bond_price(10.0)
    want = float(m.df(10.0))
    pts = [3.0, 3.5, 4.0, 4.5, 5.0]
    mc, wall = timed(device, sim.mc_swaption_price, 2.0, pts, 0.02)
    an = m.swaption(2.0, pts, 0.02)
    print(f"[hullwhite] curve fit E[1/N(10y)]: rel {(got-want)/want:+.1e}"
          f"   swaption MC vs Jamshidian: rel "
          f"{(mc-an)/an:+.1e} ({wall*1e3:.0f} ms)")
    return {"bond": float(got), "df": want, "swaption": float(mc),
            "jamshidian": float(an), "wall_s": wall}


def american(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models import BermudanOption, crr_american_price
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    td = TimeDiscretization(initial=0.0, num_steps=50, step=0.02)
    sim = MonteCarloBlackScholesModel(td, num_paths,
                                      BlackScholesModel(100.0, 0.05, 0.3),
                                      seed=77, device=device)
    opt = BermudanOption([i * 0.02 for i in range(1, 51)], 110.0,
                         is_call=False)
    (v, err), wall = timed(device, opt.get_value_and_error, sim)
    crr = crr_american_price(100.0, 0.05, 0.3, 1.0, 110.0, is_call=False)
    print(f"[american] LS put {num_paths // 1000}k x 50 dates: "
          f"{wall*1e3:6.0f} ms   LS {v:.4f}+-{err:.4f} vs CRR {crr:.4f}")
    return {"value": v, "stderr": err, "crr": crr, "wall_s": wall}


def bates(device, num_paths=500_000) -> dict:
    from finmath_tpu_torch.models import (BatesParams,
                                          bates_characteristic_prices,
                                          mc_bates_european_prices)
    p = BatesParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05,
                    xi=0.6, rho=-0.7, jump_intensity=0.6,
                    jump_size_mean=-0.12, jump_size_std=0.18)
    cf = bates_characteristic_prices(p, 1.5, STRIKES)
    (px, fwd, _), wall = timed(device, mc_bates_european_prices, p, 1.5,
                               STRIKES, num_paths=num_paths, num_steps=96,
                               antithetic=True, device=device)
    dev = float(np.abs(px / cf - 1).max())
    print(f"[bates]    SVJ MC {num_paths // 1000}k x 96:      "
          f"{wall*1e3:6.0f} ms   max |MC/CF-1| {dev:.2e}  fwd dev "
          f"{fwd-100.0:+.3f}")
    return {"prices": np.asarray(px), "cf": cf, "rel_dev": dev,
            "forward": float(fwd), "wall_s": wall}


def slv(device, num_paths=200_000) -> dict:
    from finmath_tpu_torch.models import (HestonParams, HestonSLVModel,
                                          MonteCarloHestonSLVModel)
    from finmath_tpu_torch.models.analytic import black_implied_volatility
    from finmath_tpu_torch.models.local_vol import (SSVISurface,
                                                    european_call_values)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    surf = SSVISurface(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65,
                       eta=0.6, gamma=0.4)
    hp = HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.06,
                      xi=0.8, rho=-0.7)
    td = TimeDiscretization(initial=0.0, num_steps=100, step=0.01)
    model = HestonSLVModel(hp, surf, td)
    seeds = iter(range(31, 40))

    def run():
        mc = MonteCarloHestonSLVModel(td, num_paths, model,
                                      seed=next(seeds), device=device)
        return european_call_values(mc, [90.0, 100.0, 110.0], [1.0])

    out, wall = timed(device, run)
    fwd, df = 100.0 * math.exp(0.03), math.exp(-0.03)
    devs = [black_implied_volatility(fwd, k, 1.0, out[0, j, 0] / df)
            - float(surf.implied_volatility(np.log(k / fwd), 1.0))
            for j, k in enumerate([90.0, 100.0, 110.0])]
    worst_bp = max(abs(d) for d in devs) * 1e4
    print(f"[slv]      particle {num_paths // 1000}k x 100:   "
          f"{wall*1e3:6.0f} ms   smile round-trip max |dIV| "
          f"{worst_bp:.0f} bp (vol-of-vol on)")
    return {"calls": np.asarray(out), "iv_devs": devs, "max_dev_bp": worst_bp,
            "wall_s": wall}


def _device_line(device) -> str:
    import torch

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    return f"devices: [{device}] ({name})"


def main(num_paths: int = 500_000, gaussian_paths: int = 2_000_000,
         slv_paths: int = 200_000, device=None) -> dict:
    """The zoo in the JAX script's order on ``device`` (default: the CUDA
    card): ``num_paths`` for Heston, Bates, Merton, VG, Hull-White and the
    American put, ``gaussian_paths`` for Bachelier and the displaced
    model, ``slv_paths`` for SLV; returns what each printed."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    print(_device_line(device))
    return {"heston": heston(device, num_paths),
            "bates": bates(device, num_paths),
            "slv": slv(device, slv_paths),
            "merton": merton(device, num_paths),
            "variance_gamma": variance_gamma(device, num_paths),
            "bachelier_displaced": bachelier_and_displaced(device,
                                                           gaussian_paths),
            "hull_white": hull_white(device, num_paths),
            "american": american(device, num_paths)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
