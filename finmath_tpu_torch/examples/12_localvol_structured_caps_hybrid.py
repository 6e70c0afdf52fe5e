"""Dupire local volatility from an SSVI surface, autocallable notes,
target redemption notes on Hull-White, caplet-volatility stripping, and
the hybrid asset-LMM (equity, FX and quanto under stochastic rates).

Run: python finmath_tpu_torch/examples/12_localvol_structured_caps_hybrid.py [--cpu]

Counterpart of ``examples/12_localvol_structured_caps_hybrid.py``. Each
part prints its wall, read after the device's queue has drained. Local
vol is bound by the host: each step evaluates the Dupire formula by
nested forward-mode derivatives, some tens of microseconds of dispatch
an operation.
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


def local_vol(device, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models.analytic import black_implied_volatility
    from finmath_tpu_torch.models.local_vol import (
        LocalVolatilityModel, MonteCarloLocalVolModel, SSVISurface,
        european_call_values)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    surf = SSVISurface(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65,
                       eta=1.2)
    surf.validate(t_max=3.0)          # calendar and butterfly arbitrage
    td = TimeDiscretization(initial=0.0, num_steps=100, step=0.01)
    model = LocalVolatilityModel(100.0, 0.03, surf, td)
    mc = MonteCarloLocalVolModel(td, num_paths, model, seed=7, device=device)
    strikes = [80.0, 90.0, 100.0, 110.0, 120.0]
    out = np.asarray(european_call_values(mc, strikes, [1.0]))
    fwd, df = 100.0 * math.exp(0.03), math.exp(-0.03)
    print("[local vol] strike   SSVI-in   MC-round-trip")
    rows = []
    for j, k in enumerate(strikes):
        iv = black_implied_volatility(fwd, k, 1.0, float(out[0, j, 0]) / df)
        target = float(surf.implied_volatility(math.log(k / fwd), 1.0))
        rows.append((k, target, iv))
        print(f"[local vol] {k:6.1f}   {target:.4f}    {iv:.4f}"
              f"   ({abs(iv - target) * 1e4:.1f} bp)")
    return {"calls": out, "rows": rows}


def structured(device, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.structured_products import (
        AutocallableNote, autocallable_value_single_observation)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    td = TimeDiscretization(initial=0.0, num_steps=10, step=0.1)
    sim = MonteCarloBlackScholesModel(td, num_paths,
                                      BlackScholesModel(100.0, 0.03, 0.25),
                                      seed=31, device=device)
    note = AutocallableNote(observation_dates=[0.5, 1.0],
                            autocall_levels=[105.0, 100.0],
                            coupons=[0.05, 0.08], protection_level=70.0)
    v, e = note.get_value_and_error(sim)
    an = autocallable_value_single_observation(
        100.0, 0.03, 0.25, 0.5, 1.0, autocall_level=105.0, coupon1=0.05,
        final_coupon_level=100.0, final_coupon=0.08, protection_level=70.0)
    print(f"[autocall]  MC {v:.5f} +- {e:.5f} vs bivariate closed {an:.5f}")

    memory = AutocallableNote(
        observation_dates=[0.2, 0.4, 0.6, 1.0],
        autocall_levels=[110.0] * 4, coupon_levels=[85.0] * 4,
        coupons=[0.02] * 4, protection_level=60.0, memory=True)
    v_mem, _ = memory.get_value_and_error(sim)
    print(f"[autocall]  4-date memory-coupon note: {v_mem:.5f}")
    return {"value": v, "stderr": e, "closed_form": an, "memory": v_mem}


def tarn(device, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.hull_white import (HullWhiteModel,
                                                     HullWhiteSimulation)
    from finmath_tpu_torch.models.tarn import (TargetRedemptionNote,
                                               inverse_floater_value)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    ts = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
    zr = np.array([0.012, 0.014, 0.017, 0.019, 0.022, 0.024, 0.026])
    curve = DiscountCurve(list(ts), list(np.exp(-zr * ts)))
    model = HullWhiteModel(curve, 0.10, 0.011)
    td = TimeDiscretization(initial=0.0, num_steps=9, step=0.5)
    sim = HullWhiteSimulation(model, td, num_paths=num_paths, seed=13,
                              antithetic=True, device=device)
    fix = [0.5 * i for i in range(1, 9)]
    pay = [f + 0.5 for f in fix]
    uncapped = TargetRedemptionNote(fix, pay, 0.045, target=float("inf"),
                                    multiplier=2.0)
    v, e = uncapped.get_value_and_error(sim)
    an = inverse_floater_value(model, fix, pay, 0.045, multiplier=2.0)
    print(f"[TARN]      uncapped MC {v:.6f} +- {e:.1e} vs floorlet "
          f"portfolio {an:.6f}")
    targets = {}
    for tgt in (0.10, 0.05, 0.02):
        vt, _ = TargetRedemptionNote(fix, pay, 0.045, target=tgt,
                                     multiplier=2.0).get_value_and_error(sim)
        targets[tgt] = vt
        print(f"[TARN]      target {tgt:.2f}: {vt:.6f}")
    return {"uncapped": v, "stderr": e, "inverse_floater": float(an),
            "targets": targets}


def caps() -> dict:
    from finmath_tpu_torch.models.caps import (
        cap_value, implied_flat_cap_volatility, make_cap_schedule,
        strip_caplet_volatilities)
    from finmath_tpu_torch.models.curves import DiscountCurve, ForwardCurve

    ts = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 12.0])
    zr = np.array([0.015, 0.017, 0.020, 0.022, 0.025, 0.027, 0.029, 0.030])
    dc = DiscountCurve(list(ts), list(np.exp(-zr * ts)))
    fc = ForwardCurve(dc, payment_offset=0.5)
    mats = np.array([1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
    flats = np.array([0.44, 0.41, 0.37, 0.31, 0.27, 0.24])
    t0 = time.perf_counter()
    curve = strip_caplet_volatilities(dc, fc, mats, flats, 0.03, 0.5)
    wall = (time.perf_counter() - t0) * 1e3
    print(f"[caps]      stripped {len(mats)} maturities in {wall:.1f} ms "
          f"(host f64): {np.round(curve.volatilities, 4)}")
    repriced = []
    for m, f in zip(mats[:3], flats[:3]):
        fx = make_cap_schedule(float(m), 0.5)
        tgt = cap_value(dc, fc, fx, 0.5, 0.03, float(f))
        got = cap_value(dc, fc, fx, 0.5, 0.03,
                        curve.get_caplet_volatility(fx))
        iv = implied_flat_cap_volatility(got, dc, fc, fx, 0.5, 0.03)
        repriced.append((float(iv), float(abs(got - tgt))))
        print(f"[caps]      {m:4.1f}Y cap: quote {f:.2%} -> repriced flat "
              f"vol {iv:.2%} (price dev {abs(got - tgt):.2e})")
    return {"volatilities": np.asarray(curve.volatilities),
            "repriced": repriced}


def hybrid(device, num_paths=PATHS) -> dict:
    from finmath_tpu_torch.models.analytic import black_formula
    from finmath_tpu_torch.models.caps import (
        CapletVolatilityCurve, LIBORVolatilityModelFromCapletCurve)
    from finmath_tpu_torch.models.curves import DiscountCurve, ForwardCurve
    from finmath_tpu_torch.models.lmm.covariance import (
        LIBORCorrelationModelExponentialDecay,
        LIBORCovarianceModelFromVolatilityAndCorrelation)
    from finmath_tpu_torch.models.lmm.hybrid import HybridAssetLMM
    from finmath_tpu_torch.models.lmm.model import LIBORMarketModelTorch
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    ts = np.array([0.5, 1.0, 2.0, 3.0, 5.0])
    zr = np.array([0.045, 0.047, 0.050, 0.051, 0.052])
    dc = DiscountCurve(list(ts), list(np.exp(-zr * ts)))
    fc = ForwardCurve(dc, payment_offset=0.5)
    td = TimeDiscretization(initial=0.0, num_steps=10, step=0.5)
    vm = LIBORVolatilityModelFromCapletCurve(
        td, td, CapletVolatilityCurve([5.0], [0.40]))
    cov = LIBORCovarianceModelFromVolatilityAndCorrelation(
        vm, LIBORCorrelationModelExponentialDecay(td, 1))
    model = LIBORMarketModelTorch(td, fc, dc, cov, measure="spot",
                                  state_space="lognormal")
    p0 = np.zeros(0)

    h = HybridAssetLMM(model, [100.0], [0.20], rate_correlations=[0.5],
                       num_paths=num_paths, num_factors=1, seed=11,
                       antithetic=True, device=device)
    v, se = h.european_option_value(p0, 6, 105.0)
    errs = h.martingale_errors(p0)
    worst = float(np.nanmax(np.abs(errs)))
    print(f"[hybrid]    equity call under stochastic rates (rho=0.5): "
          f"{v:.4f} +- {se:.4f}; max martingale err {worst:.1e}")

    tf = np.linspace(0, 5, 11)
    fc_f = DiscountCurve(list(tf[1:]), list(np.exp(-0.02 * tf[1:])))
    rho, sig_s, sig_x = 0.6, 0.25, 0.12
    hq = HybridAssetLMM(
        model, [1.25, 80.0], [sig_x, sig_s],
        dividend_yields=[fc_f, 0.01], growth_curves=[None, fc_f],
        quanto_fx_indices=[None, 0],
        equity_correlation=[[1.0, rho], [rho, 1.0]],
        num_paths=num_paths, num_factors=1, seed=29, antithetic=True,
        device=device)
    fx_fwd, se_fx = hq.forward_value(p0, 6, asset_index=0)
    fx_parity = 1.25 * math.exp(-0.02 * 3.0)
    print(f"[hybrid]    FX forward (covered interest parity): "
          f"{fx_fwd:.6f} vs {fx_parity:.6f}")
    vq, seq = hq.european_option_value(p0, 6, 82.0, asset_index=1)
    fq = 80.0 * math.exp((0.02 - 0.01 - rho * sig_s * sig_x) * 3.0)
    an = black_formula(fq, 82.0, sig_s, 3.0,
                       payoff_unit=float(dc.get_discount_factor(3.0)))
    print(f"[hybrid]    quanto call: MC {vq:.4f} +- {seq:.4f} vs closed "
          f"form {an:.4f}")
    return {"call": v, "call_stderr": se, "martingale": worst,
            "fx_forward": fx_fwd, "fx_stderr": se_fx, "fx_parity": fx_parity,
            "quanto": vq, "quanto_stderr": seq, "quanto_closed_form": an}


def main(num_paths: int = PATHS, device=None) -> dict:
    """Local vol, the autocallables, the TARN, the caps strip and the
    hybrid in the JAX script's order on ``device`` (default: the CUDA
    card), each with its wall; returns what each printed and the walls."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    steps = (("local_vol", lambda: local_vol(device, num_paths)),
             ("structured", lambda: structured(device, num_paths)),
             ("tarn", lambda: tarn(device, num_paths)),
             ("caps", caps),
             ("hybrid", lambda: hybrid(device, num_paths)))
    out, walls = {}, {}
    for name, step in steps:
        t0 = time.perf_counter()
        out[name] = step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls[name] = time.perf_counter() - t0
        print(f"--- {name}: {walls[name]:.1f} s\n")
    out["walls"] = walls
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
