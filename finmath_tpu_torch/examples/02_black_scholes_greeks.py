"""Monte-Carlo Black-Scholes pricing and greeks, three ways.

Run: python finmath_tpu_torch/examples/02_black_scholes_greeks.py [--cpu]

Counterpart of ``examples/02_black_scholes_greeks.py``:

1. the finmath-style object API (model + Euler scheme + product),
2. the fused pricer: on the card one launch of the hand-written path
   kernel (``ops.kernels.mc_european_call_price_kernel``, Philox and the
   whole Euler loop in the kernel), on the CPU its plain version,
3. greeks by ``torch.autograd`` through the differentiable pricer (the
   counterpart of the JAX package's ``_mc_bs_price_kernel`` under
   ``jax.grad``) and by the eager AAD tape.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import math  # noqa: E402

import numpy as np  # noqa: E402

S0, R, SIGMA, T, K = 1.0, 0.05, 0.30, 1.0, 1.05


def main(object_paths: int = 200_000, fused_paths: int = 1_000_000,
         greek_paths: int = 500_000, device=None) -> dict:
    """The three pricings and the greeks on ``device`` (default: the CUDA
    card); returns the prices and the deltas."""
    import torch

    from finmath_tpu_torch.models.analytic import black_scholes_option_value
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, EuropeanOption, MonteCarloBlackScholesModel,
        mc_european_call_price_differentiable)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    from finmath_tpu_torch.ops.aad import RandomVariableDifferentiable
    from finmath_tpu_torch.ops.kernels import mc_european_call_price_kernel
    from finmath_tpu_torch.ops.random_variable import RandomVariableTorch
    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    analytic = black_scholes_option_value(S0, R, SIGMA, T, K)

    # 1. object API (the reference's MonteCarloBlackScholesModelTest shape)
    td = TimeDiscretization(initial=0.0, num_steps=100, step=T / 100)
    sim = MonteCarloBlackScholesModel(td, object_paths,
                                      BlackScholesModel(S0, R, SIGMA),
                                      device=device)
    v_obj = EuropeanOption(T, K).get_value(sim)

    # 2. fused pricer (1M paths x 100 steps in one kernel launch)
    v_fused = mc_european_call_price_kernel(
        seed=3141, num_paths=fused_paths, num_steps=100, initial_value=S0,
        risk_free_rate=R, volatility=SIGMA, maturity=T, strike=K,
        device=device)
    print(f"analytic {analytic:.6f} | object API {v_obj:.6f} | fused {v_fused:.6f}")
    assert abs(v_obj - analytic) < 0.005 and abs(v_fused - analytic) < 0.005

    # 3a. greeks by torch.autograd through the differentiable pricer
    s0 = torch.tensor(S0, dtype=torch.float64, device=device,
                      requires_grad=True)
    sigma = torch.tensor(SIGMA, dtype=torch.float64, device=device,
                         requires_grad=True)
    price = mc_european_call_price_differentiable(
        0, greek_paths, 50, s0, R, sigma, T, K, device=device)
    delta, vega = torch.autograd.grad(price, (s0, sigma))
    print(f"autograd:  delta {float(delta):.4f}  vega {float(vega):.4f}")

    # 3b. eager AAD tape (finmath RandomVariableDifferentiableAAD style)
    z = np.random.default_rng(0).standard_normal(greek_paths).astype(
        np.float32)
    growth = RandomVariableTorch(0.0, np.exp(
        (R - SIGMA**2 / 2) * T + SIGMA * math.sqrt(T) * z).astype(np.float32),
        device=device)
    s0_tape = RandomVariableDifferentiable(RandomVariableTorch(0.0, S0),
                                           device=device)
    v = s0_tape.mult(growth).sub(K).floor(0.0).mult(math.exp(-R * T)) \
        .average()
    delta_aad = v.get_gradient([s0_tape])[s0_tape.get_id()].double_value()
    print(f"AAD tape:  delta {delta_aad:.4f}")
    assert abs(delta_aad - float(delta)) < 0.02
    return {"analytic": analytic, "object": v_obj, "fused": v_fused,
            "delta": float(delta), "vega": float(vega),
            "delta_aad": delta_aad}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
