"""Black-Scholes model under the Euler scheme, plus plain Monte-Carlo
pricers.

Counterpart of ``finmath_tpu.models.black_scholes``, the equivalent of
finmath-lib's ``BlackScholesModel`` + ``MonteCarloAssetModel`` as the
reference test drives them (MonteCarloBlackScholesModelTest.java:125-146):
Euler evolution of log S with drift r - sigma^2/2, payoff max(S-K, 0),
numeraire exp(r t).

Two API levels:

* ``BlackScholesModel`` + ``EulerScheme`` — the object API mirroring the
  reference's layering; and
* ``mc_european_call_price`` / ``mc_asian_call_price`` — one function from
  seed to price: a Python loop over the steps on the device, drawing each
  step's normals from a ``torch.Generator`` seeded with ``seed``, with a
  float64 mean. (The JAX package fuses the same into one XLA scan.) The
  hand-written path kernels behind the same prices are
  ``ops.kernels.mc_european_call_price_kernel`` and
  ``mc_asian_call_price_kernel``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..utils.config import select_device, to_device
from .brownian_motion import BrownianMotion, key_for_seed
from .process import EulerScheme, ProcessModel
from .time_discretization import TimeDiscretization


class BlackScholesModel(ProcessModel):
    """dS = r S dt + sigma S dW, evolved in log coordinates (LOGNORMAL
    state space, like finmath's BlackScholesModel)."""

    def __init__(self, initial_value: float, risk_free_rate: float,
                 volatility: float):
        self.initial_value = float(initial_value)
        self.risk_free_rate = float(risk_free_rate)
        self.volatility = float(volatility)

    def get_number_of_components(self) -> int:
        return 1

    def get_number_of_factors(self) -> int:
        return 1

    def initial_state(self, num_paths: int, device=None) -> torch.Tensor:
        return torch.full((1, num_paths), math.log(self.initial_value),
                          dtype=FLOAT_DTYPE, device=device)

    def drift(self, time_index, state) -> torch.Tensor:
        mu = self.risk_free_rate - 0.5 * self.volatility * self.volatility
        return torch.full_like(state, mu)

    def factor_loadings(self, time_index, state) -> torch.Tensor:
        return torch.full(state.shape[:1] + (1,) + state.shape[1:],
                          self.volatility, dtype=state.dtype,
                          device=state.device)

    def apply_state_space_transform(self, component: int,
                                    x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x)

    def numeraire(self, time: float) -> RandomVariableTorch:
        return RandomVariableTorch(time, math.exp(self.risk_free_rate * time))

    def __hash__(self):
        return hash((self.initial_value, self.risk_free_rate, self.volatility))

    def __eq__(self, other):
        return (
            isinstance(other, BlackScholesModel)
            and (self.initial_value, self.risk_free_rate, self.volatility)
            == (other.initial_value, other.risk_free_rate, other.volatility)
        )


class MonteCarloBlackScholesModel:
    """Simulation facade: model + Euler scheme + asset/numeraire accessors
    (the role of finmath's MonteCarloAssetModel). Without ``brownian``, the
    increments are drawn on ``device`` (default: the mesh's, else
    ``select_device()``) from ``seed``. ``mesh``: a ``parallel.PathMesh``
    (``EulerScheme``): each rank simulates its block of the same paths and
    the products' means and errors are global."""

    def __init__(self, time_discretization: TimeDiscretization, num_paths: int,
                 model: BlackScholesModel, seed: int = 3141,
                 brownian=None, mesh=None, device=None):
        if device is None and mesh is not None:
            device = getattr(mesh, "device", None)
        self.model = model
        self.brownian = brownian or BrownianMotion(
            time_discretization, 1, num_paths, seed, device=device
        )
        self.process = EulerScheme(model, self.brownian, mesh=mesh,
                                   device=device)
        self.mesh = self.process.mesh

    def get_asset_value(self, time: float, asset_index: int = 0) -> RandomVariableTorch:
        ti = self.process.time_discretization.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return self.process.get_process_value(ti, asset_index)

    def get_asset_values(self, times, asset_index: int = 0) -> torch.Tensor:
        """[len(times), paths] asset matrix: one gather of the state history
        and one ``exp``, for exercise-schedule consumers."""
        td = self.process.time_discretization
        idx = []
        for t in times:
            ti = td.get_time_index(t)
            if ti < 0:
                raise ValueError(f"time {t} not on the simulation grid")
            idx.append(ti)
        states = self.process._lazy_states()
        rows = to_device(idx, torch.long, states.device)
        return torch.exp(states[rows, asset_index])

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return self.model.numeraire(time)

    def get_monte_carlo_weights(self, time: float) -> RandomVariableTorch:
        n = self.process.get_number_of_paths()
        return RandomVariableTorch(0.0, 1.0 / n)

    def get_number_of_paths(self) -> int:
        return self.process.get_number_of_paths()

    getAssetValue = get_asset_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths


class EuropeanOption:
    """European call/put on the simulated asset (finmath's EuropeanOption)."""

    def __init__(self, maturity: float, strike: float, is_call: bool = True):
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.is_call = is_call

    def get_value_random_variable(self, model: MonteCarloBlackScholesModel) -> RandomVariableTorch:
        asset = model.get_asset_value(self.maturity)
        if self.is_call:
            payoff = asset.sub(self.strike).floor(0.0)
        else:
            payoff = asset.bus(self.strike).floor(0.0)
        n_t = model.get_numeraire(self.maturity)
        n_0 = model.get_numeraire(0.0)
        return payoff.div(n_t).mult(n_0)

    def get_value(self, model: MonteCarloBlackScholesModel) -> float:
        return self.get_value_random_variable(model).get_average()

    def get_value_and_error(self, model) -> tuple:
        out = self.packed_value_and_error(model).cpu().numpy()
        return float(out[0]), float(out[1])

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the device, no host transfer
        (global under a meshed facade)."""
        from .equity_products import _mean_and_stderr

        rv = self.get_value_random_variable(model)
        if rv.is_deterministic():
            return torch.tensor([rv.get_average(), 0.0], dtype=ACC_DTYPE)
        return _mean_and_stderr(rv.values, rv.mesh)

    getValue = get_value


# ---------------------------------------------------------------------------
# plain Monte-Carlo pricers: a loop over steps on the device
# ---------------------------------------------------------------------------

def _euler_constants(num_steps, risk_free_rate, volatility, maturity):
    """(sqrt_dt, drift per step, vol) computed in float64 and rounded to
    float32, as the JAX scan's ``astype`` does."""
    dt = maturity / num_steps
    return (float(np.float32(math.sqrt(dt))),
            float(np.float32((risk_free_rate - 0.5 * volatility * volatility) * dt)),
            float(np.float32(volatility)))


def mc_european_call_price(seed: int, num_paths: int, num_steps: int,
                           initial_value: float, risk_free_rate: float,
                           volatility: float, maturity: float,
                           strike: float, dtype=None, device=None) -> float:
    """European call MC price (the reference's benchmark row "MC
    Black-Scholes, 1M paths x 100 steps"): the value of
    ``mc_european_call_price_differentiable`` as a float. ``dtype`` and
    ``device`` as there."""
    return float(mc_european_call_price_differentiable(
        seed, num_paths, num_steps, initial_value, risk_free_rate,
        volatility, maturity, strike, dtype=dtype, device=device))


def mc_asian_call_price(seed: int, num_paths: int, num_steps: int,
                        initial_value: float, risk_free_rate: float,
                        volatility: float, maturity: float,
                        strike: float, device=None) -> float:
    """Arithmetic-average Asian call MC price, observations at every Euler
    step, float32 paths and running sum, float64 mean."""
    device = torch.device(device) if device is not None else select_device()
    num_paths, num_steps = int(num_paths), int(num_steps)
    gen = key_for_seed(seed, device)
    sqrt_dt, drift, vol = _euler_constants(num_steps, risk_free_rate,
                                           volatility, maturity)
    log_s = torch.full((num_paths,), math.log(initial_value),
                       dtype=FLOAT_DTYPE, device=device)
    sum_s = torch.zeros((num_paths,), dtype=FLOAT_DTYPE, device=device)
    for _ in range(num_steps):
        dw = torch.randn(num_paths, generator=gen, dtype=FLOAT_DTYPE,
                         device=device) * sqrt_dt
        log_s = log_s + drift + vol * dw
        sum_s = sum_s + torch.exp(log_s)
    payoff = torch.clamp_min(sum_s / num_steps - float(strike), 0.0)
    mean = float(torch.sum(payoff, dtype=ACC_DTYPE)) / num_paths
    return mean * math.exp(-risk_free_rate * maturity)


def mc_european_call_price_differentiable(seed: int, num_paths: int,
                                          num_steps: int, s0, risk_free_rate: float,
                                          sigma, maturity: float, strike: float,
                                          dtype=None, device=None) -> torch.Tensor:
    """The European call MC price as a float64 tensor that
    ``torch.autograd`` differentiates in ``s0`` and ``sigma``: delta and
    vega are ``torch.autograd.grad(price, (s0, sigma))``.

    Counterpart of the JAX package's fused ``_mc_bs_price_kernel`` under
    ``jax.grad`` (``bench.py:1135 bench_aad_greeks`` route 1), which is an
    XLA scan and no Pallas kernel: an Euler loop over steps in the path
    dtype on one ``torch.Generator`` stream from ``seed``. ``s0`` and
    ``sigma`` are floats or float64 tensors (``requires_grad``) that enter
    the path arithmetic through rounded copies, as the JAX scan's
    ``astype`` does: log S0, the per-step drift (r - sigma^2/2) dt and the
    volatility, each formed in float64. ``dtype=torch.float64`` runs the
    double-precision oracle mode on the identical Brownian stream: the
    normals are drawn in float32 either way. The mean divides by the path
    count exactly (a device tensor: the card multiplies by the reciprocal
    of a host scalar). The reverse pass keeps each step's normals,
    ``num_steps * num_paths`` values. ``device`` defaults to
    ``select_device()``."""
    dtype = dtype if dtype is not None else FLOAT_DTYPE
    device = torch.device(device) if device is not None else select_device()
    num_paths, num_steps = int(num_paths), int(num_steps)
    s0 = torch.as_tensor(s0, dtype=ACC_DTYPE, device=device)
    sigma = torch.as_tensor(sigma, dtype=ACC_DTYPE, device=device)
    dt = maturity / num_steps
    sqrt_dt = float(torch.tensor(math.sqrt(dt), dtype=ACC_DTYPE).to(dtype))
    drift = ((risk_free_rate - 0.5 * sigma * sigma) * dt).to(dtype)
    vol = sigma.to(dtype)
    gen = key_for_seed(seed, device)
    log_s = torch.log(s0).to(dtype).expand(num_paths)
    for _ in range(num_steps):
        dw = torch.randn(num_paths, generator=gen, dtype=FLOAT_DTYPE,
                         device=device).to(dtype) * sqrt_dt
        log_s = log_s + drift + vol * dw
    payoff = torch.clamp_min(torch.exp(log_s) - float(strike), 0.0)
    mean = torch.sum(payoff, dtype=ACC_DTYPE) / torch.tensor(
        float(num_paths), dtype=ACC_DTYPE, device=device)
    return mean * math.exp(-risk_free_rate * maturity)
