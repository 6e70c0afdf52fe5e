"""Dupire local-volatility model: SSVI implied surface -> exact
forward-mode local variance -> Euler Monte-Carlo through the shared
``EulerScheme``, so the equity products price under local volatility
unchanged.

Counterpart of ``finmath_tpu.models.local_vol``.

* ``SSVISurface`` (Gatheral-Jacquier) and ``DupireLocalVolSurface`` (any
  torch-callable ``w(k, t)``) give the total implied variance w(k, T).
  Their methods take Python floats or tensors; as in the JAX package,
  Python floats act on float32 tensors at the tensor's precision, and on
  floats alone the result is a float64 Python number.
* ``local_variance`` is Dupire in total-variance form (Gatheral, The
  Volatility Surface, eq. 1.10),

      v_loc(k, T) = dw/dT / [ 1 - k/w dw/dk
                    + 1/4 (-1/4 - 1/w + k^2/w^2) (dw/dk)^2
                    + 1/2 d2w/dk2 ]

  with all three derivatives by exact forward mode (a nested
  ``torch.func.jvp`` in k and a ``torch.autograd.forward_ad`` dual number
  in T, elementwise: no finite difference, no closed form written for
  SSVI alone). The butterfly denominator is
  floored at ``denominator_floor`` and dw/dT at 0.
* ``LocalVolatilityModel`` evaluates it at the left-point coefficient
  times (floored at ``t_floor``) and clips sqrt(v_loc) to
  [min_vol, max_vol]. The Euler scheme asks for the drift and then the
  loadings of the same state; the model evaluates the local volatility
  once for both (the JAX scan gets the same from XLA's common
  subexpression elimination).
* ``european_call_values`` prices a strike x expiry grid with float64
  means and standard errors in one host copy.

Path state is log S in float32; reductions float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.autograd import forward_ad
from torch.func import jvp

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..utils.config import to_device
from .brownian_motion import BrownianMotion
from .heston import _grid_rows
from .process import EulerScheme, ProcessModel
from .time_discretization import TimeDiscretization


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _operand(x):
    """A Python float stays a float (and acts on tensors at their
    precision); arrays become tensors."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (float, int, np.floating, np.integer)):
        return float(x)
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# implied total-variance surfaces
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SSVISurface:
    """Gatheral-Jacquier SSVI total implied variance

        w(k, T) = theta(T)/2 * (1 + rho phi k + sqrt((phi k + rho)^2
                                                     + 1 - rho^2)),
        phi = eta / theta(T)^gamma,

    with the ATM total-variance backbone

        theta(T) = sigma_inf^2 T + (sigma0^2 - sigma_inf^2) tau
                   (1 - exp(-T / tau))

    (short-end ATM vol ``sigma0`` decaying to ``sigma_inf`` on scale
    ``tau``, increasing in T, so calendar-arbitrage-free by
    construction). ``eta = 0`` gives a strike-flat surface; ``rho`` tilts
    the skew. The methods accept floats or tensors in ``k`` and ``t``."""

    sigma0: float
    sigma_inf: float
    tau: float
    rho: float
    eta: float
    gamma: float = 0.4

    def __post_init__(self):
        if not -1.0 < self.rho < 1.0:
            raise ValueError("need -1 < rho < 1")
        if self.eta < 0.0 or self.sigma0 <= 0.0 or self.sigma_inf <= 0.0:
            raise ValueError("need eta >= 0 and positive ATM vols")
        if not 0.0 < self.gamma < 1.0:
            raise ValueError("need 0 < gamma < 1")
        if self.tau <= 0.0:
            raise ValueError("need tau > 0")

    def theta(self, t):
        """ATM total variance backbone (increasing, theta(0) = 0)."""
        t = _operand(t)
        s0 = self.sigma0 * self.sigma0
        si = self.sigma_inf * self.sigma_inf
        return si * t + (s0 - si) * self.tau * (
            1.0 - _exp(-t / self.tau))

    def total_variance(self, k, t):
        """w(k, t); k = log-moneyness vs the forward, t > 0."""
        k, t = _operand(k), _operand(t)
        th = self.theta(t)
        phi = self.eta * th ** (-self.gamma)
        x = phi * k
        return 0.5 * th * (
            1.0 + self.rho * x
            + _sqrt((x + self.rho) ** 2 + 1.0 - self.rho * self.rho))

    def implied_volatility(self, k, t):
        return _sqrt(self.total_variance(k, t) / _operand(t))

    def validate(self, t_max: float, n: int = 64) -> None:
        """Gatheral-Jacquier Thm 4.2 sufficient butterfly conditions,
        checked on a grid up to ``t_max`` (the backbone is calendar-free
        by construction): theta phi (1 + |rho|) <= 4 and
        theta phi^2 (1 + |rho|) <= 4. Raises ValueError on violation."""
        ts = np.linspace(t_max / n, t_max, n)
        th = self.theta(torch.as_tensor(ts)).numpy()
        phi = self.eta * th ** (-self.gamma)
        lim = 4.0 / (1.0 + abs(self.rho))
        worst1 = float(np.max(th * phi))
        worst2 = float(np.max(th * phi * phi))
        if worst1 > lim or worst2 > lim:
            raise ValueError(
                f"SSVI butterfly condition violated up to t={t_max}: "
                f"max theta*phi={worst1:.3f}, max theta*phi^2={worst2:.3f}, "
                f"limit {lim:.3f}")


@dataclass(frozen=True)
class DupireLocalVolSurface:
    """Adapter for a user-supplied total-variance function ``w(k, t)`` of
    tensors (both may be tensors); anything smooth and written in torch
    operations works, e.g. a per-expiry SVI interpolation."""

    w: Callable

    def total_variance(self, k, t):
        return self.w(k, t)

    def implied_volatility(self, k, t):
        return _sqrt(self.w(k, t) / _operand(t))


# ---------------------------------------------------------------------------
# Dupire local variance by exact nested forward-mode derivatives
# ---------------------------------------------------------------------------

def local_variance(surface, k, t, denominator_floor: float = 0.05):
    """Dupire local variance v_loc(k, t) from the total-variance surface,
    all three derivatives by exact forward mode (a nested
    ``torch.func.jvp`` in k, a ``torch.autograd.forward_ad`` dual number
    in t).

    ``k`` may be any tensor; ``t`` a scalar (one step's time) or a tensor
    broadcastable against ``k``. The butterfly denominator is clamped at
    ``denominator_floor`` and dw/dT at 0, so a surface with mild static
    arbitrage yields capped-but-finite variance."""
    k = torch.as_tensor(k)
    t = torch.as_tensor(t, dtype=k.dtype).to(k.device)
    ones_k = torch.ones_like(k)

    def w_of_k(kk):
        return surface.total_variance(
            kk, torch.broadcast_to(t, kk.shape) if t.ndim else t)

    # one nested jvp gives w, dw/dk (its primal) and d2w/dk2 (its
    # tangent); dw/dT is one dual-number pass
    (w, wk), (_, wkk) = jvp(lambda kk: jvp(w_of_k, (kk,), (ones_k,)),
                            (k,), (ones_k,))
    tt = t.expand(k.shape).contiguous() if t.ndim == 0 else t
    with forward_ad.dual_level():
        dual = surface.total_variance(
            k, forward_ad.make_dual(tt, torch.ones_like(tt)))
        wt = forward_ad.unpack_dual(dual).tangent

    kw = k / w
    denom = (1.0 - kw * wk
             + 0.25 * (-0.25 - 1.0 / w + kw * kw) * wk * wk
             + 0.5 * wkk)
    return torch.clamp_min(wt, 0.0) / torch.clamp_min(denom,
                                                      denominator_floor)


class _StepCache:
    """The last step's per-path coefficient, keyed on the time index and
    the state tensor itself: the Euler scheme asks for the drift and then
    the loadings of one state, and the coefficient is computed once for
    both."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, time_index, state, compute):
        if (self._key is not None and self._key[0] == time_index
                and self._key[1] is state):
            return self._value
        self._key = (time_index, state)
        self._value = compute(time_index, state)
        return self._value


# ---------------------------------------------------------------------------
# the ProcessModel
# ---------------------------------------------------------------------------

class LocalVolatilityModel(ProcessModel):
    """dS = (r - q) S dt + sigma_loc(S, t) S dW evolved in log
    coordinates: d log S = (r - q - v_loc/2) dt + sqrt(v_loc) dW with
    v_loc = Dupire local variance at (k_t, t),
    k_t = log(S_t / F_t) = log S_t - log S0 - (r - q) t.

    The left-point Euler coefficient uses t floored at ``t_floor``
    (default: half the first step) because w(., 0) = 0 makes the raw
    formula 0/0 at the origin. sqrt(v_loc) is clamped to
    [min_vol, max_vol]."""

    def __init__(self, initial_value: float, risk_free_rate: float,
                 surface, time_discretization: TimeDiscretization,
                 dividend_yield: float = 0.0,
                 min_vol: float = 1e-4, max_vol: float = 4.0,
                 t_floor: Optional[float] = None,
                 denominator_floor: float = 0.05):
        self.initial_value = float(initial_value)
        self.risk_free_rate = float(risk_free_rate)
        self.dividend_yield = float(dividend_yield)
        self.surface = surface
        self.min_vol = float(min_vol)
        self.max_vol = float(max_vol)
        self.denominator_floor = float(denominator_floor)
        td = time_discretization
        n = td.get_number_of_time_steps()
        times = np.asarray([td.get_time(i) for i in range(n + 1)])
        if t_floor is None:
            t_floor = 0.5 * float(times[1] - times[0])
        self.t_floor = float(t_floor)
        # left-point coefficient times, floored away from w(.,0)=0
        coeff_times = np.maximum(times[:-1], self.t_floor)
        self._coeff_times = coeff_times.astype(np.float32)
        self._static_key = (
            self.initial_value, self.risk_free_rate, self.dividend_yield,
            surface, self.min_vol, self.max_vol, self.denominator_floor,
            self.t_floor, tuple(float(t) for t in coeff_times))
        self._cache = _StepCache()

    def __hash__(self):
        return hash(self._static_key)

    def __eq__(self, other):
        return (isinstance(other, LocalVolatilityModel)
                and self._static_key == other._static_key)

    def get_number_of_components(self) -> int:
        return 1

    def get_number_of_factors(self) -> int:
        return 1

    def initial_state(self, num_paths: int, device=None) -> torch.Tensor:
        return torch.full((1, num_paths), math.log(self.initial_value),
                          dtype=FLOAT_DTYPE, device=device)

    def _compute_local_vol(self, time_index, state) -> torch.Tensor:
        f = np.float32
        t = self._coeff_times[time_index]
        carry = f(self.risk_free_rate - self.dividend_yield)
        k = state - float(f(math.log(self.initial_value))) \
            - float(carry * t)
        v = local_variance(self.surface, k,
                           torch.full((), float(t), dtype=state.dtype,
                                      device=state.device),
                           denominator_floor=self.denominator_floor)
        return torch.clamp(torch.sqrt(torch.clamp_min(v, 0.0)),
                           self.min_vol, self.max_vol)

    def _local_vol(self, time_index, state) -> torch.Tensor:
        return self._cache.get(time_index, state, self._compute_local_vol)

    def drift(self, time_index, state) -> torch.Tensor:
        sig = self._local_vol(time_index, state)
        return (self.risk_free_rate - self.dividend_yield
                - 0.5 * sig * sig)

    def factor_loadings(self, time_index, state) -> torch.Tensor:
        sig = self._local_vol(time_index, state)
        return sig[:, None, :]

    def apply_state_space_transform(self, component: int,
                                    x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x)

    def numeraire(self, time: float) -> RandomVariableTorch:
        return RandomVariableTorch(
            time, math.exp(self.risk_free_rate * time))


class MonteCarloLocalVolModel:
    """Simulation facade (the ``MonteCarloBlackScholesModel`` surface),
    so every equity product prices under local volatility unchanged.
    Without ``brownian``, the increments are drawn on ``device`` (default:
    the mesh's, else ``select_device()``) from ``seed``. ``mesh``: a
    ``parallel.PathMesh`` (``EulerScheme``): each rank simulates its block
    of the same paths (the local volatility is pathwise, so no reduction
    crosses the ranks during the simulation)."""

    def __init__(self, time_discretization: TimeDiscretization,
                 num_paths: int, model: LocalVolatilityModel,
                 seed: int = 3141, brownian: BrownianMotion = None,
                 mesh=None, *, device=None):
        if device is None and mesh is not None:
            device = getattr(mesh, "device", None)
        self.model = model
        self.brownian = brownian or BrownianMotion(
            time_discretization, 1, num_paths, seed, device=device)
        self.process = EulerScheme(model, self.brownian, mesh=mesh,
                                   device=device)
        self.mesh = self.process.mesh

    def get_asset_value(self, time: float,
                        asset_index: int = 0) -> RandomVariableTorch:
        ti = self.process.time_discretization.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return self.process.get_process_value(ti, asset_index)

    def get_asset_values(self, times, asset_index: int = 0) -> torch.Tensor:
        states = self.process._lazy_states()
        rows = _grid_rows(self.process.time_discretization, times,
                          states.device)
        return torch.exp(states[rows, asset_index])

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return self.model.numeraire(time)

    def get_number_of_paths(self) -> int:
        return self.process.get_number_of_paths()

    getAssetValue = get_asset_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths


# ---------------------------------------------------------------------------
# vanilla-grid pricer (surface round trip)
# ---------------------------------------------------------------------------

def _vanilla_grid_kernel(assets: torch.Tensor, dfs: torch.Tensor,
                         strikes: torch.Tensor, mesh=None) -> torch.Tensor:
    """[expiries, paths] asset matrix x [strikes] -> packed
    [expiries, strikes, 2] float64 (value, stderr); under ``mesh`` over
    every rank's paths: one all-reduce of the grid's sums, then one of its
    squared deviations."""
    pay = torch.clamp_min(assets[:, None, :] - strikes[None, :, None], 0.0)
    p = pay.to(ACC_DTYPE) * dfs[:, None, None]
    n = p.shape[-1]
    sums = torch.sum(p, dim=-1)
    if mesh is not None:
        n *= mesh.world_size
        sums = mesh.all_reduce(sums)
    mean = sums / n
    sq = torch.sum((p - mean[..., None]) ** 2, dim=-1)
    if mesh is not None:
        sq = mesh.all_reduce(sq)
    var = sq / (n - 1)
    return torch.stack([mean, torch.sqrt(var / n)], dim=-1)


def european_call_values(model, strikes: Sequence[float],
                         expiries: Sequence[float]) -> np.ndarray:
    """Discounted European call values (and MC stderr) for a full
    strike x expiry grid: [expiries, strikes, 2] float64 in one host
    copy; on a meshed facade over every rank's paths, equal on every
    rank. Round-trip test: Black-invert these against the input
    surface."""
    from .equity_products import _deterministic_dfs

    assets = model.get_asset_values([float(t) for t in expiries])
    dfs = _deterministic_dfs(model, expiries)
    return _vanilla_grid_kernel(
        assets, to_device(dfs, ACC_DTYPE, assets.device),
        to_device(np.asarray(strikes, dtype=np.float64), ACC_DTYPE,
                  assets.device).to(FLOAT_DTYPE),
        getattr(model, "mesh", None)).cpu().numpy()
