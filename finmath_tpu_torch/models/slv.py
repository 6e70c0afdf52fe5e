"""Heston stochastic-local-volatility (SLV) model with the particle
calibration of the leverage function inside the Euler steps.

Counterpart of ``finmath_tpu.models.slv``. Dynamics (risk-neutral):

    dS = (r - q) S dt + L(S, t) sqrt(V) S dW_S
    dV = kappa (theta - V) dt + mixing * xi sqrt(V) dW_V,
    d<W_S, W_V> = rho dt

The model reprices every vanilla of the input implied surface iff
L(K, t)^2 = v_loc(K, t) / E[V_t | S_t = K] (Gyongy), with ``v_loc`` the
Dupire local variance of the surface (``local_vol.local_variance``). The
conditional expectation comes from the particle method (Guyon and
Henry-Labordere 2012): at each Euler step the current cloud regresses V
on the standardized log-moneyness with a hat-function basis, and the fit
feeds that same step's leverage.

* ``_fit_conditional_variance``: float32 standardization moments, the
  ``[B, paths] @ [paths, B]`` Gram and the right-hand side as float32
  ``torch.matmul`` (TF32 off, the counterpart of ``Precision.HIGHEST``),
  a float64 ridge of 1e-8 trace, the port's ``_cholesky_solve_small``,
  and a float32 prediction.
* The Euler scheme asks for the drift and then the loadings of one state;
  the model fits the regression once a step for both (``_total_vol`` is
  cached on the time index and the state tensor; in the JAX scan XLA's
  common subexpression elimination merges the two traces).
* Path-axis sharding: the JAX model's ``axis_name`` names the mapped axis
  its moments ``psum`` over. Here a ``parallel.PathMesh`` stands in for
  it: a model whose ``mesh`` is set fits on this rank's block of the
  cloud and sums the count, ``sum k`` and ``sum k^2`` (float32) over the
  ranks in one all-reduce, then the float64 Gram matrix with its
  right-hand side in a second, so every rank fits the regression of the
  whole cloud (two all-reduces a step). A meshed ``EulerScheme`` (and so
  ``MonteCarloHestonSLVModel(..., mesh=)``) binds its mesh into a copy
  of the model (``on_mesh``). A model with a string ``axis_name`` (one
  converted from a JAX model with a named axis) reduces over the mesh it
  is bound to; simulated unbound it raises, as a ``psum`` over an
  unbound axis does in JAX.
"""

from __future__ import annotations

import copy
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.conditional_expectation import _cholesky_solve_small
from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..parallel.mesh import PathMesh, check_mesh
from ..utils.config import to_device
from .brownian_motion import BrownianMotion
from .heston import HestonParams, _grid_rows
from .local_vol import _StepCache, local_variance
from .process import EulerScheme, ProcessModel
from .time_discretization import TimeDiscretization


# ---------------------------------------------------------------------------
# hat-function regression basis
# ---------------------------------------------------------------------------

def _nodes(z_max: float, num_basis: int) -> np.ndarray:
    """The hat nodes ``linspace(-z_max, z_max, num_basis)`` in float32, as
    the JAX package's ``jnp.linspace`` compiles on the CPU: with
    ``r = 1 / (num_basis - 1)`` in float32, node i is
    ``-z_max (1 - i r) + i (z_max r)`` with the last product and the sum
    rounded once (a fused multiply-add), and the last node ``z_max``."""
    f = np.float32
    div = int(num_basis) - 1
    r = f(1.0) / f(div)
    i = np.arange(div, dtype=f)
    head = f(-z_max) * (f(1.0) - i * r)
    out = (head.astype(np.float64)
           + i.astype(np.float64) * np.float64(f(z_max) * r)).astype(f)
    return np.append(out, f(z_max))


def hat_basis(z: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear partition-of-unity basis: [B, paths] float32.

    ``z`` is clamped to the node range so wing particles attach to the
    edge hats (mass is never dropped)."""
    h = nodes[1] - nodes[0]
    zc = torch.clamp(z, nodes[0], nodes[-1])
    return torch.clamp_min(
        1.0 - torch.abs(zc[None, :] - nodes[:, None]) / h, 0.0
    ).to(FLOAT_DTYPE)


def _fit_conditional_variance(k: torch.Tensor, v: torch.Tensor,
                              nodes: torch.Tensor, axis_name=None):
    """Fit E[v | k] on the particle cloud; returns (beta [B] float64,
    mean_k, std_k) so the fit can also be evaluated off the cloud.

    ``axis_name``: None, or the ``parallel.PathMesh`` whose ranks hold the
    rest of the cloud (``k`` and ``v`` are then this rank's block). The
    float32 count and sums of k and k^2 go in one all-reduce and the
    float64 Gram matrix with its right-hand side in another, the JAX
    function's two ``psum`` groups; every rank fits the same beta."""
    ka = k.to(FLOAT_DTYPE)
    if axis_name is None:
        m = torch.mean(ka)
        m2 = torch.mean(ka * ka)
    else:
        n, s1, s2 = axis_name.all_reduce(torch.stack([
            torch.full((), float(ka.shape[-1]), dtype=FLOAT_DTYPE,
                       device=ka.device),
            torch.sum(ka), torch.sum(ka * ka)]))
        m = s1 / n
        m2 = s2 / n
    s = torch.sqrt(torch.clamp_min(m2 - m * m, 1e-12))
    z = (ka - m) / s
    basis = hat_basis(z, nodes)
    gram = torch.matmul(basis, basis.T).to(ACC_DTYPE)
    rhs = torch.matmul(basis, v[:, None])[:, 0].to(ACC_DTYPE)
    if axis_name is not None:
        both = axis_name.all_reduce(torch.cat([gram, rhs[:, None]], dim=1))
        gram, rhs = both[:, :-1], both[:, -1]
    eye = torch.eye(gram.shape[0], dtype=ACC_DTYPE, device=gram.device)
    # ridge sized to the float32 moment noise: it bounds the coefficients
    # of empty wing nodes while shrinking populated ones by ~1e-7
    beta = _cholesky_solve_small(gram + 1e-8 * torch.trace(gram) * eye, rhs)
    return beta, m, s


# ---------------------------------------------------------------------------
# the ProcessModel
# ---------------------------------------------------------------------------

class HestonSLVModel(ProcessModel):
    """State [log S, V] (V raw, full-truncation Euler), 2 factors
    (factor 0 drives V; log S loads rho on it and sqrt(1-rho^2) on
    factor 1, the HestonModel convention).

    ``surface`` is any total-variance surface of ``local_vol``.
    ``mixing`` in [0, 1] scales the vol-of-vol: 1 = full SLV, 0 = pure
    local vol (with v0 == theta, V is constant).

    ``axis_name``: None (the cloud is all here), a ``parallel.PathMesh``
    (the moments reduce over its ranks), or a name, the JAX model's
    mapped axis, which a meshed ``EulerScheme`` binds to its mesh
    (``on_mesh``); any other object raises ``NotImplementedError``."""

    def __init__(self, params: HestonParams, surface,
                 time_discretization: TimeDiscretization,
                 dividend_yield: float = 0.0, mixing: float = 1.0,
                 num_basis: int = 13, z_max: float = 3.0,
                 leverage_min: float = 0.05, leverage_max: float = 20.0,
                 min_vol: float = 1e-4, max_vol: float = 4.0,
                 t_floor: Optional[float] = None,
                 denominator_floor: float = 0.05,
                 axis_name=None):
        if not 0.0 <= mixing <= 1.0:
            raise ValueError("need 0 <= mixing <= 1")
        if num_basis < 4:
            raise ValueError("need num_basis >= 4")
        if axis_name is not None and not isinstance(axis_name, str):
            check_mesh(axis_name)
        self.params = params
        self.surface = surface
        self.dividend_yield = float(dividend_yield)
        self.mixing = float(mixing)
        self.leverage_min = float(leverage_min)
        self.leverage_max = float(leverage_max)
        self.min_vol = float(min_vol)
        self.max_vol = float(max_vol)
        self.denominator_floor = float(denominator_floor)
        self.axis_name = axis_name
        self.mesh = axis_name if isinstance(axis_name, PathMesh) else None
        self._nodes_np = _nodes(z_max, num_basis)
        self._nodes_by_device = {}
        td = time_discretization
        n = td.get_number_of_time_steps()
        times = np.asarray([td.get_time(i) for i in range(n + 1)])
        if t_floor is None:
            t_floor = 0.5 * float(times[1] - times[0])
        self.t_floor = float(t_floor)
        # left-point coefficient times, floored away from w(., 0) = 0
        coeff_times = np.maximum(times[:-1], self.t_floor)
        self._coeff_times = coeff_times.astype(np.float32)
        self._static_key = (
            params, surface, self.dividend_yield, self.mixing,
            int(num_basis), float(z_max), self.leverage_min,
            self.leverage_max, self.min_vol, self.max_vol, self.t_floor,
            self.denominator_floor, self.axis_name,
            tuple(float(t) for t in coeff_times))
        self._cache = _StepCache()

    def __hash__(self):
        return hash(self._static_key)

    def __eq__(self, other):
        return (isinstance(other, HestonSLVModel)
                and self._static_key == other._static_key)

    def on_mesh(self, mesh) -> "HestonSLVModel":
        """This model with its moments reduced over ``mesh`` (a
        ``parallel.PathMesh``; a foreign mesh object raises
        ``NotImplementedError``): a copy with a step cache of its own,
        unequal to the unbound model; ``self`` when it reduces over
        ``mesh`` already or ``mesh`` is None. A model bound to another
        mesh raises ``ValueError``."""
        mesh = check_mesh(mesh)
        if mesh is None or self.mesh is mesh:
            return self
        if self.mesh is not None:
            raise ValueError(f"the model reduces over {self.mesh} already, "
                             f"not over {mesh}")
        out = copy.copy(self)
        out.mesh = mesh
        out._static_key = self._static_key + (mesh,)
        out._cache = _StepCache()
        return out

    def _moment_mesh(self) -> Optional[PathMesh]:
        """The mesh the moments reduce over; a name bound to none raises
        (a ``psum`` over an unbound axis)."""
        if self.mesh is None and self.axis_name is not None:
            raise ValueError(
                f"axis_name {self.axis_name!r} is bound to no mesh: simulate "
                "the model through MonteCarloHestonSLVModel(..., mesh=) or "
                "EulerScheme(..., mesh=) with a PathMesh")
        return self.mesh

    def _nodes_on(self, device) -> torch.Tensor:
        """The hat nodes as a float32 tensor on ``device`` (copied once a
        device)."""
        device = torch.device(device)
        if device not in self._nodes_by_device:
            self._nodes_by_device[device] = to_device(
                self._nodes_np, FLOAT_DTYPE, device)
        return self._nodes_by_device[device]

    def get_number_of_components(self) -> int:
        return 2

    def get_number_of_factors(self) -> int:
        return 2

    def initial_state(self, num_paths: int, device=None) -> torch.Tensor:
        p = self.params
        row_s = torch.full((num_paths,), math.log(p.initial_value),
                           dtype=FLOAT_DTYPE, device=device)
        row_v = torch.full((num_paths,), p.v0, dtype=FLOAT_DTYPE,
                           device=device)
        return torch.stack([row_s, row_v])

    # -- leverage ----------------------------------------------------------

    def _moneyness(self, time_index, log_s: torch.Tensor) -> torch.Tensor:
        f = np.float32
        t = self._coeff_times[time_index]
        p = self.params
        carry = f(p.risk_free_rate - self.dividend_yield)
        return (log_s - float(f(math.log(p.initial_value)))
                - float(carry * t))

    def _compute_total_vol(self, time_index, state) -> torch.Tensor:
        log_s, v = state[0], state[1]
        vp = torch.clamp_min(v, 0.0)
        t = torch.full((), float(self._coeff_times[time_index]),
                       dtype=FLOAT_DTYPE, device=state.device)
        k = self._moneyness(time_index, log_s)
        v_loc = local_variance(self.surface, k, t,
                               denominator_floor=self.denominator_floor)
        nodes = self._nodes_on(state.device)
        beta, m, s = _fit_conditional_variance(
            k, vp, nodes, axis_name=self._moment_mesh())
        z = (k.to(FLOAT_DTYPE) - m) / s
        cond_v = torch.matmul(beta.to(FLOAT_DTYPE)[None, :],
                              hat_basis(z, nodes))[0]
        # relative floor: a pathological fit can dip near zero at a
        # sparse wing; never divide by (almost) nothing
        floor = float(np.float32(1e-3) * np.float32(self.params.v0))
        lev2 = v_loc / torch.clamp_min(cond_v, floor)
        lev = torch.clamp(torch.sqrt(torch.clamp_min(lev2, 0.0)),
                          self.leverage_min, self.leverage_max)
        return torch.clamp(lev * torch.sqrt(vp), self.min_vol, self.max_vol)

    def _total_vol(self, time_index, state) -> torch.Tensor:
        """Clipped per-path total volatility L(k, t) sqrt(V+): the one
        quantity drift and loadings share, fitted once a step."""
        return self._cache.get(time_index, state, self._compute_total_vol)

    # -- Euler coefficients ------------------------------------------------

    def drift(self, time_index, state) -> torch.Tensor:
        p = self.params
        sig = self._total_vol(time_index, state)
        vp = torch.clamp_min(state[1], 0.0)
        mu_s = (p.risk_free_rate - self.dividend_yield - 0.5 * sig * sig)
        mu_v = p.kappa * (p.theta - vp)
        return torch.stack([torch.broadcast_to(mu_s, state[0].shape), mu_v])

    def factor_loadings(self, time_index, state) -> torch.Tensor:
        p = self.params
        sig = self._total_vol(time_index, state)
        sqrt_vp = torch.sqrt(torch.clamp_min(state[1], 0.0))
        rho = np.float32(p.rho)
        row_s = torch.stack([float(rho) * sig,
                             float(np.sqrt(np.float32(1.0) - rho * rho))
                             * sig])
        row_v = torch.stack([self.mixing * p.xi * sqrt_vp,
                             torch.zeros_like(sqrt_vp)])
        return torch.stack([row_s, row_v])  # [2, 2, paths]

    def apply_state_space_transform(self, component: int,
                                    x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x) if component == 0 else x

    def numeraire(self, time: float) -> RandomVariableTorch:
        return RandomVariableTorch(
            time, math.exp(self.params.risk_free_rate * time))


# ---------------------------------------------------------------------------
# simulation facade
# ---------------------------------------------------------------------------

class MonteCarloHestonSLVModel:
    """``MonteCarloBlackScholesModel`` surface over the SLV dynamics, so
    the equity products price under calibrated SLV unchanged. Without
    ``brownian``, the increments are drawn on ``device`` (default
    ``select_device()``) from ``seed``.

    ``mesh``: a ``parallel.PathMesh``. The ``EulerScheme`` then simulates
    this rank's block of the global stream with the model bound to the
    mesh (``self.model``, ``HestonSLVModel.on_mesh``), so every step's
    regression fits the whole cloud, and the products reduce over the
    ranks."""

    def __init__(self, time_discretization: TimeDiscretization,
                 num_paths: int, model: HestonSLVModel,
                 seed: int = 3141, brownian: BrownianMotion = None,
                 mesh=None, *, device=None):
        if brownian is not None and brownian.get_number_of_paths() != num_paths:
            raise ValueError(
                f"num_paths={num_paths} does not match the supplied "
                f"brownian's {brownian.get_number_of_paths()} paths")
        if device is None and mesh is not None:
            device = getattr(mesh, "device", None)
        self.brownian = brownian or BrownianMotion(
            time_discretization, 2, num_paths, seed, device=device)
        self.process = EulerScheme(model, self.brownian, mesh=mesh,
                                   device=device)
        self.model = self.process.model
        self.mesh = self.process.mesh

    def get_asset_value(self, time: float,
                        asset_index: int = 0) -> RandomVariableTorch:
        ti = self.process.time_discretization.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return self.process.get_process_value(ti, 0)

    def get_asset_values(self, times, asset_index: int = 0) -> torch.Tensor:
        states = self.process._lazy_states()
        rows = _grid_rows(self.process.time_discretization, times,
                          states.device)
        return torch.exp(states[rows, 0])

    def get_variance_value(self, time: float) -> RandomVariableTorch:
        """Instantaneous variance V_t (diagnostic / variance products)."""
        ti = self.process.time_discretization.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return self.process.get_process_value(ti, 1)

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return self.model.numeraire(time)

    def get_number_of_paths(self) -> int:
        return self.process.get_number_of_paths()

    def leverage_at(self, time: float,
                    strikes: Sequence[float]) -> np.ndarray:
        """Diagnostic: the calibrated leverage L(K, t) re-fitted on the
        cached particle cloud at ``time`` (the whole cloud under a mesh),
        evaluated at ``strikes``."""
        td = self.process.time_discretization
        ti = td.get_time_index(time)
        if ti <= 0:
            raise ValueError("need a positive grid time")
        states = self.process._lazy_states()
        dev = states.device
        log_s, v = states[ti, 0], torch.clamp_min(states[ti, 1], 0.0)
        mdl = self.model
        f = np.float32
        t = max(f(time), f(mdl.t_floor))
        p = mdl.params
        carry = p.risk_free_rate - mdl.dividend_yield
        k = (log_s - math.log(p.initial_value)
             - float(f(carry * float(time))))
        nodes = mdl._nodes_on(dev)
        beta, m, s = _fit_conditional_variance(
            k, v, nodes, axis_name=mdl._moment_mesh())
        kq = to_device(np.log(np.asarray(strikes, dtype=np.float64)
                              / (p.initial_value
                                 * math.exp(carry * float(time)))),
                       FLOAT_DTYPE, dev)
        zq = (kq - m) / s
        cond_v = beta.to(FLOAT_DTYPE) @ hat_basis(zq, nodes)
        v_loc = local_variance(mdl.surface, kq,
                               torch.full((), float(t), dtype=FLOAT_DTYPE,
                                          device=dev),
                               denominator_floor=mdl.denominator_floor)
        floor = 1e-3 * p.v0
        lev = torch.sqrt(torch.clamp_min(
            v_loc / torch.clamp_min(cond_v, floor), 0.0))
        return torch.clamp(lev, mdl.leverage_min,
                           mdl.leverage_max).cpu().numpy()

    getAssetValue = get_asset_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths
