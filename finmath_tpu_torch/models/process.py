"""Monte-Carlo process discretization: the Euler scheme as a loop over steps.

Counterpart of ``finmath_tpu.models.process``, the equivalent of
finmath-lib's ``EulerSchemeFromProcessModel``. The JAX package runs the
path evolution as one ``jax.lax.scan``; here it is a Python loop over the
time steps, each step a few elementwise device kernels over the path axis.

A ProcessModel supplies, in state space (e.g. log-coordinates):

* ``initial_state(num_paths, device)``      -> [components, paths]
* ``drift(time_index, state)``              -> [components, paths]
* ``factor_loadings(time_index, state)``    -> [components, factors, paths]
* ``apply_state_space_transform(c, x)``     -> values (e.g. exp)
* ``numeraire(time)``                       -> RandomVariable

The state history is ``[steps+1, components, paths]`` float32 on the
device. The diffusion contraction over the factors is an elementwise
product and a float32 sum (no matrix product, so TF32 never enters).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.random_variable import FLOAT_DTYPE, RandomVariableTorch
from ..parallel.mesh import check_mesh
from ..utils.config import select_device
from .time_discretization import TimeDiscretization


class ProcessModel:
    """Abstract base for models evolved by the Euler scheme."""

    def get_number_of_components(self) -> int:
        raise NotImplementedError

    def get_number_of_factors(self) -> int:
        raise NotImplementedError

    def initial_state(self, num_paths: int, device=None) -> torch.Tensor:
        raise NotImplementedError

    def drift(self, time_index, state: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def factor_loadings(self, time_index, state: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_state_space_transform(self, component: int,
                                    x: torch.Tensor) -> torch.Tensor:
        return x

    def numeraire(self, time: float) -> RandomVariableTorch:
        raise NotImplementedError


def euler_scan(model: ProcessModel, initial_state: torch.Tensor,
               increments: torch.Tensor, dts) -> torch.Tensor:
    """Evolve state X_{i+1} = X_i + mu(i, X_i) dt_i + sum_f lambda_f(i, X_i) dW_{i,f}.

    ``increments`` is ``[steps, factors, paths]`` float32, ``dts`` the
    step sizes (float64, rounded to float32 as the JAX scan does). Returns
    the full state history [steps+1, components, paths]."""
    steps = increments.shape[0]
    dts = torch.as_tensor(np.asarray(dts, dtype=np.float64)).to(
        FLOAT_DTYPE).to(initial_state.device)
    states = torch.empty((steps + 1,) + tuple(initial_state.shape),
                         dtype=initial_state.dtype, device=initial_state.device)
    states[0] = initial_state
    state = initial_state
    for i in range(steps):
        mu = model.drift(i, state)
        lam = model.factor_loadings(i, state)                  # [C, F, P]
        diffusion = torch.sum(lam * increments[i][None], dim=1)
        state = state + mu * dts[i] + diffusion
        states[i + 1] = state
    return states


class EulerScheme:
    """Euler discretization of a ProcessModel driven by a BrownianMotion.

    The full path history is computed once (lazily) and cached on the
    device, mirroring finmath's process cache. ``device`` defaults to the
    Brownian motion's (under a mesh, the mesh's), else ``select_device()``;
    host increments (the Mersenne and host drivers) are uploaded there.

    ``mesh``: a ``parallel.PathMesh``. Every rank then takes the Brownian
    motion's GLOBAL increments, the same stream as without a mesh, and
    keeps its block of the paths (``[..., r n:(r + 1) n]``), so the meshed
    and the unsharded scheme simulate the same paths; the increments cost
    W times their memory over the ranks. ``get_process_value`` returns the
    block as a meshed ``RandomVariableTorch``, whose reductions are
    global. A path count that the world size does not divide raises
    ``ValueError`` at the first simulation, as in the JAX package. A model
    whose coefficients reduce over the paths (Heston-SLV's regression) is
    bound to the mesh through its ``on_mesh`` (``self.model``), as XLA
    partitions those reductions over the meshed scan in the JAX package.
    """

    def __init__(self, model: ProcessModel, brownian, mesh=None, device=None):
        self.mesh = check_mesh(mesh)
        if self.mesh is not None and hasattr(model, "on_mesh"):
            model = model.on_mesh(self.mesh)
        self._model = model
        self._brownian = brownian
        if device is None and self.mesh is not None:
            device = self.mesh.device
        if device is None:
            device = getattr(brownian, "device", None)
        self._device = (torch.device(device) if device is not None
                        else select_device())
        self._states: Optional[torch.Tensor] = None

    @property
    def model(self) -> ProcessModel:
        return self._model

    @property
    def time_discretization(self) -> TimeDiscretization:
        return self._brownian.get_time_discretization()

    @property
    def device(self) -> torch.device:
        return self._device

    def _lazy_states(self) -> torch.Tensor:
        if self._states is None:
            td = self.time_discretization
            num_paths = self._brownian.get_number_of_paths()
            inc = torch.as_tensor(self._brownian.increments)
            if self.mesh is not None:
                block = self.mesh.local_slice(num_paths)
                num_paths = block.stop - block.start
                inc = inc[:, :, block]
            init = self._model.initial_state(num_paths, self._device)
            inc = inc.to(device=self._device, dtype=FLOAT_DTYPE)
            self._states = euler_scan(self._model, init, inc,
                                      td.get_step_sizes())
        return self._states

    def get_process_value(self, time_index: int, component: int = 0) -> RandomVariableTorch:
        states = self._lazy_states()
        vals = self._model.apply_state_space_transform(
            component, states[time_index, component]
        )
        return RandomVariableTorch.of(
            self.time_discretization.get_time(time_index), vals,
            mesh=self.mesh)

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return self._model.numeraire(time)

    def get_number_of_paths(self) -> int:
        return self._brownian.get_number_of_paths()

    def get_brownian_motion(self):
        return self._brownian

    # finmath-style aliases
    getProcessValue = get_process_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths
    getTimeDiscretization = property(lambda self: self.time_discretization)
