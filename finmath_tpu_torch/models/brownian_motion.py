"""Brownian motion: device-generated increments, the reference benchmarks'
own random stream, and the host drivers.

Counterpart of ``finmath_tpu.models.brownian_motion``:

* ``BrownianMotion`` draws all increments on the device with
  ``torch.randn`` from a ``torch.Generator`` seeded with ``seed`` (the JAX
  package draws them with Threefry). Identity is (timeDiscretization,
  numberOfFactors, numberOfPaths, seed). What is kept is the statistical
  contract (increment mean 0, variance dt); neither package reproduces the
  reference's XORWOW stream, and torch's stream is not JAX's, so the tests
  cross packages on the Mersenne stream or on injected normals only.
* ``finmath_mersenne_increments`` and ``BrownianMotionFinmathMersenne``:
  the bit-exact realization of finmath-lib's
  ``BrownianMotionFromMersenneRandomNumbers`` (host, then uploaded), the
  reference's primary configuration.
* ``BrownianMotionHostRandom``: all-host MT19937 / java.util.Random LCG
  increments in the CPU float oracle type.
* ``BrownianMotionTorchWithHostRandomVariable``: normals drawn on the
  device, pulled to the host, wrapped in the CPU float type.
* ``BrownianMotionView``: a subset of another motion's factors.

``increments`` is ``[steps, factors, paths]`` float32 in every class: a
tensor on the device for the device classes, a NumPy array for the host
ones. ``device`` says where the increments or their random variables live
(``None`` for the host classes, whose consumers choose).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..native.host_rng import HostRandomGenerator
from ..ops.random_variable import FLOAT_DTYPE, RandomVariableTorch
from ..ops.random_variable_float import RandomVariableFloat
from ..utils.config import select_device
from .time_discretization import TimeDiscretization


def normal_increments(generator: torch.Generator, num_steps: int,
                      num_factors: int, num_paths: int,
                      sqrt_dts: torch.Tensor) -> torch.Tensor:
    """All Brownian increments: [steps, factors, paths] float32 on
    ``sqrt_dts``' device, increment (i, j) ~ N(0, dt_i), drawn from
    ``generator`` (a generator of that device)."""
    z = torch.randn((num_steps, num_factors, num_paths), generator=generator,
                    dtype=FLOAT_DTYPE, device=sqrt_dts.device)
    return z * sqrt_dts[:, None, None].to(FLOAT_DTYPE)


def key_for_seed(seed: int, device=None) -> torch.Generator:
    """The generator of ``device`` (default ``select_device()``) seeded
    with ``seed``: the port's counterpart of a JAX PRNG key."""
    device = torch.device(device) if device is not None else select_device()
    return torch.Generator(device=device).manual_seed(int(seed))


class BrownianMotion:
    """Lazily generated, cached Brownian increments on the device.

    Doubles as a RandomVariable factory via
    ``get_random_variable_for_constant``, like the reference
    (BrownianMotionCudaWithRandomVariableCuda.java:200-202).
    """

    def __init__(self, time_discretization: TimeDiscretization,
                 num_factors: int, num_paths: int, seed: int,
                 factory=None, device=None):
        self._td = time_discretization
        self._num_factors = int(num_factors)
        self._num_paths = int(num_paths)
        self._seed = int(seed)
        self._factory = factory
        self._device = (torch.device(device) if device is not None
                        else select_device())
        self._increments: Optional[torch.Tensor] = None  # [steps, factors, paths]

    # ------------------------------------------------------------------
    def _lazy_init(self) -> torch.Tensor:
        if self._increments is None:
            sqrt_dts = torch.sqrt(torch.as_tensor(
                self._td.get_step_sizes(), device=self._device))
            self._increments = normal_increments(
                key_for_seed(self._seed, self._device),
                self._td.get_number_of_time_steps(),
                self._num_factors,
                self._num_paths,
                sqrt_dts,
            )
        return self._increments

    @property
    def increments(self) -> torch.Tensor:
        """Raw [steps, factors, paths] device tensor."""
        return self._lazy_init()

    @property
    def device(self) -> torch.device:
        return self._device

    def get_brownian_increment(self, time_index: int, factor: int = 0):
        inc = self._lazy_init()
        time = self._td.get_time(time_index + 1)
        if self._factory is not None:
            # route through the injected factory (e.g. the AAD factory puts
            # increments on its tape)
            return self._factory.create_random_variable(time, inc[time_index, factor])
        return RandomVariableTorch.of(time, inc[time_index, factor])

    def get_increment(self, time_index: int) -> list:
        return [
            self.get_brownian_increment(time_index, f)
            for f in range(self._num_factors)
        ]

    def get_brownian_motion(self, time_index: int, factor: int = 0) -> RandomVariableTorch:
        """W(t_i) = sum of increments up to i (cumulative)."""
        inc = self._lazy_init()
        if time_index > 0:
            w = torch.sum(inc[:time_index, factor], dim=0)
        else:
            w = torch.zeros(self._num_paths, dtype=FLOAT_DTYPE,
                            device=self._device)
        return RandomVariableTorch.of(self._td.get_time(time_index), w)

    # ------------------------------------------------------------------
    def get_time_discretization(self) -> TimeDiscretization:
        return self._td

    def get_number_of_factors(self) -> int:
        return self._num_factors

    def get_number_of_paths(self) -> int:
        return self._num_paths

    def get_seed(self) -> int:
        return self._seed

    def get_random_variable_for_constant(self, value: float) -> RandomVariableTorch:
        if self._factory is not None:
            return self._factory.create_random_variable(0.0, value)
        return RandomVariableTorch(0.0, value, device=self._device)

    def get_clone_with_modified_seed(self, seed: int) -> "BrownianMotion":
        return BrownianMotion(self._td, self._num_factors, self._num_paths, seed,
                              self._factory, self._device)

    def get_clone_with_modified_time_discretization(
        self, td: TimeDiscretization
    ) -> "BrownianMotion":
        return BrownianMotion(td, self._num_factors, self._num_paths, self._seed,
                              self._factory, self._device)

    # ------------------------------------------------------------------
    def __eq__(self, other):
        return (
            isinstance(other, BrownianMotion)
            and self._td == other._td
            and self._num_factors == other._num_factors
            and self._num_paths == other._num_paths
            and self._seed == other._seed
        )

    def __hash__(self):
        return hash((self._td, self._num_factors, self._num_paths, self._seed))

    def __repr__(self):
        return (
            f"BrownianMotion(steps={self._td.get_number_of_time_steps()}, "
            f"factors={self._num_factors}, paths={self._num_paths}, "
            f"seed={self._seed}, device={self._device})"
        )

    # finmath-style aliases
    getBrownianIncrement = get_brownian_increment
    getTimeDiscretization = get_time_discretization
    getNumberOfFactors = get_number_of_factors
    getNumberOfPaths = get_number_of_paths
    getRandomVariableForConstant = get_random_variable_for_constant
    getCloneWithModifiedSeed = get_clone_with_modified_seed


def finmath_mersenne_increments(dts: np.ndarray, num_factors: int,
                                num_paths: int, seed: int,
                                dtype=np.float32) -> np.ndarray:
    """Bit-exact reconstruction of finmath-lib's
    ``BrownianMotionFromMersenneRandomNumbers`` increment realization:
    ``[steps, factors, paths]`` Brownian increments, increment
    ``(t, f, p) = AS241_icdf(u) * sqrt(dt_t)`` where the uniforms ``u``
    come from ONE sequential commons-math3 MersenneTwister stream consumed
    in finmath's loop order — path OUTER, then time, then factor
    (``doGenerateBrownianMotion()``; the reference injects this Brownian
    at LIBORMarketModelCalibrationTest.java:267). Because paths are
    independent subsequences of the stream, the first k paths of an
    n-path realization equal the k-path realization exactly.

    Generation is in float64 like finmath's; ``dtype=float32`` (default)
    reproduces what the device factory stores, ``float64`` the host leg.
    """
    dts = np.asarray(dts, dtype=np.float64)
    steps = len(dts)
    gen = HostRandomGenerator(seed, "finmath_mersenne")
    # one sequential stream, path-major: normals[p, t, f]
    z = gen.normals_f64(num_paths * steps * num_factors).reshape(
        num_paths, steps, num_factors)
    z *= np.sqrt(dts)[None, :, None]
    return np.ascontiguousarray(z.transpose(1, 2, 0)).astype(dtype)


class BrownianMotionFinmathMersenne:
    """BrownianMotion over the bit-exact finmath MersenneTwister
    realization (see ``finmath_mersenne_increments``), generated on the
    host; its random variables are uploaded to ``device`` (default
    ``select_device()``, resolved at first upload). The port's counterpart
    of the reference's primary configuration: host-Mersenne increments and
    the device vector type (ATM test :283)."""

    def __init__(self, time_discretization: TimeDiscretization,
                 num_factors: int, num_paths: int, seed: int,
                 factory=None, dtype=np.float32, device=None):
        self._td = time_discretization
        self._num_factors = int(num_factors)
        self._num_paths = int(num_paths)
        self._seed = int(seed)
        self._factory = factory
        self._dtype = dtype
        self._device = torch.device(device) if device is not None else None
        self._increments: Optional[np.ndarray] = None

    def _lazy_init(self) -> np.ndarray:
        if self._increments is None:
            steps = self._td.get_number_of_time_steps()
            dts = np.asarray([self._td.get_time_step(m) for m in range(steps)])
            self._increments = finmath_mersenne_increments(
                dts, self._num_factors, self._num_paths, self._seed,
                self._dtype)
        return self._increments

    @property
    def increments(self) -> np.ndarray:
        return self._lazy_init()

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def get_brownian_increment(self, time_index: int, factor: int = 0):
        inc = self._lazy_init()
        time = self._td.get_time(time_index + 1)
        if self._factory is not None:
            return self._factory.create_random_variable(time, inc[time_index, factor])
        # the constructor, not .of: the host array is uploaded
        return RandomVariableTorch(time, inc[time_index, factor],
                                   device=self._device)

    def get_time_discretization(self) -> TimeDiscretization:
        return self._td

    def get_number_of_factors(self) -> int:
        return self._num_factors

    def get_number_of_paths(self) -> int:
        return self._num_paths

    def get_seed(self) -> int:
        return self._seed

    def get_random_variable_for_constant(self, value: float):
        if self._factory is not None:
            return self._factory.create_random_variable(0.0, value)
        return RandomVariableTorch(0.0, value, device=self._device)

    def get_clone_with_modified_seed(self, seed: int) -> "BrownianMotionFinmathMersenne":
        return BrownianMotionFinmathMersenne(
            self._td, self._num_factors, self._num_paths, seed,
            self._factory, self._dtype, self._device)

    getBrownianIncrement = get_brownian_increment
    getTimeDiscretization = get_time_discretization
    getNumberOfFactors = get_number_of_factors
    getNumberOfPaths = get_number_of_paths
    getRandomVariableForConstant = get_random_variable_for_constant
    getCloneWithModifiedSeed = get_clone_with_modified_seed


class BrownianMotionHostRandom:
    """All-host Brownian motion: sequential native RNG (MT19937 or the
    java.util.Random LCG) + inverse-CDF normals, wrapped in the CPU float
    oracle type. This is the CPU baseline leg of every reference benchmark
    (BrownianMotionJavaRandom.java:40 and finmath's
    BrownianMotionFromMersenneRandomNumbers).
    """

    device = None

    def __init__(self, time_discretization: TimeDiscretization,
                 num_factors: int, num_paths: int, seed: int,
                 algorithm: str = "mersenne", factory=None):
        """``factory``: optional RandomVariable factory the increments are
        wrapped through; ``RandomVariableTorchFactory`` gives the
        reference's host-RNG-to-device bridge."""
        self._td = time_discretization
        self._num_factors = int(num_factors)
        self._num_paths = int(num_paths)
        self._seed = int(seed)
        self._algorithm = algorithm
        self._factory = factory
        self._increments: Optional[np.ndarray] = None

    def _lazy_init(self) -> np.ndarray:
        if self._increments is None:
            gen = HostRandomGenerator(self._seed, self._algorithm)
            steps = self._td.get_number_of_time_steps()
            out = np.empty((steps, self._num_factors, self._num_paths),
                           dtype=np.float32)
            for m in range(steps):
                stddev = float(np.sqrt(self._td.get_time_step(m)))
                for f in range(self._num_factors):
                    out[m, f] = gen.normals(self._num_paths, stddev)
            self._increments = out
        return self._increments

    @property
    def increments(self) -> np.ndarray:
        return self._lazy_init()

    def get_brownian_increment(self, time_index: int, factor: int = 0):
        inc = self._lazy_init()
        time = self._td.get_time(time_index + 1)
        if self._factory is not None:
            return self._factory.create_random_variable(time, inc[time_index, factor])
        return RandomVariableFloat.of(time, inc[time_index, factor])

    def get_time_discretization(self) -> TimeDiscretization:
        return self._td

    def get_number_of_factors(self) -> int:
        return self._num_factors

    def get_number_of_paths(self) -> int:
        return self._num_paths

    def get_seed(self) -> int:
        return self._seed

    def get_random_variable_for_constant(self, value: float):
        if self._factory is not None:
            return self._factory.create_random_variable(0.0, value)
        return RandomVariableFloat(0.0, value)

    def get_clone_with_modified_seed(self, seed: int) -> "BrownianMotionHostRandom":
        return BrownianMotionHostRandom(
            self._td, self._num_factors, self._num_paths, seed,
            self._algorithm, self._factory,
        )

    getBrownianIncrement = get_brownian_increment
    getTimeDiscretization = get_time_discretization
    getNumberOfFactors = get_number_of_factors
    getNumberOfPaths = get_number_of_paths
    getRandomVariableForConstant = get_random_variable_for_constant
    getCloneWithModifiedSeed = get_clone_with_modified_seed


class BrownianMotionTorchWithHostRandomVariable:
    """Hybrid leg: normals generated on the device, results pulled to the
    host and wrapped in the CPU float type — "RNG on GPU, simulation on
    CPU" (BrownianMotionCudaWithHostRandomVariable.java:54). The
    constructor seed is honoured (the reference hardcodes 1234, :171)."""

    device = None

    def __init__(self, time_discretization: TimeDiscretization,
                 num_factors: int, num_paths: int, seed: int, device=None):
        self._motion = BrownianMotion(time_discretization, num_factors,
                                      num_paths, seed, device=device)
        self._host: Optional[np.ndarray] = None

    def _lazy_init(self) -> np.ndarray:
        if self._host is None:
            self._host = self._motion.increments.cpu().numpy()
        return self._host

    @property
    def increments(self) -> np.ndarray:
        return self._lazy_init()

    def get_brownian_increment(self, time_index: int, factor: int = 0) -> RandomVariableFloat:
        inc = self._lazy_init()
        td = self._motion.get_time_discretization()
        return RandomVariableFloat.of(td.get_time(time_index + 1),
                                      inc[time_index, factor])

    def get_time_discretization(self) -> TimeDiscretization:
        return self._motion.get_time_discretization()

    def get_number_of_factors(self) -> int:
        return self._motion.get_number_of_factors()

    def get_number_of_paths(self) -> int:
        return self._motion.get_number_of_paths()

    def get_seed(self) -> int:
        return self._motion.get_seed()

    def get_random_variable_for_constant(self, value: float) -> RandomVariableFloat:
        return RandomVariableFloat(0.0, value)

    getBrownianIncrement = get_brownian_increment
    getTimeDiscretization = get_time_discretization
    getNumberOfFactors = get_number_of_factors
    getNumberOfPaths = get_number_of_paths


class BrownianMotionView:
    """A view selecting a subset of another BrownianMotion's factors.

    Equivalent of finmath-lib's BrownianMotionView used by the benchmark
    test to split factors between the LIBOR covariance and the stochastic
    volatility driver (ref. LIBORMarketModelCalibrationTest.java:268-269).
    """

    def __init__(self, brownian, factor_indices: Sequence[int]):
        self._parent = brownian
        self._factors = tuple(int(i) for i in factor_indices)

    @property
    def increments(self):
        return self._parent.increments[:, list(self._factors), :]

    @property
    def device(self):
        return self._parent.device

    def get_brownian_increment(self, time_index: int, factor: int = 0):
        return self._parent.get_brownian_increment(time_index, self._factors[factor])

    def get_time_discretization(self) -> TimeDiscretization:
        return self._parent.get_time_discretization()

    def get_number_of_factors(self) -> int:
        return len(self._factors)

    def get_number_of_paths(self) -> int:
        return self._parent.get_number_of_paths()

    def get_seed(self) -> int:
        return self._parent.get_seed()

    def get_random_variable_for_constant(self, value: float):
        return self._parent.get_random_variable_for_constant(value)

    def get_clone_with_modified_seed(self, seed: int) -> "BrownianMotionView":
        return BrownianMotionView(
            self._parent.get_clone_with_modified_seed(seed), self._factors
        )

    getBrownianIncrement = get_brownian_increment
    getTimeDiscretization = get_time_discretization
    getNumberOfFactors = get_number_of_factors
    getNumberOfPaths = get_number_of_paths
