"""finmath_tpu_torch — the PyTorch + CUDA port of finmath_tpu.

A second package beside ``finmath_tpu`` (the JAX reference, which it never
imports). Module paths and names mirror the JAX package so every part has
an obvious counterpart; ``TPU`` in a class name becomes ``Torch``.

Ported so far (slice A, the LMM ATM swaption calibration; slice B, the
reference's stoch-vol benchmark calibration; slice C, the vector engine
and Monte-Carlo Black-Scholes; slice D1, the single-swaption pricers; and
the Longstaff-Schwartz, tape-AAD and lazy-engine slice):

* ``models.time_discretization``, ``models.curves``, ``models.calibration``
  — host-side NumPy, copied from the reference package;
* ``native.host_rng`` and ``models.brownian_motion`` (the finmath
  Mersenne realization only) — the reference benchmark's own random
  stream, bit for bit;
* ``models.lmm`` — covariance (incl. the 5-parameter, blended and
  stochastic-volatility models), the LMM valuation engine, the analytic
  approximation, both kernel calibration backends, the ATM and
  benchmark workloads, the Bermudan swaption (Longstaff-Schwartz with
  duality bounds), caps and floors, the eager factory-injected swaption
  valuation, and the exposure and XVA layer (``models.lmm.exposure``);
* ``models.sabr``, ``models.caps`` and ``models.cube`` — the smile layer:
  SABR and its Monte-Carlo smile, caplet stripping, the swaption cube and
  CMS replication;
* ``ops.random_variable`` and ``ops.random_variable_float`` — the vector
  engine and its float oracle; ``ops.conditional_expectation`` (the
  regression estimator), ``ops.aad`` (tape AAD) and ``ops.lazy`` (recorded
  operations flushed as one CUDA graph per structure);
* ``models.black_scholes`` — Monte-Carlo Black-Scholes, including a
  price that ``torch.autograd`` differentiates;
* ``ops.lmm_kernel`` and ``ops.lmm_stochvol_kernel`` — the ATM-surface
  and stoch-vol path-sweep kernels (CUDA C++ in ``csrc/``) and their plain
  PyTorch versions; ``ops.black_residuals``, the stoch-vol backend's Black
  implied-vol Newton and weighting as one CUDA kernel;
* ``convert`` — parameter vectors and Brownian realizations carried over
  from the JAX package as NumPy arrays;
* ``parallel`` — the Monte-Carlo path axis split over torch.distributed
  ranks (``mesh=`` on the LMM engine, both calibrations, the Euler scheme
  and the equity facades, the regression and ``RandomVariableTorch``),
  and ``parallel.launch``, which runs a function on every rank of a world
  of child processes.

Precision policy (unchanged from the reference): path data is float32;
reductions, parameters and implied-vol inversion are float64. TF32 is
switched off for matrix products and cuDNN so float32 contractions stay
float32-exact, the counterpart of JAX's ``jax_default_matmul_precision=
"highest"``. Importing this package sets those three process-wide flags.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from .ops.lazy import (RandomVariableTorchLazy,  # noqa: E402
                       RandomVariableTorchLazyFactory, averages, flush)
from .ops.random_variable import (RandomVariable,  # noqa: E402
                                  RandomVariableTorch,
                                  RandomVariableTorchFactory)
from .ops.random_variable_float import (RandomVariableFloat,  # noqa: E402
                                        RandomVariableFloatFactory)
from .utils.config import select_device  # noqa: E402

__all__ = [
    "RandomVariable",
    "RandomVariableTorch",
    "RandomVariableTorchFactory",
    "RandomVariableTorchLazy",
    "RandomVariableTorchLazyFactory",
    "RandomVariableFloat",
    "RandomVariableFloatFactory",
    "averages",
    "flush",
    "select_device",
]
