"""finmath_tpu_torch — the PyTorch + CUDA port of finmath_tpu.

A second package beside ``finmath_tpu`` (the JAX reference, which it never
imports). Module paths and names mirror the JAX package so every part has
an obvious counterpart; ``TPU`` in a class name becomes ``Torch``.

Ported so far (slice A, the LMM ATM swaption calibration, and slice B,
the reference's stoch-vol benchmark calibration):

* ``models.time_discretization``, ``models.curves``, ``models.calibration``
  — host-side NumPy, copied from the reference package;
* ``native.host_rng`` and ``models.brownian_motion`` (the finmath
  Mersenne realization only) — the reference benchmark's own random
  stream, bit for bit;
* ``models.lmm`` — covariance (incl. the 5-parameter, blended and
  stochastic-volatility models), the LMM valuation engine, the analytic
  approximation, both kernel calibration backends, and the ATM and
  benchmark workloads;
* ``ops.lmm_kernel`` and ``ops.lmm_stochvol_kernel`` — the ATM-surface
  and stoch-vol path-sweep kernels (CUDA C++ in ``csrc/``) and their plain
  PyTorch versions;
* ``convert`` — parameter vectors and Brownian realizations carried over
  from the JAX package as NumPy arrays.

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

from .utils.config import select_device  # noqa: E402

__all__ = ["select_device"]
