"""The stoch-vol kernel backend's Black implied-volatility inversion and
the weighted residuals after it: the CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by device.

``black_residuals(values, forward, strike, maturity, annuity, target,
weight, num_iter)`` returns the float64 residual rows ``[B, P]``,
``weight * (black_implied_vol(values, forward, strike, maturity, annuity,
num_iter) - target)``, for the products' values ``[B, P]`` (discounted,
per unit of notional: what the products kernel's path sums give over the
paths), the per-product float64 rows ``[P]`` (forward swap rate, strike,
expiry, annuity, target quote and weight) and the Newton's step count
(the backend passes ``models.lmm.model.BLACK_NEWTON_STEPS``, the engine's
default). On a CUDA tensor it launches
the kernel (and raises if the launch fails) on the current stream and
returns without synchronising; on a CPU tensor it runs
``black_residuals_reference``, which is that composition itself.
``LAUNCHES`` counts kernel launches.

The kernel is ``csrc/black_residuals.cu``; its header holds the
arithmetic, which is ``models.lmm.model._BlackImpliedVol.forward``'s step
for step (the same seed, twin, clamps, damping, bounds and zero), built
without FMA contraction (``_products.SWEEP_FLAGS``) so that each float64
operation rounds once, as each launch of the composition does. It maps
onto the H100 as one thread an element, 64 threads a block: the
backend's calls hold 15 elements (B = 1) or 255 (the 17 parameter sets of
the central-difference Jacobian), so a launch is one to four blocks, and
every one of the 60 damped Newton steps stays in registers. What bounds
it is latency, one thread's chain of 60 dependent steps of two ``erfc``,
one ``exp``, two divisions and about 20 other float64 operations; the
card's float64 rate would take the whole launch's work in under a
microsecond. On an H100 80GB HBM3 (700 W) a launch takes 0.075 ms at
both shapes (``chip_smoke.py`` phase 9), where the composition's about
2,100 element-wise launches a call took 21-32 ms of host dispatch.

Only the backend takes this path. ``LMMValuationEngine`` inverts through
``black_implied_vol``, whose implicit-derivative ``jvp`` and ``vmap``
rule a launch cannot carry; the two share the arithmetic's definition
through the tests. The kernel uses no buffer but its output, allocated a
call, so calls from several threads are safe.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _cuda_build
from ._products import SWEEP_FLAGS

SOURCE = "black_residuals.cu"
FLAGS = SWEEP_FLAGS

#: kernel launches since the last reset (plain integer; a run resets it
#: and reads it to show that its main path went through the kernel);
#: counted under a lock, since a backend may be called from several threads
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE, (), FLAGS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.black_residuals_launch.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    lib.black_residuals_launch.restype = i32
    lib.black_residuals_error_string.argtypes = [i32]
    lib.black_residuals_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> None:
    """Build and load the kernel's library (first use only)."""
    _library()


def _check(name, t, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, values on {device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def black_residuals(values, forward, strike, maturity, annuity, target,
                    weight, num_iter: int) -> torch.Tensor:
    """Float64 residual rows ``[B, P]`` (see the module docstring)."""
    global LAUNCHES
    if not isinstance(values, torch.Tensor) or values.dim() != 2:
        raise ValueError("values must be a [B, P] tensor")
    B, P = values.shape
    if B < 1 or P < 1:
        raise ValueError(f"values of shape {(B, P)}: at least one parameter "
                         "set and one product are required")
    device = values.device
    _check("values", values, (B, P), device)
    rows = dict(forward=forward, strike=strike, maturity=maturity,
                annuity=annuity, target=target, weight=weight)
    for name, t in rows.items():
        _check(name, t, (P,), device)
    if device.type == "cpu":
        return black_residuals_reference(values, forward, strike, maturity,
                                         annuity, target, weight, num_iter)
    if device.type != "cuda":
        raise ValueError(f"black_residuals: unsupported device {device}")
    lib = _library()
    out = torch.empty_like(values)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.black_residuals_launch(
            values.data_ptr(), forward.data_ptr(), strike.data_ptr(),
            maturity.data_ptr(), annuity.data_ptr(), target.data_ptr(),
            weight.data_ptr(), out.data_ptr(), B, P, num_iter, stream)
    if err != 0:
        msg = lib.black_residuals_error_string(err).decode()
        raise RuntimeError(f"black_residuals launch failed: {msg} ({err})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out


def black_residuals_reference(values, forward, strike, maturity, annuity,
                              target, weight, num_iter: int) -> torch.Tensor:
    """Plain PyTorch version on any device: the valuation engine's own
    inversion and weighting, ``weight * (black_implied_vol(...) -
    target)``."""
    # imported here: the model's package imports the kernel backend,
    # which imports this module
    from ..models.lmm.model import black_implied_vol

    return weight * (black_implied_vol(values, forward, strike, maturity,
                                       annuity, num_iter) - target)
