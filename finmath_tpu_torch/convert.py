"""State carried over from the JAX package, as NumPy arrays.

The JAX package's "weights" for the LMM calibration are the covariance
parameter vector and the Brownian realization. A parameter vector that
``finmath_tpu`` calibrated revalues in the port through
``params_from_numpy``; a realization in the JAX engine's injected format
(``[steps, factors, paths]``, already scaled by sqrt(dt)) drives the
port's engine through ``increments_from_numpy``, so both packages price
the same paths.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(x, device=None) -> torch.Tensor:
    """A parameter vector as a float64 tensor (on ``device``, default CPU)."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
        device if device is not None else "cpu").clone()


def params_to_numpy(x) -> np.ndarray:
    """A parameter tensor (any device) as a float64 NumPy vector."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float64)


def increments_from_numpy(inc, device) -> torch.Tensor:
    """Injected Brownian increments ``[S, F, paths]`` (sqrt(dt)-scaled, the
    JAX engine's format) as a float32 tensor on ``device``."""
    inc = np.asarray(getattr(inc, "increments", inc))
    if inc.ndim != 3:
        raise ValueError(f"increments must be [steps, factors, paths], got "
                         f"shape {inc.shape}")
    return torch.as_tensor(inc.astype(np.float32, copy=False)).to(device)
