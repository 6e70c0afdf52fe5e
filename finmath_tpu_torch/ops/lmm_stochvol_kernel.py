"""The stoch-vol LMM path sweep: the CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by device.

Counterpart of ``finmath_tpu/ops/lmm_stochvol_kernel.py::
lmm_stochvol_swaptions_batch`` (the Pallas kernel ``_sv_kernel_products``).
The kernel itself is ``csrc/lmm_stochvol_products.cu``; its header says how
it maps the sweep onto Hopper and what bounds it.

``lmm_stochvol_swaptions_batch`` returns float64 PATH SUMS ``[B, P]`` of
the discounted payoffs payoff / N, non-finite pathwise values dropped, for
``B`` parameter sets that share one normal realization. (The Pallas kernel
returns the per-path values and its caller masks and sums them; here that
reduction happens in the kernel.) The caller divides by ``num_paths``. On a
CUDA tensor it launches the kernel (and raises if the launch fails); on a
CPU tensor it runs ``lmm_stochvol_swaptions_batch_reference``. ``LAUNCHES``
counts kernel launches.

Inputs keep the engine's layout:

* ``z`` ``[S * (F + 1), num_paths]`` float32, row ``s * (F + 1) + f`` the
  normal of factor ``f`` at step ``s``, row ``s * (F + 1) + F`` the driver
  of the scaling process (``S`` = the last exercise step);
* ``volT_b`` ``[B, F * n, S]`` float32, ``sigma_i(t_s) * R[i, f]`` at row
  ``f * n + i``;
* ``scal_b`` ``[B, 8]`` float32: ``[dt, sqrt_dt, blend, nu, rho,
  sqrt(1 - rho^2), 0, 0]``; the diffusion is ``lambda * (sqrt_dt * z)``;
* ``initial_forwards``, ``deltas`` ``[n]`` float32;
* ``products``: ``(exercise index, periods, strike)`` per product, grouped
  by ascending exercise index.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import _cuda_build
from ._products import Product, check_products, check_tensor, product_tables

SOURCE = "lmm_stochvol_products.cu"
TILE = 128                    # paths per block, one thread per path
MAX_FACTORS = 8               # kMaxFactors in the CUDA source
LOG_V_CAP = 13.815511         # log(1e6), the engine's cap of V

#: kernel launches since the last reset (plain integer; a run resets it
#: and reads it to show that its main path went through the kernel)
LAUNCHES = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lmm_stochvol_products_launch.argtypes = (
        [ptr, ctypes.c_longlong] + [ptr] * 8 + [i32] * 6 + [ptr])
    lib.lmm_stochvol_products_launch.restype = i32
    lib.lmm_stochvol_products_error_string.argtypes = [i32]
    lib.lmm_stochvol_products_error_string.restype = ctypes.c_char_p
    lib.lmm_stochvol_products_max_factors.restype = i32
    if lib.lmm_stochvol_products_max_factors() != MAX_FACTORS:
        raise RuntimeError("lmm_stochvol_products.cu and "
                           "lmm_stochvol_kernel.py disagree on the factor "
                           "bound")
    return lib


def load_kernel() -> None:
    """Build and load the kernel's library (first use only)."""
    _library()


def lmm_stochvol_swaptions_batch(z, volT_b, scal_b, initial_forwards, deltas,
                                 *, num_libors: int, num_factors: int,
                                 products: Sequence[Product],
                                 num_paths: int) -> torch.Tensor:
    """Float64 path sums ``[B, P]`` (see the module docstring)."""
    global LAUNCHES
    n, F = int(num_libors), int(num_factors)
    products = tuple((int(e), int(m), float(k)) for e, m, k in products)
    S = check_products(products, n)
    device = z.device
    B = int(volT_b.shape[0])
    check_tensor("z", z, (S * (F + 1), num_paths), torch.float32, device)
    check_tensor("volT_b", volT_b, (B, F * n, S), torch.float32, device)
    check_tensor("scal_b", scal_b, (B, 8), torch.float32, device)
    check_tensor("initial_forwards", initial_forwards, (n,), torch.float32,
                 device)
    check_tensor("deltas", deltas, (n,), torch.float32, device)
    if B < 1:
        raise ValueError("at least one parameter set is required")
    if device.type == "cpu":
        return lmm_stochvol_swaptions_batch_reference(
            z, volT_b, scal_b, initial_forwards, deltas, num_libors=n,
            num_factors=F, products=products, num_paths=num_paths)
    if device.type != "cuda":
        raise ValueError(f"lmm_stochvol_swaptions_batch: unsupported device "
                         f"{device}")
    if not 1 <= F <= MAX_FACTORS:
        raise ValueError(f"num_factors={F} outside the kernel's 1.."
                         f"{MAX_FACTORS}")
    P = len(products)
    tables = product_tables(products, device)
    tiles = -(-num_paths // TILE)
    partials = torch.empty((B, tiles, P), dtype=torch.float64, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lmm_stochvol_products_launch(
            z.data_ptr(), num_paths, volT_b.data_ptr(), scal_b.data_ptr(),
            initial_forwards.data_ptr(), deltas.data_ptr(),
            tables.step_first.data_ptr(), tables.periods.data_ptr(),
            tables.strikes.data_ptr(), partials.data_ptr(), n, F, S, P, num_paths, B, stream)
    if err != 0:
        msg = lib.lmm_stochvol_products_error_string(err).decode()
        raise RuntimeError(f"lmm_stochvol_products launch failed: {msg} "
                           f"({err})")
    LAUNCHES += 1
    return partials.sum(dim=1)


def lmm_stochvol_swaptions_batch_reference(z, volT_b, scal_b,
                                           initial_forwards, deltas, *,
                                           num_libors: int, num_factors: int,
                                           products: Sequence[Product],
                                           num_paths: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: a Python loop over
    steps, vectorised over ``[B, libors, paths]``, with the kernel's float32
    arithmetic (prefix sums via ``cumsum``/``cumprod``) and a finite-masked
    float64 path sum."""
    n, F = int(num_libors), int(num_factors)
    products = tuple((int(e), int(m), float(k)) for e, m, k in products)
    S = check_products(products, n)
    B = volT_b.shape[0]
    z = z[:, :num_paths]
    by_step = {}
    for k, (e, m, strike) in enumerate(products):
        by_step.setdefault(e, []).append((k, m, strike))
    dt, sqrt_dt, blend, nu, rho, somega = (scal_b[:, j, None, None]
                                           for j in range(6))
    d = deltas[None, :, None]                                   # [1, n, 1]
    L0 = initial_forwards[None, :, None]

    L = L0.expand(B, n, num_paths)
    N = torch.ones((B, num_paths), dtype=torch.float32, device=z.device)
    logV = torch.zeros((B, 1, num_paths), dtype=torch.float32,
                       device=z.device)
    rows = [None] * len(products)
    for s in range(S + 1):
        for k, m, strike in by_step.get(s, ()):
            dd = d[:, s:s + m]
            cp = torch.cumprod(1.0 / (1.0 + dd * L[:, s:s + m]), dim=1)
            ann = torch.cumsum(cp * dd, dim=1)[:, -1]
            payoff = torch.clamp_min(
                1.0 - cp[:, -1] - float(np.float32(strike)) * ann, 0.0)
            rows[k] = payoff / N
        if s == S:
            break
        zs = z[s * (F + 1):(s + 1) * (F + 1)]                   # [F+1, paths]
        N = N * (1.0 + deltas[s] * L[:, s])
        Lt = L[:, s + 1:]                                       # alive
        dt_ = d[:, s + 1:]
        lf = ((1.0 - blend) * Lt + blend * L0[:, s + 1:]) * torch.exp(
            0.5 * logV)
        mt = dt_ / (1.0 + dt_ * Lt)
        mu = torch.zeros_like(Lt)
        diffusion = torch.zeros_like(Lt)
        for f in range(F):
            lam = volT_b[:, f * n + s + 1:(f + 1) * n, s, None] * lf
            mu = mu + lam * torch.cumsum(mt * lam, dim=1)
            diffusion = diffusion + lam * (sqrt_dt * zs[f])
        L = torch.cat(
            [L[:, :s + 1], torch.clamp(Lt + mu * dt + diffusion, -1e3, 1e3)],
            dim=1)
        dw_v = sqrt_dt * (rho * zs[0] + somega * zs[F])
        logV = torch.clamp_max(logV + nu * dw_v - 0.5 * nu * nu * dt,
                               LOG_V_CAP)
    paid = torch.stack(rows, dim=1)                             # [B, P, paths]
    paid = torch.where(torch.isfinite(paid), paid, 0.0).to(torch.float64)
    return paid.sum(dim=-1)
