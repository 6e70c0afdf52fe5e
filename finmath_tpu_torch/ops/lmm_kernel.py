"""The ATM-surface LMM path sweep: the CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by device.

Counterpart of ``finmath_tpu/ops/lmm_kernel.py::lmm_atm_swaptions_batch``
(the Pallas kernel ``_normal_lmm_kernel_products``). The kernel itself is
``csrc/lmm_atm_products.cu``; its header says how it maps the sweep onto
Hopper and what bounds it.

``lmm_atm_swaptions_batch`` returns float64 PATH SUMS ``[B, P + E]``: rows
``[0, P)`` sum payoff / numeraire per product, rows ``[P, P + E)`` sum
1 / numeraire per exercise event, for ``B`` parameter sets that share one
normal realization. The caller divides by ``num_paths`` and applies the
numeraire adjustment. On a CUDA tensor it launches the kernel (and raises
if the launch fails); on a CPU tensor it runs
``lmm_atm_swaptions_batch_reference``. ``LAUNCHES`` counts kernel launches.

Inputs keep the engine's layout:

* ``z`` ``[S * F, num_paths]`` float32, row ``s * F + f`` the normal of
  factor ``f`` at step ``s`` (``S`` = the last exercise step);
* ``volT_b`` ``[B, F * n, S]`` float32, ``sigma_i(t_s) * R[i, f]`` at row
  ``f * n + i``;
* ``scal_b`` ``[B, 8]`` float32: ``[dt, sqrt_dt, displacement, 0, ...]``;
  the diffusion is ``lambda * (sqrt_dt * z)``;
* ``initial_forwards``, ``deltas`` ``[n]`` float32;
* ``products``: ``(exercise index, periods, strike)`` per product, grouped
  by exercise index in ascending order; ``events``: the ascending exercise
  indices, exactly those of the products.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _cuda_build
from ._products import Product, check_products, check_tensor, product_tables

SOURCE = "lmm_atm_products.cu"
TILE = 128                    # paths per block, one thread per path
MAX_FACTORS = 8               # kMaxFactors in the CUDA source

#: kernel launches since the last reset (plain integer; a run resets it
#: and reads it to show that its main path went through the kernel)
LAUNCHES = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lmm_atm_products_launch.argtypes = (
        [ptr, ctypes.c_longlong] + [ptr] * 9 + [i32] * 8 + [ptr])
    lib.lmm_atm_products_launch.restype = i32
    lib.lmm_atm_products_error_string.argtypes = [i32]
    lib.lmm_atm_products_error_string.restype = ctypes.c_char_p
    lib.lmm_atm_products_max_factors.restype = i32
    if lib.lmm_atm_products_max_factors() != MAX_FACTORS:
        raise RuntimeError("lmm_atm_products.cu and lmm_kernel.py disagree "
                           "on the factor bound")
    return lib


def load_kernel() -> None:
    """Build and load the kernel's library (first use only)."""
    _library()


def _check_layout(products: Sequence[Product], events: Sequence[int],
                  num_libors: int) -> int:
    """Validate the product/event packing; returns the step count S."""
    S = check_products(products, num_libors)
    if list(events) != sorted({e for e, _, _ in products}):
        raise ValueError("events must be the products' ascending exercise "
                         "indices")
    return S


@functools.lru_cache(maxsize=8)
def _step_events(events: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """[S+1] int32: the event ordinal of each step, -1 where none."""
    step_event = np.full(events[-1] + 1, -1, np.int32)
    for j, e in enumerate(events):
        step_event[e] = j
    return torch.from_numpy(step_event).to(device)


def lmm_atm_swaptions_batch(z, volT_b, scal_b, initial_forwards, deltas, *,
                            num_libors: int, num_factors: int,
                            products: Sequence[Product],
                            events: Sequence[int], displaced: bool,
                            num_paths: int) -> torch.Tensor:
    """Float64 path sums ``[B, P + E]`` (see the module docstring)."""
    global LAUNCHES
    n, F = int(num_libors), int(num_factors)
    products = tuple((int(e), int(m), float(k)) for e, m, k in products)
    events = tuple(int(e) for e in events)
    S = _check_layout(products, events, n)
    device = z.device
    B = int(volT_b.shape[0])
    check_tensor("z", z, (S * F, num_paths), torch.float32, device)
    check_tensor("volT_b", volT_b, (B, F * n, S), torch.float32, device)
    check_tensor("scal_b", scal_b, (B, 8), torch.float32, device)
    check_tensor("initial_forwards", initial_forwards, (n,), torch.float32,
                 device)
    check_tensor("deltas", deltas, (n,), torch.float32, device)
    if B < 1:
        raise ValueError("at least one parameter set is required")
    if device.type == "cpu":
        return lmm_atm_swaptions_batch_reference(
            z, volT_b, scal_b, initial_forwards, deltas, num_libors=n,
            num_factors=F, products=products, events=events,
            displaced=displaced, num_paths=num_paths)
    if device.type != "cuda":
        raise ValueError(f"lmm_atm_swaptions_batch: unsupported device "
                         f"{device}")
    if not 1 <= F <= MAX_FACTORS:
        raise ValueError(f"num_factors={F} outside the kernel's 1.."
                         f"{MAX_FACTORS}")
    P, E = len(products), len(events)
    # a curve or row count that needs more shared memory per block than the
    # card allows fails in the launcher's cudaFuncSetAttribute, raised below
    step_event = _step_events(events, device)
    tables = product_tables(products, device)
    tiles = -(-num_paths // TILE)
    partials = torch.empty((B, tiles, P + E), dtype=torch.float64,
                           device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lmm_atm_products_launch(
            z.data_ptr(), num_paths, volT_b.data_ptr(), scal_b.data_ptr(),
            initial_forwards.data_ptr(), deltas.data_ptr(),
            step_event.data_ptr(), tables.step_first.data_ptr(),
            tables.periods.data_ptr(), tables.strikes.data_ptr(),
            partials.data_ptr(), n, F, S, P, E,
            num_paths, B, int(bool(displaced)), stream)
    if err != 0:
        msg = lib.lmm_atm_products_error_string(err).decode()
        raise RuntimeError(f"lmm_atm_products launch failed: {msg} ({err})")
    LAUNCHES += 1
    return partials.sum(dim=1)


def lmm_atm_swaptions_batch_reference(z, volT_b, scal_b, initial_forwards,
                                      deltas, *, num_libors: int,
                                      num_factors: int,
                                      products: Sequence[Product],
                                      events: Sequence[int], displaced: bool,
                                      num_paths: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: a Python loop over
    steps, vectorised over ``[B, libors, paths]``, with the kernel's float32
    arithmetic (sequential prefix sums via ``cumsum``/``cumprod``) and a
    float64 path sum."""
    n, F = int(num_libors), int(num_factors)
    products = tuple((int(e), int(m), float(k)) for e, m, k in products)
    events = tuple(int(e) for e in events)
    S = _check_layout(products, events, n)
    B = volT_b.shape[0]
    z = z[:, :num_paths]
    by_step = {}
    for k, (e, m, strike) in enumerate(products):
        by_step.setdefault(e, []).append((k, m, strike))
    ev_of_step = {e: j for j, e in enumerate(events)}
    dt = scal_b[:, 0, None, None]
    sqrt_dt = scal_b[:, 1, None, None]
    disp = scal_b[:, 2, None, None]
    d = deltas[None, :, None]                                   # [1, n, 1]

    L = initial_forwards[None, :, None].expand(B, n, num_paths)
    N = torch.ones((B, num_paths), dtype=torch.float32, device=z.device)
    rows = [None] * (len(products) + len(events))
    P = len(products)
    for s in range(S + 1):
        if s in by_step:
            inv_n = 1.0 / N
            rows[P + ev_of_step[s]] = inv_n
            for k, m, strike in by_step[s]:
                dd = d[:, s:s + m]
                cp = torch.cumprod(1.0 / (1.0 + dd * L[:, s:s + m]), dim=1)
                ann = torch.cumsum(cp * dd, dim=1)[:, -1]
                payoff = torch.clamp_min(
                    1.0 - cp[:, -1] - float(np.float32(strike)) * ann, 0.0)
                rows[k] = payoff * inv_n
        if s == S:
            break
        N = N * (1.0 + deltas[s] * L[:, s])
        Lt = L[:, s + 1:]                                       # alive
        dt_ = d[:, s + 1:]
        mt = dt_ / (1.0 + dt_ * Lt)
        mu = torch.zeros_like(Lt)
        diffusion = torch.zeros_like(Lt)
        for f in range(F):
            base = volT_b[:, f * n + s + 1:(f + 1) * n, s, None]  # [B, n', 1]
            lam = base * (Lt + disp) if displaced else base
            mu = mu + lam * torch.cumsum(mt * lam, dim=1)
            diffusion = diffusion + lam * (sqrt_dt * z[s * F + f])
        L = torch.cat(
            [L[:, :s + 1], torch.clamp(Lt + mu * dt + diffusion, -1e3, 1e3)],
            dim=1)
    sums = torch.stack(rows, dim=1).to(torch.float64)           # [B, R, paths]
    return sums.sum(dim=-1)
