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

A launch carries one path a thread; the wrapper packs the parameter sets
as a block stages them (``_packed``) and launches the ``(K, F, R)``
instantiation of the source for the shape, built by ``nvcc`` at first use
(``_products.sweep_variant``), without FMA contraction
(``_products.SWEEP_FLAGS``). The plain version takes the kernel's running
sums in its order (``_products.running_sums``, ``bond_prefix``), so the
two agree bit for bit on the card; ``lmm_atm_swaptions_partials_reference``
gives the partials ``[B, tiles, P + E]`` a launch writes, in the kernel's
order of float64 additions (``_products.tile_partials``).

The single-swaption pricer of the same model at one factor, counterpart of
``lmm_swaption_kernel`` and ``lmm_swaption_kernel_with_normals`` (the
Pallas kernel ``_lmm_kernel``, with the on-core PRNG and on injected
normals), is here too: its kernels are ``csrc/lmm_swaption_paths.cu``,
built and counted by ``ops/_swaption_paths.py`` (``LAUNCHES`` there, per
launcher). Each returns the float64 mean of payoff / N(T_e) as a 0-d
tensor; ``lmm_swaption_payoffs`` and ``lmm_swaption_payoffs_injected``
give the float32 value of each path (the kernel on a CUDA device, the
plain version on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.config import select_device
from ..utils.profiling import span
from . import _cuda_build
from . import _swaption_paths as sp
from ._products import (MAX_LIBORS, SWEEP_FLAGS, THREADS, Product,
                        bond_prefix, check_products, check_tensor,
                        pack_parameter_sets, product_tables, running_sums,
                        sweep_defines, sweep_variant, tile_partials)
from .kernels import _check_seed, normal_pairs

SOURCE = "lmm_atm_products.cu"
FLAGS = SWEEP_FLAGS
MAX_FACTORS = 8               # kMaxFactors in csrc/lmm_sweep.cuh

#: kernel launches since the last reset (plain integer; a run resets it
#: and reads it to show that its main path went through the kernel)
LAUNCHES = 0


@functools.cache
def _library(K: int, F: int, R: int) -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE, sweep_defines(K, F, R), FLAGS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lmm_atm_products_launch.argtypes = (
        [ptr, ctypes.c_longlong, ptr, i32] + [ptr] * 6 + [i32] * 7 + [ptr])
    lib.lmm_atm_products_launch.restype = i32
    lib.lmm_atm_products_error_string.argtypes = [i32]
    lib.lmm_atm_products_error_string.restype = ctypes.c_char_p
    lib.lmm_atm_products_variant.argtypes = [i32]
    lib.lmm_atm_products_variant.restype = i32
    if [lib.lmm_atm_products_variant(j) for j in range(3)] != [K, F, R]:
        raise RuntimeError(f"{SOURCE}: the library is not the instantiation "
                           f"K={K}, F={F}, R={R}")
    return lib


def load_kernel(*variants: Tuple[int, int, int]) -> None:
    """Build and load the kernel's library for each ``(K, F, R)`` of
    ``variants`` (``_products.sweep_variant``; first use only)."""
    for v in variants:
        _library(*v)


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


def _packed(volT_b, scal_b, initial_forwards, deltas, F):
    """The parameter sets as a block stages them: per libor (L0, delta)."""
    return pack_parameter_sets(volT_b, scal_b, (initial_forwards, deltas),
                               num_factors=F)


def lmm_atm_swaptions_batch(z, volT_b, scal_b, initial_forwards, deltas, *,
                            num_libors: int, num_factors: int,
                            products: Sequence[Product],
                            events: Sequence[int], displaced: bool,
                            num_paths: int) -> torch.Tensor:
    """Float64 path sums ``[B, P + E]`` (see the module docstring)."""
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
    if not 1 <= F <= MAX_FACTORS or n > MAX_LIBORS:
        raise ValueError(f"num_factors={F}, num_libors={n} outside the "
                         f"kernel's 1..{MAX_FACTORS} factors and "
                         f"{MAX_LIBORS} libors")
    go, partials = prepare(
        z, volT_b, scal_b, initial_forwards, deltas, num_libors=n,
        num_factors=F, products=products, events=events, displaced=displaced,
        num_paths=num_paths)
    go()
    return partials.sum(dim=1)


def prepare(z, volT_b, scal_b, initial_forwards, deltas, *, num_libors: int,
            num_factors: int, products: Sequence[Product],
            events: Sequence[int], displaced: bool, num_paths: int):
    """Pack the parameter sets and allocate the partials ``[B, tiles, P +
    E]`` of a launch; returns ``(go, partials)``, ``go()`` enqueuing the
    launch alone."""
    n, F = num_libors, num_factors
    B, device = volT_b.shape[0], z.device
    products, events = tuple(products), tuple(events)
    packed = _packed(volT_b, scal_b, initial_forwards, deltas, F)
    tables = product_tables(products, device)
    step_event = _step_events(events, device)
    tiles = -(-num_paths // THREADS)
    partials = torch.empty((B, tiles, len(products) + len(events)),
                           dtype=torch.float64, device=device)
    variant = sweep_variant(n, F)

    def go():
        launch(z, packed, tables, step_event, partials, n=n,
               S=products[-1][0], num_paths=num_paths, displaced=displaced,
               variant=variant)

    return go, partials


def launch(z, packed, tables, step_event, partials, *, n: int, S: int,
           num_paths: int, displaced: bool,
           variant: Tuple[int, int, int]) -> None:
    """One launch of the instantiation ``variant`` on packed parameter sets
    (``_packed``) into ``partials`` ``[B, tiles, P + E]``, on the current
    stream; raises if it fails (a table or row count that needs more
    shared memory than a block may have, or a ``packed`` that is not
    16-byte aligned with a width a multiple of 4 floats, fails here too).
    Counted in ``LAUNCHES``."""
    global LAUNCHES
    lib = _library(*variant)
    B, width = packed.shape
    P = tables.periods.shape[0]
    device = z.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lmm_atm_products_launch(
            z.data_ptr(), num_paths, packed.data_ptr(), width,
            step_event.data_ptr(), tables.step_first.data_ptr(),
            tables.order.data_ptr(), tables.periods.data_ptr(),
            tables.strikes.data_ptr(), partials.data_ptr(), n, S, P,
            partials.shape[2] - P, num_paths, B, int(bool(displaced)),
            stream)
    if err != 0:
        msg = lib.lmm_atm_products_error_string(err).decode()
        raise RuntimeError(f"lmm_atm_products launch failed: {msg} ({err})")
    LAUNCHES += 1


def lmm_atm_swaptions_batch_reference(z, volT_b, scal_b, initial_forwards,
                                      deltas, *, num_libors: int,
                                      num_factors: int,
                                      products: Sequence[Product],
                                      events: Sequence[int], displaced: bool,
                                      num_paths: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: a Python loop over
    steps, vectorised over ``[B, libors, paths]``, with the kernel's float32
    arithmetic and its order of additions (``running_sums``,
    ``bond_prefix``) and a float64 path sum."""
    return _path_values(z, volT_b, scal_b, initial_forwards, deltas,
                        num_libors=num_libors, num_factors=num_factors,
                        products=products, events=events,
                        displaced=displaced, num_paths=num_paths).sum(dim=-1)


def lmm_atm_swaptions_partials_reference(z, volT_b, scal_b,
                                         initial_forwards, deltas, *,
                                         num_libors: int, num_factors: int,
                                         products: Sequence[Product],
                                         events: Sequence[int],
                                         displaced: bool,
                                         num_paths: int) -> torch.Tensor:
    """The float64 partials ``[B, tiles, P + E]`` of one launch (what
    ``prepare``'s ``go()`` writes), from the plain version's path values in
    the kernel's order of additions (``_products.tile_partials``)."""
    return tile_partials(_path_values(
        z, volT_b, scal_b, initial_forwards, deltas, num_libors=num_libors,
        num_factors=num_factors, products=products, events=events,
        displaced=displaced, num_paths=num_paths))


def _path_values(z, volT_b, scal_b, initial_forwards, deltas, *,
                 num_libors: int, num_factors: int,
                 products: Sequence[Product], events: Sequence[int],
                 displaced: bool, num_paths: int) -> torch.Tensor:
    """The plain version's float64 value of every row and path, ``[B, P +
    E, num_paths]``."""
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
    libor = torch.arange(n, device=z.device)[:, None]

    L = initial_forwards[None, :, None].expand(B, n, num_paths)
    N = torch.ones((B, num_paths), dtype=torch.float32, device=z.device)
    rows = [None] * (len(products) + len(events))
    P = len(products)
    for s in range(S + 1):
        if s in by_step:
            inv_n = 1.0 / N
            rows[P + ev_of_step[s]] = inv_n
            last = s + max(m for _, m, _ in by_step[s]) - 1
            cp, ann = bond_prefix(L, d, s, last)
            for k, m, strike in by_step[s]:
                payoff = torch.clamp_min(
                    1.0 - cp[:, s + m - 1] - float(np.float32(strike))
                    * ann[:, s + m - 1], 0.0)
                rows[k] = payoff * inv_n
        if s == S:
            break
        N = N * (1.0 + deltas[s] * L[:, s])
        alive = libor > s
        mt = torch.where(alive, d / (1.0 + d * L), 0.0)
        mu = torch.zeros_like(L)
        diffusion = torch.zeros_like(L)
        for f in range(F):
            base = volT_b[:, f * n:(f + 1) * n, s, None]          # [B, n, 1]
            lam = base * (L + disp) if displaced else base
            run = running_sums(mt * lam, s + 1)
            mu = mu + lam * run
            diffusion = diffusion + lam * (sqrt_dt * z[s * F + f])
        L = torch.where(alive, torch.clamp(L + mu * dt + diffusion, -1e3, 1e3),
                        L)
    return torch.stack(rows, dim=1).to(torch.float64)           # [B, R, paths]


# ---------------------------------------------------------------------------
# the single-swaption pricer: one factor, payoff / N(T_e) per path
# ---------------------------------------------------------------------------

def lmm_swaption_inputs(vol_table, initial_forwards, deltas, num_steps: int,
                        dt, strike, device):
    """The pricer's packed inputs on ``device``, as the JAX wrapper packs
    them (``lmm_kernel.py:133-137``): ``volT`` ``[n, S]`` (``vol_table``
    ``[>= S, n]`` cut to ``S = num_steps`` rows and transposed), ``l0`` and
    ``deltas`` ``[n]`` float32, and ``scal`` ``[dt, sqrt(dt), strike, 0]``
    float32 on the CPU, the square root taken in float64."""
    vt = sp.as_f32(vol_table, device)
    if vt.dim() != 2 or not 1 <= num_steps <= vt.shape[0]:
        raise ValueError(f"vol_table of shape {tuple(vt.shape)} has no "
                         f"{num_steps} steps")
    volT = vt[:num_steps].T.contiguous()
    scal = torch.tensor([dt, math.sqrt(dt), strike, 0.0],
                        dtype=torch.float64).to(torch.float32)
    return (volT, sp.as_f32(initial_forwards, device),
            sp.as_f32(deltas, device), scal)


def lmm_swaption_payoffs_with_normals(z, volT, l0, deltas, scal, *,
                                      exercise: int,
                                      periods: int) -> torch.Tensor:
    """Plain version of the kernel on the normals ``z`` ``[S, paths]``
    (step ``s`` uses row ``s``): payoff / N ``[paths]`` float32, a loop over
    steps in the Pallas kernel's order of operations, ``L + lam * (prefix *
    dt + sqrt_dt * z)``, the prefix sum taken sequentially over the alive
    libors as the CUDA kernel takes it."""
    n, S = volT.shape
    dt, sqrt_dt, strike = (float(v) for v in scal[:3].tolist())
    L = l0[:, None].expand(n, z.shape[1])
    N = torch.ones(z.shape[1], dtype=torch.float32, device=z.device)
    for s in range(S):
        w = sqrt_dt * z[s]
        N = N * (1.0 + deltas[s] * L[s])
        La, d, lam = L[s + 1:], deltas[s + 1:, None], volT[s + 1:, s, None]
        prefix = sp.running_sum((d * lam) / (1.0 + d * La))
        L = torch.cat([L[:s + 1], La + lam * (prefix * dt + w)])
    return sp.discounted_payoff(L, N, deltas, strike, exercise, periods)


def lmm_swaption_paths_reference(seed: int, num_paths: int, volT, l0, deltas,
                                 scal, *, exercise: int,
                                 periods: int) -> torch.Tensor:
    """Plain version of the PRNG kernel: its normals (``normal_pairs``,
    step ``s`` = normal ``s`` of a path's stream), then its arithmetic."""
    S = volT.shape[1]
    z = normal_pairs(seed, num_paths, -(-S // 4), volT.device)[:S]
    return lmm_swaption_payoffs_with_normals(z, volT, l0, deltas, scal,
                                             exercise=exercise,
                                             periods=periods)


def _pricer(volT, l0, deltas, scal, exercise, periods):
    n, S, device = sp.check_inputs(volT, l0, deltas, scal, num_factors=1,
                                   exercise=exercise, periods=periods,
                                   scal_size=4)
    return device, S


def lmm_swaption_packed(volT, l0, deltas, scal, *, exercise: int,
                       periods: int) -> sp.PricerLaunch:
    """What a launch takes (``_swaption_paths.PricerLaunch``): the table a
    kernel block stages, on ``volT``'s device (``pack_table``), the
    kernels' instantiation for the model (``pricer_variant``), the scalars
    ``dt, sqrt_dt, strike`` and the shape ``(n, swept, S, exercise,
    periods)``, ``swept`` the libors that reach the payoff
    (``swept_libors``)."""
    n, S = l0.shape[0], volT.shape[1]
    sp.check_kernel_shape(n, 1)
    return sp.PricerLaunch(
        sp.pack_table(volT, l0, deltas, num_factors=1, libors=n),
        sp.pricer_variant(n, 1), tuple(float(v) for v in scal[:3].tolist()),
        (n, sp.swept_libors(S, exercise, periods), S, exercise, periods))


def _kernel_payoffs(seed, z, num_paths: int, volT, l0, deltas, scal, *,
                    exercise: int, periods: int, device) -> torch.Tensor:
    """One launch on the CUDA ``device``: the table packed where the inputs
    lie, then ``_swaption_paths.upload_and_launch`` with ``seed`` (``z``
    None) or on ``z``."""
    launch = lmm_swaption_packed(volT, l0, deltas, scal, exercise=exercise,
                                periods=periods)
    return sp.upload_and_launch("lmm_swaption_paths", launch, device,
                                num_paths, seed, z)


def lmm_swaption_payoffs(seed: int, num_paths: int, volT, l0, deltas, scal,
                         *, exercise: int, periods: int) -> torch.Tensor:
    """payoff / N of each path, ``[num_paths]`` float32 on ``volT``'s device,
    each path drawing its own normals: the kernel on a CUDA device (one
    launch), ``lmm_swaption_paths_reference`` on the CPU."""
    seed, num_paths = _check_seed(seed), sp.check_paths(num_paths)
    device, _ = _pricer(volT, l0, deltas, scal, exercise, periods)
    if device.type == "cpu":
        return lmm_swaption_paths_reference(seed, num_paths, volT, l0, deltas,
                                            scal, exercise=exercise,
                                            periods=periods)
    return _kernel_payoffs(seed, None, num_paths, volT, l0, deltas, scal,
                           exercise=exercise, periods=periods, device=device)


def lmm_swaption_payoffs_injected(z, volT, l0, deltas, scal, *,
                                  exercise: int,
                                  periods: int) -> torch.Tensor:
    """payoff / N of each path on the normals ``z`` ``[S, num_paths]``
    float32: the kernel on a CUDA device, ``lmm_swaption_payoffs_with_normals``
    on the CPU."""
    device, S = _pricer(volT, l0, deltas, scal, exercise, periods)
    num_paths = sp.check_paths(z.shape[1] if z.dim() == 2 else 0)
    check_tensor("normals", z, (S, num_paths), torch.float32, device)
    if device.type == "cpu":
        return lmm_swaption_payoffs_with_normals(z, volT, l0, deltas, scal,
                                                 exercise=exercise,
                                                 periods=periods)
    return _kernel_payoffs(0, z, num_paths, volT, l0, deltas, scal,
                           exercise=exercise, periods=periods, device=device)


def _check_libors(num_libors: int, l0: torch.Tensor) -> None:
    if int(num_libors) != l0.shape[0]:
        raise ValueError(f"num_libors={num_libors} but {l0.shape[0]} "
                         "initial forwards")


def lmm_swaption_kernel(seed: int, num_paths: int, num_libors: int,
                        exercise: int, periods: int, num_steps: int,
                        vol_table, initial_forwards, deltas, dt, strike,
                        device=None) -> torch.Tensor:
    """Monte-Carlo E[payoff / N(T_e)] of a payer swaption under the
    spot-measure NORMAL one-factor LMM, every path in one kernel launch:
    the float64 mean as a 0-d tensor on ``device`` (default
    ``select_device()``). ``vol_table`` ``[>= num_steps, n]`` holds
    ``sigma_i(t_s) * R[i, 0]``; ``num_steps`` should be the exercise step
    (simulating past it is wasted work). The inputs are packed on the host
    and reach the card as one table. Traced as ``finmath.pricer.price``
    (``_swaption_paths``)."""
    device = torch.device(device) if device is not None else select_device()
    with span("finmath.pricer.price", kernel="lmm_swaption_paths",
              paths=num_paths):
        with span("finmath.pricer.inputs"):
            args = lmm_swaption_inputs(vol_table, initial_forwards, deltas,
                                       num_steps, dt, strike, "cpu")
            _check_libors(num_libors, args[1])
            swap = dict(exercise=exercise, periods=periods)
            if device.type != "cpu":
                sp.check_device(device)
                seed, num_paths = _check_seed(seed), sp.check_paths(num_paths)
                _pricer(*args, exercise, periods)
                launch = lmm_swaption_packed(*args, **swap)
        if device.type == "cpu":
            return sp.mean(lmm_swaption_payoffs(seed, num_paths, *args,
                                                **swap))
        return sp.mean(sp.upload_and_launch("lmm_swaption_paths", launch,
                                            device, num_paths, seed))


def lmm_swaption_kernel_with_normals(normals, num_libors: int, exercise: int,
                                     periods: int, vol_table,
                                     initial_forwards, deltas, dt, strike,
                                     device=None) -> torch.Tensor:
    """The same price on given standard normals ``[num_steps, num_paths]``
    (step ``s`` uses row ``s``), on the device of ``normals`` if it is a
    tensor, else on ``device`` (default ``select_device()``). The other
    inputs are packed on the host and reach the card as one table."""
    if device is None:
        device = normals.device if isinstance(normals, torch.Tensor) \
            else select_device()
    device = torch.device(device)
    z = sp.as_f32(normals, device)
    if z.dim() != 2:
        raise ValueError("normals must be [num_steps, num_paths]")
    args = lmm_swaption_inputs(vol_table, initial_forwards, deltas,
                               z.shape[0], dt, strike, "cpu")
    _check_libors(num_libors, args[1])
    swap = dict(exercise=exercise, periods=periods)
    if device.type == "cpu":
        return sp.mean(lmm_swaption_payoffs_injected(z, *args, **swap))
    sp.check_device(device)
    num_paths = sp.check_paths(z.shape[1])
    _pricer(*args, exercise, periods)
    return sp.mean(_kernel_payoffs(0, z, num_paths, *args, **swap,
                                   device=device))
