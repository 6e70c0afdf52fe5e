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
CUDA tensor it launches the kernel (and raises if the launch fails), traced
as the kernel backend's ``finmath.backend.launch`` (packing to the launch
enqueued) and ``finmath.backend.reduce`` (the tile sums); on a CPU tensor
it runs ``lmm_stochvol_swaptions_batch_reference``. ``LAUNCHES`` counts
kernel launches.

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

A launch carries one path a thread; the wrapper packs the parameter sets
as a block stages them (``_packed``) and launches the ``(K, F, R)``
instantiation of the source for the shape, built by ``nvcc`` at first use
(``_products.sweep_variant``), without FMA contraction
(``_products.SWEEP_FLAGS``). The plain version takes the kernel's running
sums in its order (``_products.running_sums``, ``bond_prefix``), so the
two agree bit for bit on the card;
``lmm_stochvol_swaptions_partials_reference`` gives the partials ``[B,
tiles, P]`` a launch writes, in the kernel's order of float64 additions
(``_products.tile_partials``).

The single-swaption pricer of the same model family, counterpart of
``lmm_stochvol_swaption_kernel`` and ``..._with_normals`` (the Pallas
kernel ``_sv_kernel``, with the on-core PRNG and on injected normals), is
here too: its kernels are ``csrc/lmm_swaption_paths.cu``, built and counted
by ``ops/_swaption_paths.py``. Unlike the products kernel it carries V
multiplicatively in float32, as ``_sv_kernel`` does (held against its own
reference, not the products kernel's). Each entry point returns the float64
mean of payoff / N(T_e) as a 0-d tensor; ``lmm_stochvol_swaption_payoffs``
and ``..._payoffs_injected`` give the float32 value of each path (the kernel
on a CUDA device, the plain version on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
import threading
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

SOURCE = "lmm_stochvol_products.cu"
FLAGS = SWEEP_FLAGS
MAX_FACTORS = 8               # kMaxFactors in csrc/lmm_sweep.cuh
LOG_V_CAP = 13.815511         # log(1e6), the engine's cap of V

#: kernel launches since the last reset (plain integer; a run resets it
#: and reads it to show that its main path went through the kernel);
#: counted under a lock, since a backend's realizations may be evaluated
#: from several threads
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()


@functools.cache
def _library(K: int, F: int, R: int) -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE, sweep_defines(K, F, R), FLAGS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lmm_stochvol_products_launch.argtypes = (
        [ptr, ctypes.c_longlong, ptr, i32] + [ptr] * 5 + [i32] * 5 + [ptr])
    lib.lmm_stochvol_products_launch.restype = i32
    lib.lmm_stochvol_products_error_string.argtypes = [i32]
    lib.lmm_stochvol_products_error_string.restype = ctypes.c_char_p
    lib.lmm_stochvol_products_variant.argtypes = [i32]
    lib.lmm_stochvol_products_variant.restype = i32
    built = [lib.lmm_stochvol_products_variant(j) for j in range(3)]
    if built != [K, F, R]:
        raise RuntimeError(f"{SOURCE}: the library is not the instantiation "
                           f"K={K}, F={F}, R={R}")
    return lib


def load_kernel(*variants: Tuple[int, int, int]) -> None:
    """Build and load the kernel's library for each ``(K, F, R)`` of
    ``variants`` (``_products.sweep_variant``; first use only)."""
    for v in variants:
        _library(*v)


def _packed(volT_b, scal_b, initial_forwards, deltas, F):
    """The parameter sets as a block stages them: per libor (L0, delta,
    blend * L0, 0)."""
    blend_l0 = scal_b[:, 2, None] * initial_forwards
    return pack_parameter_sets(
        volT_b, scal_b, (initial_forwards, deltas, blend_l0,
                         torch.zeros_like(initial_forwards)),
        num_factors=F)


def lmm_stochvol_swaptions_batch(z, volT_b, scal_b, initial_forwards, deltas,
                                 *, num_libors: int, num_factors: int,
                                 products: Sequence[Product],
                                 num_paths: int) -> torch.Tensor:
    """Float64 path sums ``[B, P]`` (see the module docstring)."""
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
    if not 1 <= F <= MAX_FACTORS or n > MAX_LIBORS:
        raise ValueError(f"num_factors={F}, num_libors={n} outside the "
                         f"kernel's 1..{MAX_FACTORS} factors and "
                         f"{MAX_LIBORS} libors")
    with span("finmath.backend.launch"):
        go, partials = prepare(
            z, volT_b, scal_b, initial_forwards, deltas, num_libors=n,
            num_factors=F, products=products, num_paths=num_paths)
        go()
    with span("finmath.backend.reduce"):
        return partials.sum(dim=1)


def prepare(z, volT_b, scal_b, initial_forwards, deltas, *, num_libors: int,
            num_factors: int, products: Sequence[Product], num_paths: int):
    """Pack the parameter sets and allocate the partials ``[B, tiles, P]``
    of a launch; returns ``(go, partials)``, ``go()`` enqueuing the launch
    alone."""
    n, F = num_libors, num_factors
    B, device = volT_b.shape[0], z.device
    products = tuple(products)
    packed = _packed(volT_b, scal_b, initial_forwards, deltas, F)
    tables = product_tables(products, device)
    tiles = -(-num_paths // THREADS)
    partials = torch.empty((B, tiles, len(products)), dtype=torch.float64,
                           device=device)
    variant = sweep_variant(n, F)

    def go():
        launch(z, packed, tables, partials, n=n, S=products[-1][0],
               num_paths=num_paths, variant=variant)

    return go, partials


def launch(z, packed, tables, partials, *, n: int, S: int, num_paths: int,
           variant: Tuple[int, int, int]) -> None:
    """One launch of the instantiation ``variant`` on packed parameter sets
    (``_packed``) into ``partials`` ``[B, tiles, P]``, on the current
    stream; raises if it fails (a ``packed`` that is not 16-byte aligned
    with a width a multiple of 4 floats fails here too). Counted in
    ``LAUNCHES``."""
    global LAUNCHES
    lib = _library(*variant)
    B, width = packed.shape
    device = z.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lmm_stochvol_products_launch(
            z.data_ptr(), num_paths, packed.data_ptr(), width,
            tables.step_first.data_ptr(), tables.order.data_ptr(),
            tables.periods.data_ptr(), tables.strikes.data_ptr(),
            partials.data_ptr(), n, S, partials.shape[2], num_paths, B,
            stream)
    if err != 0:
        msg = lib.lmm_stochvol_products_error_string(err).decode()
        raise RuntimeError(f"lmm_stochvol_products launch failed: {msg} "
                           f"({err})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1


def lmm_stochvol_swaptions_batch_reference(z, volT_b, scal_b,
                                           initial_forwards, deltas, *,
                                           num_libors: int, num_factors: int,
                                           products: Sequence[Product],
                                           num_paths: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: a Python loop over
    steps, vectorised over ``[B, libors, paths]``, with the kernel's float32
    arithmetic and its order of additions (``running_sums``,
    ``bond_prefix``) and a finite-masked float64 path sum."""
    return _path_values(z, volT_b, scal_b, initial_forwards, deltas,
                        num_libors=num_libors, num_factors=num_factors,
                        products=products, num_paths=num_paths).sum(dim=-1)


def lmm_stochvol_swaptions_partials_reference(
        z, volT_b, scal_b, initial_forwards, deltas, *, num_libors: int,
        num_factors: int, products: Sequence[Product],
        num_paths: int) -> torch.Tensor:
    """The float64 partials ``[B, tiles, P]`` of one launch (what
    ``prepare``'s ``go()`` writes), from the plain version's path values in
    the kernel's order of additions (``_products.tile_partials``)."""
    return tile_partials(_path_values(
        z, volT_b, scal_b, initial_forwards, deltas, num_libors=num_libors,
        num_factors=num_factors, products=products, num_paths=num_paths))


def _path_values(z, volT_b, scal_b, initial_forwards, deltas, *,
                 num_libors: int, num_factors: int,
                 products: Sequence[Product],
                 num_paths: int) -> torch.Tensor:
    """The plain version's float64 discounted payoff of every product and
    path, ``[B, P, num_paths]``, a non-finite value 0.0."""
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
    blend_l0 = blend * L0
    libor = torch.arange(n, device=z.device)[:, None]

    L = L0.expand(B, n, num_paths)
    N = torch.ones((B, num_paths), dtype=torch.float32, device=z.device)
    logV = torch.zeros((B, 1, num_paths), dtype=torch.float32,
                       device=z.device)
    rows = [None] * len(products)
    for s in range(S + 1):
        if s in by_step:
            last = s + max(m for _, m, _ in by_step[s]) - 1
            cp, ann = bond_prefix(L, d, s, last)
            for k, m, strike in by_step[s]:
                payoff = torch.clamp_min(
                    1.0 - cp[:, s + m - 1] - float(np.float32(strike))
                    * ann[:, s + m - 1], 0.0)
                rows[k] = payoff / N
        if s == S:
            break
        zs = z[s * (F + 1):(s + 1) * (F + 1)]                   # [F+1, paths]
        N = N * (1.0 + deltas[s] * L[:, s])
        alive = libor > s
        lf = ((1.0 - blend) * L + blend_l0) * torch.exp(0.5 * logV)
        mt = torch.where(alive, d / (1.0 + d * L), 0.0)
        mu = torch.zeros_like(L)
        diffusion = torch.zeros_like(L)
        for f in range(F):
            lam = volT_b[:, f * n:(f + 1) * n, s, None] * lf
            run = running_sums(mt * lam, s + 1)
            mu = mu + lam * run
            diffusion = diffusion + lam * (sqrt_dt * zs[f])
        L = torch.where(alive, torch.clamp(L + mu * dt + diffusion, -1e3, 1e3),
                        L)
        dw_v = sqrt_dt * (rho * zs[0] + somega * zs[F])
        logV = torch.clamp_max(logV + nu * dw_v - 0.5 * nu * nu * dt,
                               LOG_V_CAP)
    paid = torch.stack(rows, dim=1)                             # [B, P, paths]
    return torch.where(torch.isfinite(paid), paid, 0.0).to(torch.float64)


# ---------------------------------------------------------------------------
# the single-swaption pricer: F factors, blended local vol, V multiplicative
# ---------------------------------------------------------------------------

V_CAP = 1.0e6                 # the Pallas pricer's cap of V


def lmm_stochvol_swaption_inputs(vol_table, factor_matrix, initial_forwards,
                                 deltas, num_steps: int, dt, strike, blend,
                                 nu, rho, device):
    """The pricer's packed inputs on ``device``, as the JAX package's
    ``_pack_inputs`` packs them (``lmm_stochvol_kernel.py:120-137``):
    ``volT`` ``[F * n, S]`` float32 (``vol_table[s, i] * R[i, f]`` at row
    ``f * n + i``, the product taken in float32), ``l0`` and ``deltas``
    ``[n]`` float32, and ``scal`` ``[dt, sqrt(dt), strike, blend, nu, rho,
    sqrt(1 - rho^2), 0]`` float32 on the CPU, both roots taken in float32."""
    vt, R = sp.as_f32(vol_table, device), sp.as_f32(factor_matrix, device)
    if vt.dim() != 2 or not 1 <= num_steps <= vt.shape[0] or R.dim() != 2:
        raise ValueError(f"vol_table {tuple(vt.shape)} / factor_matrix "
                         f"{tuple(R.shape)} do not give {num_steps} steps")
    vt = vt[:num_steps]
    volT = (vt.T[None, :, :] * R.T[:, :, None]).reshape(-1, num_steps)
    f32 = np.float32
    rho32 = f32(rho)
    somega = np.sqrt(np.maximum(f32(1.0) - rho32 * rho32, f32(1e-12)))
    scal = torch.from_numpy(np.asarray(
        [f32(dt), np.sqrt(f32(dt)), f32(strike), f32(blend), f32(nu), rho32,
         somega, 0.0], dtype=np.float32))
    return (volT.contiguous(), sp.as_f32(initial_forwards, device),
            sp.as_f32(deltas, device), scal)


def _scalars(scal):
    """The pricer's scalars as Python floats (exact float32 values), with
    1 - blend and nu^2 dt / 2 rounded as the kernel rounds them."""
    f32 = np.float32
    dt, sqrt_dt, strike, blend, nu, rho, somega = (
        f32(v) for v in scal[:7].tolist())
    one_minus_blend = f32(1.0) - blend
    v_drift = ((f32(0.5) * nu) * nu) * dt
    return tuple(float(v) for v in (dt, sqrt_dt, strike, blend, nu, rho,
                                    somega, one_minus_blend, v_drift))


def lmm_stochvol_swaption_payoffs_with_normals(z, volT, l0, deltas, scal, *,
                                               exercise: int,
                                               periods: int) -> torch.Tensor:
    """Plain version of the kernel on the normals ``z`` ``[S * (F + 1),
    paths]`` (rows step-major: the factors, then the normal of V): payoff /
    N ``[paths]`` float32, a loop over steps in the Pallas kernel's order of
    operations (``lmm_stochvol_kernel.py:80-117``), V multiplied by one
    ``exp`` a step and capped at 1e6, L clamped to +-1e3, the drift's prefix
    sums taken sequentially over the alive libors as the CUDA kernel takes
    them."""
    n = l0.shape[0]
    F, S = volT.shape[0] // n, volT.shape[1]
    vol = volT.reshape(F, n, S)
    (dt, sqrt_dt, strike, blend, nu, rho, somega, one_minus_blend,
     v_drift) = _scalars(scal)
    paths = z.shape[1]
    L = l0[:, None].expand(n, paths)
    N = torch.ones(paths, dtype=torch.float32, device=z.device)
    V = torch.ones(paths, dtype=torch.float32, device=z.device)
    for s in range(S):
        zs = z[s * (F + 1):(s + 1) * (F + 1)]
        w = sqrt_dt * zs[:F]                                       # [F, paths]
        N = N * (1.0 + deltas[s] * L[s])
        La, d = L[s + 1:], deltas[s + 1:, None]
        mt = d / (1.0 + d * La)
        lf = (one_minus_blend * La + blend * l0[s + 1:, None]) * torch.sqrt(V)
        lam = vol[:, s + 1:, s, None] * lf                   # [F, n', paths]
        run = sp.running_sum((mt * lam).transpose(0, 1)).transpose(0, 1)
        mu = torch.zeros_like(La)
        diffusion = torch.zeros_like(La)
        for f in range(F):
            mu = mu + lam[f] * run[f]
            diffusion = diffusion + lam[f] * w[f]
        L = torch.cat([L[:s + 1], torch.clamp((La + mu * dt) + diffusion,
                                              -1e3, 1e3)])
        dw_v = sqrt_dt * (rho * zs[0] + somega * zs[F])
        V = torch.clamp_max(V * torch.exp(nu * dw_v - v_drift), V_CAP)
    return sp.discounted_payoff(L, N, deltas, strike, exercise, periods)


def lmm_stochvol_swaption_paths_reference(seed: int, num_paths: int, volT,
                                          l0, deltas, scal, *, exercise: int,
                                          periods: int) -> torch.Tensor:
    """Plain version of the PRNG kernel: its normals (``normal_pairs``, row
    ``s * (F + 1) + f`` = normal of that index of a path's stream), then its
    arithmetic."""
    F = volT.shape[0] // l0.shape[0]
    rows = volT.shape[1] * (F + 1)
    z = normal_pairs(seed, num_paths, -(-rows // 4), volT.device)[:rows]
    return lmm_stochvol_swaption_payoffs_with_normals(
        z, volT, l0, deltas, scal, exercise=exercise, periods=periods)


def _pricer(volT, l0, deltas, scal, exercise, periods):
    n = l0.shape[0] if isinstance(l0, torch.Tensor) else 0
    F = volT.shape[0] // n if n and isinstance(volT, torch.Tensor) else 0
    if not 1 <= F <= sp.MAX_FACTORS:
        raise ValueError(f"num_factors={F} outside the kernel's 1.."
                         f"{sp.MAX_FACTORS}")
    n, S, device = sp.check_inputs(volT, l0, deltas, scal, num_factors=F,
                                   exercise=exercise, periods=periods,
                                   scal_size=8)
    return device, F, S


def lmm_stochvol_swaption_packed(volT, l0, deltas, scal, *, exercise: int,
                                periods: int) -> sp.PricerLaunch:
    """What a launch takes (``_swaption_paths.PricerLaunch``): the kernels'
    instantiation ``(K, F)`` for the libors that reach the payoff
    (``swept_libors``, ``pricer_variant``), the table a kernel block stages
    for the first K libors, on ``volT``'s device (``pack_table``), the
    scalars ``dt, sqrt_dt, strike, blend, nu, rho, sqrt(1 - rho^2)`` and
    the shape ``(K, F, swept, S, exercise, periods)``."""
    n, S = l0.shape[0], volT.shape[1]
    F = volT.shape[0] // n
    sp.check_kernel_shape(n, F)
    swept = sp.swept_libors(S, exercise, periods)
    variant = sp.pricer_variant(n, F, swept)
    K = variant[0]
    scalars = tuple(float(v) for v in scal[:7].tolist())
    return sp.PricerLaunch(
        sp.pack_table(volT, l0, deltas, num_factors=F, libors=K,
                      blend=scalars[3]),
        variant, scalars, (K, F, swept, S, exercise, periods))


def _kernel_payoffs(seed, z, num_paths: int, volT, l0, deltas, scal, *,
                    exercise: int, periods: int, device) -> torch.Tensor:
    """One launch on the CUDA ``device``: the table packed where the inputs
    lie, then ``_swaption_paths.upload_and_launch`` with ``seed`` (``z``
    None) or on ``z``."""
    launch = lmm_stochvol_swaption_packed(volT, l0, deltas, scal,
                                         exercise=exercise, periods=periods)
    return sp.upload_and_launch("lmm_stochvol_swaption_paths", launch, device,
                                num_paths, seed, z)


def lmm_stochvol_swaption_payoffs(seed: int, num_paths: int, volT, l0,
                                  deltas, scal, *, exercise: int,
                                  periods: int) -> torch.Tensor:
    """payoff / N of each path, ``[num_paths]`` float32 on ``volT``'s device,
    each path drawing its own normals: the kernel on a CUDA device (one
    launch), ``lmm_stochvol_swaption_paths_reference`` on the CPU."""
    seed, num_paths = _check_seed(seed), sp.check_paths(num_paths)
    device, _, _ = _pricer(volT, l0, deltas, scal, exercise, periods)
    if device.type == "cpu":
        return lmm_stochvol_swaption_paths_reference(
            seed, num_paths, volT, l0, deltas, scal, exercise=exercise,
            periods=periods)
    return _kernel_payoffs(seed, None, num_paths, volT, l0, deltas, scal,
                           exercise=exercise, periods=periods, device=device)


def lmm_stochvol_swaption_payoffs_injected(z, volT, l0, deltas, scal, *,
                                           exercise: int,
                                           periods: int) -> torch.Tensor:
    """payoff / N of each path on the normals ``z`` ``[S * (F + 1),
    num_paths]`` float32: the kernel on a CUDA device,
    ``lmm_stochvol_swaption_payoffs_with_normals`` on the CPU."""
    device, F, S = _pricer(volT, l0, deltas, scal, exercise, periods)
    rows = S * (F + 1)
    num_paths = sp.check_paths(z.shape[1] if z.dim() == 2 else 0)
    check_tensor("normals", z, (rows, num_paths), torch.float32, device)
    if device.type == "cpu":
        return lmm_stochvol_swaption_payoffs_with_normals(
            z, volT, l0, deltas, scal, exercise=exercise, periods=periods)
    return _kernel_payoffs(0, z, num_paths, volT, l0, deltas, scal,
                           exercise=exercise, periods=periods, device=device)


def _check_shape(num_libors: int, num_factors: int, volT, l0) -> None:
    if int(num_libors) != l0.shape[0] or \
            int(num_factors) * l0.shape[0] != volT.shape[0]:
        raise ValueError(f"num_libors={num_libors}, num_factors="
                         f"{num_factors} disagree with {l0.shape[0]} initial "
                         f"forwards and a [{volT.shape[0]}, S] loading table")


def lmm_stochvol_swaption_kernel(seed: int, num_paths: int, num_libors: int,
                                 num_factors: int, exercise: int,
                                 periods: int, num_steps: int, vol_table,
                                 factor_matrix, initial_forwards, deltas, dt,
                                 strike, blend, nu, rho,
                                 device=None) -> torch.Tensor:
    """Monte-Carlo E[payoff / N(T_e)] of a payer swaption under the
    stoch-vol benchmark LMM, every path in one kernel launch: the float64
    mean as a 0-d tensor on ``device`` (default ``select_device()``).
    ``vol_table`` ``[>= num_steps, n]``, ``factor_matrix`` ``[n, F]``. The
    inputs are packed on the host and reach the card as one table. Traced
    as ``finmath.pricer.price`` (``_swaption_paths``)."""
    device = torch.device(device) if device is not None else select_device()
    with span("finmath.pricer.price", kernel="lmm_stochvol_swaption_paths",
              paths=num_paths):
        with span("finmath.pricer.inputs"):
            args = lmm_stochvol_swaption_inputs(
                vol_table, factor_matrix, initial_forwards, deltas,
                num_steps, dt, strike, blend, nu, rho, "cpu")
            _check_shape(num_libors, num_factors, args[0], args[1])
            swap = dict(exercise=exercise, periods=periods)
            if device.type != "cpu":
                sp.check_device(device)
                seed, num_paths = _check_seed(seed), sp.check_paths(num_paths)
                _pricer(*args, exercise, periods)
                launch = lmm_stochvol_swaption_packed(*args, **swap)
        if device.type == "cpu":
            return sp.mean(lmm_stochvol_swaption_payoffs(seed, num_paths,
                                                         *args, **swap))
        return sp.mean(sp.upload_and_launch(
            "lmm_stochvol_swaption_paths", launch, device, num_paths, seed))


def lmm_stochvol_swaption_kernel_with_normals(
        normals, num_libors: int, num_factors: int, exercise: int,
        periods: int, vol_table, factor_matrix, initial_forwards, deltas, dt,
        strike, blend, nu, rho, device=None) -> torch.Tensor:
    """The same price on given standard normals ``[num_steps * (num_factors
    + 1), num_paths]`` (rows step-major: factors 0..F-1, then the normal of
    V), on the device of ``normals`` if it is a tensor, else on ``device``
    (default ``select_device()``). The other inputs are packed on the host
    and reach the card as one table."""
    rows, _ = normals.shape
    num_steps = rows // (num_factors + 1)
    if num_steps * (num_factors + 1) != rows:
        raise ValueError("normals rows must be num_steps * (num_factors+1)")
    if device is None:
        device = normals.device if isinstance(normals, torch.Tensor) \
            else select_device()
    device = torch.device(device)
    z = sp.as_f32(normals, device)
    args = lmm_stochvol_swaption_inputs(
        vol_table, factor_matrix, initial_forwards, deltas, num_steps, dt,
        strike, blend, nu, rho, "cpu")
    _check_shape(num_libors, num_factors, args[0], args[1])
    swap = dict(exercise=exercise, periods=periods)
    if device.type == "cpu":
        return sp.mean(lmm_stochvol_swaption_payoffs_injected(z, *args,
                                                              **swap))
    sp.check_device(device)
    _pricer(*args, exercise, periods)
    return sp.mean(_kernel_payoffs(0, z, sp.check_paths(z.shape[1]), *args,
                                   **swap, device=device))
