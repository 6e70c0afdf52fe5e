"""Build, checks and launches of the single-swaption LMM path kernels
(``csrc/lmm_swaption_paths.cu``), shared by the 1-factor pricer in
``ops/lmm_kernel.py`` and the stoch-vol pricer in
``ops/lmm_stochvol_kernel.py``. ``LAUNCHES`` counts the launches of each
of the four launchers: the PRNG and injected-normals variants of each
kernel.

A pricer's inputs, on one device: ``volT`` ``[F * n, S]`` float32
(``sigma_i(t_s) * R[i, f]`` at row ``f * n + i``; ``F = 1`` for the
1-factor kernel), ``l0`` and ``deltas`` ``[n]`` float32, and ``scal``, a
float32 vector of the scalars (``[dt, sqrt_dt, strike, 0]`` for the
1-factor kernel, ``[dt, sqrt_dt, strike, blend, nu, rho, sqrt(1 - rho^2),
0]`` for the stoch-vol one) on any device. Injected normals are ``[S * k,
num_paths]`` float32, ``k = 1`` or ``F + 1`` rows a step.

A launch sweeps the first ``swept_libors(...)`` libors, those that reach
the payoff (the others reach neither the numeraire nor the payoff, so the
payoffs equal the plain versions', which sweep every libor, bit for bit),
a run-time argument. It runs the ``(K, F)`` instantiation of the source
(``pricer_variant``: K libors of the curve and F factors at compile time;
a few libraries a model, not one a swaption shape), built by ``nvcc`` at
first use, on the table a block stages into shared memory
(``pack_table``), the scalars passed as launch arguments
(``PricerLaunch``).

A pricer's call is traced (``utils.profiling.span``): the entry points'
``finmath.pricer.price`` (attributes ``kernel`` and ``paths``) holds
``finmath.pricer.inputs`` (the inputs built, checked and packed on the
host), and ``upload_and_launch`` the table's ``finmath.pricer.upload`` and
the ``finmath.pricer.launch`` (the payoffs allocated and the launcher
called).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..utils.profiling import span
from . import _cuda_build
from ._products import MAX_LIBORS, check_tensor, pack_parameter_sets

SOURCE = "lmm_swaption_paths.cu"
FLAGS = ()                    # extra nvcc flags: none (explicit rounding)
MAX_FACTORS = 8               # the launchers refuse more (kMaxFactors)


class PricerLaunch(NamedTuple):
    """What a launcher takes besides the payoffs and the normals."""

    table: torch.Tensor        # [W] float32, as a block stages it
    variant: Tuple[int, ...]   # (K, F), the instantiation
    scalars: Tuple[float, ...]  # dt, sqrt_dt, strike (, blend, nu, rho,
                                # sqrt(1 - rho^2))
    ints: Tuple[int, ...]      # (K, [F,] swept, S, exercise, periods)


#: kernel launches since the last reset, per launcher (plain integers; a
#: run resets them and reads them to show that its main path went through
#: the kernels)
LAUNCHES = {"lmm_swaption_paths": 0, "lmm_swaption_paths_normals": 0,
            "lmm_stochvol_swaption_paths": 0,
            "lmm_stochvol_swaption_paths_normals": 0}


def swept_libors(num_steps: int, exercise: int, periods: int) -> int:
    """The libors a launch sweeps: those up to the swap's last period and
    the last step's fixing. Libor ``i`` evolves from libors ``j <= i``
    alone, the payoff reads ``[exercise, exercise + periods)`` and the
    numeraire the fixings ``0 .. num_steps - 1``: the libors above reach
    neither."""
    return max(int(exercise) + int(periods), int(num_steps))


#: the stoch-vol kernels' curve length is the swept libors rounded up to
#: a multiple of this
CURVE_ROUND = 8


def pricer_variant(num_libors: int, num_factors: int, swept=None):
    """``(K, F)``: the instantiation of the pricer kernels that a launch
    on a model of ``num_libors`` libors and ``F`` factors runs. The
    1-factor kernels sweep a curve in shared memory and use K only for the
    table's layout: ``K = num_libors`` (``swept`` None), one library a
    model. The stoch-vol kernels keep the curve in registers, K of them,
    and ``swept`` of them are swept: ``K = swept`` rounded up to a
    multiple of ``CURVE_ROUND``, at most ``num_libors``, so a model has at
    most ``ceil(num_libors / 8)`` libraries. On an H100 the registers of
    10 unswept libors cost 12-18% (K = 40 against 30 for 30 swept libors,
    ``PERF.md``)."""
    n, F = int(num_libors), int(num_factors)
    if swept is None:
        return (n, F)
    return (min(n, -(-int(swept) // CURVE_ROUND) * CURVE_ROUND), F)


def pricer_defines(K: int, F: int):
    """The ``nvcc`` defines of the ``(K, F)`` instantiation."""
    return (("LMM_K", K), ("LMM_F", F))


@functools.cache
def _library(K: int, F: int) -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE, pricer_defines(K, F), FLAGS)
    ptr, i32, u64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
                          ctypes.c_float)
    # packed, width, the scalars, then n (F), swept, S, exercise, periods,
    # stream
    tail = {"lmm_swaption_paths": [ptr, i32] + [f32] * 3 + [i32] * 5 + [ptr],
            "lmm_stochvol_swaption_paths":
                [ptr, i32] + [f32] * 7 + [i32] * 6 + [ptr]}
    for name, args in tail.items():
        getattr(lib, f"{name}_launch").argtypes = [ptr, i32, u64] + args
        getattr(lib, f"{name}_normals_launch").argtypes = [ptr, ptr, i32] + args
        getattr(lib, f"{name}_launch").restype = i32
        getattr(lib, f"{name}_normals_launch").restype = i32
    lib.lmm_swaption_paths_error_string.argtypes = [i32]
    lib.lmm_swaption_paths_error_string.restype = ctypes.c_char_p
    lib.lmm_swaption_paths_variant.argtypes = [i32]
    lib.lmm_swaption_paths_variant.restype = i32
    if [lib.lmm_swaption_paths_variant(j) for j in range(2)] != [K, F]:
        raise RuntimeError(f"{SOURCE}: the library is not the instantiation "
                           f"K={K}, F={F}")
    return lib


def load_kernel(*variants) -> None:
    """Build and load the kernels' library for each ``(K, F)`` of
    ``variants`` (``pricer_variant``; first use only)."""
    for v in variants:
        _library(*v)


def pack_table(volT, l0, deltas, *, num_factors: int, libors: int,
               blend=None) -> torch.Tensor:
    """``[W]`` float32 on ``volT``'s device, the table a kernel block
    stages for a curve of the first ``libors`` libors
    (``_products.pack_parameter_sets`` of one set, without its scalars):
    per libor ``(L0, delta)`` (one factor) or, given the stoch-vol
    ``blend``, ``(L0, delta, blend * L0, 0)`` (the product rounded to
    float32, as the kernel's first design rounded it), the libors padded to
    a multiple of 4, then the loadings step-major ``[S][C][NP][V]``. A
    fresh contiguous tensor: 16-byte aligned, ``W`` a multiple of 4."""
    F, n, K = num_factors, l0.shape[0], libors
    vol = volT.view(F, n, -1)[:, :K].reshape(1, F * K, -1)
    columns = (l0[:K], deltas[:K])
    if blend is not None:
        columns += (l0[:K] * blend, torch.zeros_like(l0[:K]))
    return pack_parameter_sets(vol, vol.new_empty((1, 0)), columns,
                               num_factors=F)[0]


def as_f32(x, device) -> torch.Tensor:
    """``x`` (NumPy, a sequence or a tensor) as a contiguous float32 tensor
    on ``device``."""
    return torch.as_tensor(x).to(device=device,
                                 dtype=torch.float32).contiguous()


def check_inputs(volT, l0, deltas, scal, *, num_factors: int, exercise: int,
                 periods: int, scal_size: int):
    """Validate a pricer's inputs; returns ``(n, S, device)``."""
    if not isinstance(volT, torch.Tensor) or volT.dim() != 2:
        raise ValueError("volT must be a [F * n, S] tensor")
    device = volT.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    F = int(num_factors)
    n = int(l0.shape[0]) if isinstance(l0, torch.Tensor) else -1
    S = int(volT.shape[1])
    check_tensor("volT", volT, (F * n, S), torch.float32, device)
    check_tensor("initial_forwards", l0, (n,), torch.float32, device)
    check_tensor("deltas", deltas, (n,), torch.float32, device)
    if not isinstance(scal, torch.Tensor) or scal.dtype != torch.float32 \
            or tuple(scal.shape) != (scal_size,):
        raise ValueError(f"scal must be a float32 [{scal_size}] tensor")
    if not 1 <= S <= n:
        raise ValueError(f"num_steps={S} outside 1..{n} (the libors)")
    if exercise < 0 or periods < 1 or exercise + periods > n:
        raise ValueError(f"swaption (exercise={exercise}, periods={periods})"
                         f" does not fit on {n} libors")
    return n, S, device


def check_paths(num_paths: int) -> int:
    num_paths = int(num_paths)
    if not 1 <= num_paths < 2 ** 31:
        raise ValueError(f"num_paths={num_paths} outside [1, 2^31)")
    return num_paths


def _launch(key: str, payoff: torch.Tensor, head,
            launch: PricerLaunch) -> torch.Tensor:
    """Launch ``<key>_launch`` of the ``launch.variant`` instantiation with
    the arguments ``head`` after ``payoff``, then the table, scalars and
    shape of ``launch``, on the current stream of ``payoff``'s device;
    raises if it fails (a table that the bulk copies cannot stage, or a
    shape that is not the instantiation's, fails here too)."""
    lib = _library(*launch.variant)
    device = payoff.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{key}_launch")(
            payoff.data_ptr(), *head, launch.table.data_ptr(),
            launch.table.shape[0], *launch.scalars, *launch.ints, stream)
    if err != 0:
        msg = lib.lmm_swaption_paths_error_string(err).decode()
        raise RuntimeError(f"{key} launch failed: {msg} ({err})")
    LAUNCHES[key] += 1
    return payoff


def launch_prng(name: str, payoff: torch.Tensor, seed: int,
                launch: PricerLaunch) -> torch.Tensor:
    """Launch the kernel ``name`` drawing its own normals from ``seed``, one
    path per element of ``payoff``."""
    return _launch(name, payoff, (payoff.shape[0], seed), launch)


def launch_injected(name: str, payoff: torch.Tensor, z: torch.Tensor,
                    launch: PricerLaunch) -> torch.Tensor:
    """Launch the kernel ``name`` on the normals ``z`` ``[rows,
    payoff.shape[0]]``."""
    return _launch(f"{name}_normals", payoff,
                   (z.data_ptr(), payoff.shape[0]), launch)


def upload_and_launch(name: str, launch: PricerLaunch, device,
                      num_paths: int, seed: int = 0,
                      z: torch.Tensor = None) -> torch.Tensor:
    """payoff / N of each path, ``[num_paths]`` float32 on the CUDA
    ``device``: the table of ``launch`` moved there (one copy, for a table
    on the CPU), then one launch of the kernel ``name``, drawing its
    normals from ``seed`` (``z`` None) or on the normals ``z``."""
    with span("finmath.pricer.upload"):
        launch = launch._replace(table=launch.table.to(device))
    with span("finmath.pricer.launch"):
        out = torch.empty(num_paths, dtype=torch.float32, device=device)
        if z is None:
            return launch_prng(name, out, seed, launch)
        return launch_injected(name, out, z, launch)


def check_device(device: torch.device) -> None:
    """Raise unless the kernels can run on ``device`` (a CUDA device)."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")


def check_kernel_shape(n: int, F: int) -> None:
    """Raise if the kernels cannot sweep ``n`` libors of ``F`` factors."""
    if not 1 <= F <= MAX_FACTORS or n > MAX_LIBORS:
        raise ValueError(f"num_factors={F}, num_libors={n} outside the "
                         f"kernels' 1..{MAX_FACTORS} factors and "
                         f"{MAX_LIBORS} libors")


def running_sum(c: torch.Tensor) -> torch.Tensor:
    """Inclusive running sums along dim 0 in the tensor's own type, one
    addition after another from 0 (the kernels' order; ``torch.cumsum``
    on the CPU accumulates float32 in float64)."""
    out = torch.empty_like(c)
    acc = torch.zeros(c.shape[1:], dtype=c.dtype, device=c.device)
    for k in range(c.shape[0]):
        acc = acc + c[k]
        out[k] = acc
    return out


def discounted_payoff(L, N, deltas, strike: float, exercise: int,
                      periods: int) -> torch.Tensor:
    """``max(1 - P_end - K A, 0) / N`` per path (NaN kept), the bond product
    and annuity taken one period after another over ``[exercise,
    exercise + periods)`` of the curve ``L`` ``[n, paths]``."""
    cp = torch.ones_like(N)
    ann = torch.zeros_like(N)
    for i in range(exercise, exercise + periods):
        cp = cp * (1.0 / (1.0 + deltas[i] * L[i]))
        ann = ann + cp * deltas[i]
    payoff = torch.clamp_min((1.0 - cp) - strike * ann, 0.0)
    return payoff / N


def mean(payoffs: torch.Tensor) -> torch.Tensor:
    """The float64 mean of per-path payoffs, a 0-d tensor on their device."""
    return torch.sum(payoffs, dtype=torch.float64) / payoffs.shape[0]
