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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda_build
from ._products import check_tensor

SOURCE = "lmm_swaption_paths.cu"
MAX_FACTORS = 8               # the launchers refuse more (kMaxFactors)

#: kernel launches since the last reset, per launcher (plain integers; a
#: run resets them and reads them to show that its main path went through
#: the kernels)
LAUNCHES = {"lmm_swaption_paths": 0, "lmm_swaption_paths_normals": 0,
            "lmm_stochvol_swaption_paths": 0,
            "lmm_stochvol_swaption_paths_normals": 0}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i32, f32, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_ulonglong)
    # volT, l0, deltas, then the scalars, then n (F), S, exercise, periods
    tail = {"lmm_swaption_paths": [ptr] * 3 + [f32] * 3 + [i32] * 4 + [ptr],
            "lmm_stochvol_swaption_paths":
                [ptr] * 3 + [f32] * 7 + [i32] * 5 + [ptr]}
    for name, args in tail.items():
        getattr(lib, f"{name}_launch").argtypes = [ptr, i32, u64] + args
        getattr(lib, f"{name}_normals_launch").argtypes = [ptr, ptr, i32] + args
        getattr(lib, f"{name}_launch").restype = i32
        getattr(lib, f"{name}_normals_launch").restype = i32
    lib.lmm_swaption_paths_error_string.argtypes = [i32]
    lib.lmm_swaption_paths_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> None:
    """Build and load the kernels' library (first use only)."""
    _library()


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


def _launch(key: str, payoff: torch.Tensor, head, volT, l0, deltas, scal,
            ints) -> torch.Tensor:
    """Launch ``<key>_launch`` with the arguments ``head`` after ``payoff``
    on the current stream of ``payoff``'s device; raises if it fails."""
    lib = _library()
    device = payoff.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{key}_launch")(
            payoff.data_ptr(), *head, volT.data_ptr(), l0.data_ptr(),
            deltas.data_ptr(), *scal, *ints, stream)
    if err != 0:
        msg = lib.lmm_swaption_paths_error_string(err).decode()
        raise RuntimeError(f"{key} launch failed: {msg} ({err})")
    LAUNCHES[key] += 1
    return payoff


def launch_prng(name: str, payoff: torch.Tensor, seed: int, volT, l0, deltas,
                scal, ints) -> torch.Tensor:
    """Launch the kernel ``name`` drawing its own normals from ``seed``, one
    path per element of ``payoff``."""
    return _launch(name, payoff, (payoff.shape[0], seed), volT, l0, deltas,
                   scal, ints)


def launch_injected(name: str, payoff: torch.Tensor, z: torch.Tensor, volT,
                    l0, deltas, scal, ints) -> torch.Tensor:
    """Launch the kernel ``name`` on the normals ``z`` ``[rows,
    payoff.shape[0]]``."""
    return _launch(f"{name}_normals", payoff, (z.data_ptr(), payoff.shape[0]),
                   volT, l0, deltas, scal, ints)


def running_sum(c: torch.Tensor) -> torch.Tensor:
    """Inclusive running sums along dim 0 in the tensor's own type, one
    addition after another from 0 (the kernels' order; ``torch.cumsum``
    on the CPU accumulates float32 in float64)."""
    out = torch.empty_like(c)
    acc = torch.zeros_like(c[0])
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
