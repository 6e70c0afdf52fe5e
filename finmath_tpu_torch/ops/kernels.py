"""The Monte-Carlo Black-Scholes path kernels: the CUDA kernels, their
plain PyTorch versions, and the wrappers that pick between them by device.

Counterpart of ``finmath_tpu/ops/kernels.py``: ``bs_paths_kernel`` (the
Pallas kernel ``_bs_kernel``) and ``asian_paths_kernel`` (``_asian_kernel``)
with the entry points ``mc_european_call_price_kernel`` and
``mc_asian_call_price_kernel`` (the JAX package's
``mc_european_call_price_pallas`` and ``mc_asian_call_price_pallas``, kept
here as aliases). The kernels are ``csrc/mc_paths.cu``; its header says how
they map onto Hopper and what bounds them.

Each path draws its own normals from a counter-based Philox4x32-10: the
key is the 64-bit seed split into two words, the counter is
``(path, draw, 0, 0)``; one draw gives four 32-bit words, two Box-Muller
pairs, four normals. Step ``i`` of a path uses normal ``i`` of its stream:
a pair of steps uses the cosine and sine of one Box-Muller pair, as the
Pallas kernel uses both outputs of ``_draw_normal_pair``, and an odd last
step uses the cosine of the next pair. The uniforms are the Pallas
kernel's: ``u1 = (w >> 8) 2^-24 + 2^-25`` and ``u2 = (w >> 8) 2^-24``, exact
in float32. The TPU's own random bits cannot be reproduced, so the two
packages share the path arithmetic (tested on given normals), not the
stream.

Per path, in float32: log S starts at log S0, a pair of steps adds
``(drift + drift) + vol_sqrt_dt * (z1 + z2)``, an odd last step
``drift + vol_sqrt_dt * z1``; the European payoff is ``max(exp(log S) - K,
0)``; the Asian one sums ``exp(log S)`` after every step and pays
``max(sum / n - K, 0)``. The kernels write the float32 payoff of each path;
the wrappers take the float64 mean and discount in float64.

On a CUDA device the wrappers launch the kernels (and raise if a launch
fails); on the CPU they run the plain versions. ``LAUNCHES`` counts kernel
launches per kernel. Two check-only wrappers, which no pricing path calls,
hold the kernels' generator against the plain one: ``philox_normals`` (the
normals of given paths and draws) and ``box_muller_parts`` (the Box-Muller
radius and angle of each of the 2^24 values of ``w >> 8``, so every
normal the kernels can draw).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..utils.config import select_device
from . import _cuda_build

SOURCE = "mc_paths.cu"
FLAGS = ()                    # extra nvcc flags: none (explicit rounding)

#: kernel launches since the last reset, per kernel (plain integers; a run
#: resets them and reads them to show that its main path went through the
#: kernels)
LAUNCHES = {"bs_paths": 0, "asian_paths": 0, "philox_normals": 0,
            "box_muller_parts": 0}

# Philox4x32-10 constants (Salmon et al., Random123)
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
TWO_PI_F32 = float(np.float32(2.0 * math.pi))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("mc_bs_paths_launch", "mc_asian_paths_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, i32, i32, ctypes.c_ulonglong, f32, f32, f32, f32,
                       ptr]
        fn.restype = i32
    lib.mc_philox_normals_launch.argtypes = [ptr, i32, i32,
                                             ctypes.c_ulonglong, ptr]
    lib.mc_philox_normals_launch.restype = i32
    lib.mc_box_muller_parts_launch.argtypes = [ptr, i32, i32, ptr]
    lib.mc_box_muller_parts_launch.restype = i32
    lib.mc_paths_error_string.argtypes = [i32]
    lib.mc_paths_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> None:
    """Build and load the kernels' library (first use only)."""
    _library()


# ---------------------------------------------------------------------------
# plain versions: Philox, Box-Muller and the path arithmetic in torch
# ---------------------------------------------------------------------------

def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    return seed


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` for 32-bit ``a`` in int64: the
    wrapped 64-bit product keeps every bit (torch has no unsigned 32-bit
    multiply-high, and no shifts of uint64 on the CPU)."""
    p = a * m
    return (p >> 32) & _MASK32, p & _MASK32


def philox4x32_10(counter, key) -> torch.Tensor:
    """Philox4x32-10 on int64 tensors: ``counter`` four word tensors (or a
    ``[4, ...]`` tensor), ``key`` two words (ints or tensors), each in
    [0, 2^32); returns the ``[4, ...]`` int64 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3])


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def box_muller_radius(w1: torch.Tensor) -> torch.Tensor:
    """Box-Muller's radius ``sqrt(-2 log u1)`` of 32-bit words (int64), in
    float32 with the kernels' operation order."""
    dev = w1.device
    u1 = (w1 >> 8).to(torch.float32) * _f32(2.0 ** -24, dev) \
        + _f32(2.0 ** -25, dev)
    return torch.sqrt(_f32(-2.0, dev) * torch.log(u1))


def box_muller_angle(w2: torch.Tensor):
    """Box-Muller's ``(cos theta, sin theta)``, ``theta = 2 pi u2``, of
    32-bit words (int64), in float32 with the kernels' operation order."""
    dev = w2.device
    u2 = (w2 >> 8).to(torch.float32) * _f32(2.0 ** -24, dev)
    theta = _f32(TWO_PI_F32, dev) * u2
    return torch.cos(theta), torch.sin(theta)


def box_muller(w1: torch.Tensor, w2: torch.Tensor):
    """Two standard normals (cos, sin) from two 32-bit words per element
    (int64): the radius of ``w1`` times the angle's cosine and sine of
    ``w2``."""
    r = box_muller_radius(w1)
    c, s = box_muller_angle(w2)
    return r * c, r * s


def box_muller_parts_reference(count: int = 2 ** 24, stride: int = 1,
                               device="cpu") -> torch.Tensor:
    """Plain version of the check launcher: ``[3, count]`` float32, row 0
    the radius, rows 1-2 the cosine and sine of the angle, of the words
    ``m << 8`` for ``m = i * stride``; at ``stride`` 1 and ``count`` 2^24
    every value of ``w >> 8`` that a draw can see."""
    count, stride = _check_parts(count, stride)
    w = torch.arange(count, dtype=torch.int64, device=device) * stride << 8
    return torch.stack([box_muller_radius(w), *box_muller_angle(w)])


def normal_pairs(seed: int, num_paths: int, draws: int,
                 device="cpu") -> torch.Tensor:
    """The normals the kernels draw: ``[4 * draws, num_paths]`` float32,
    row ``4 d + k`` the k-th normal of draw ``d`` of each path (rows
    ``4 d``, ``4 d + 1`` the cosine and sine of the pair of words 0-1,
    rows ``4 d + 2``, ``4 d + 3`` of words 2-3)."""
    seed = _check_seed(seed)
    path = torch.arange(num_paths, dtype=torch.int64, device=device)
    draw = torch.arange(draws, dtype=torch.int64, device=device)
    c0 = path[None, :].expand(draws, num_paths)
    c1 = draw[:, None].expand(draws, num_paths)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w = philox4x32_10((c0, c1, zero, zero), (seed & _MASK32, seed >> 32))
    z0, z1 = box_muller(w[0], w[1])
    z2, z3 = box_muller(w[2], w[3])
    return torch.stack([z0, z1, z2, z3], dim=1).reshape(4 * draws, num_paths)


def path_params(num_steps: int, initial_value: float, risk_free_rate: float,
                volatility: float, maturity: float,
                strike: float) -> torch.Tensor:
    """``[log S0, drift per step, vol * sqrt(dt), K, 0, 0]``, computed in
    float64 and rounded to float32 (the Pallas kernels' SMEM params)."""
    dt = maturity / num_steps
    return torch.tensor(
        [math.log(initial_value),
         (risk_free_rate - 0.5 * volatility * volatility) * dt,
         volatility * math.sqrt(dt), strike, 0.0, 0.0],
        dtype=torch.float64).to(torch.float32)


def _path_start(z: torch.Tensor, params: torch.Tensor):
    params = params.to(z.device)
    log_s = params[0].expand(z.shape[1]).clone()
    return log_s, params[1], params[2], params[3]


def bs_payoffs_with_normals(z: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """European-call payoffs ``[paths]`` float32 from the normals ``z``
    ``[steps, paths]`` (step ``i`` uses row ``i``): the kernel's path
    arithmetic, steps in pairs."""
    steps = z.shape[0]
    log_s, drift, vol_sqrt_dt, strike = _path_start(z, params)
    for j in range(steps // 2):
        log_s = (log_s + (drift + drift)) + vol_sqrt_dt * (z[2 * j] + z[2 * j + 1])
    if steps % 2:
        log_s = (log_s + drift) + vol_sqrt_dt * z[steps - 1]
    return torch.clamp_min(torch.exp(log_s) - strike, 0.0)


def asian_payoffs_with_normals(z: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Arithmetic-average Asian-call payoffs ``[paths]`` float32 from the
    normals ``z`` ``[steps, paths]``: the running sum of S after every
    step, in the Pallas kernel's order."""
    steps = z.shape[0]
    log_s, drift, vol_sqrt_dt, strike = _path_start(z, params)
    sum_s = torch.zeros_like(log_s)
    for i in range(steps):
        log_s = (log_s + drift) + vol_sqrt_dt * z[i]
        sum_s = sum_s + torch.exp(log_s)
    avg = sum_s / torch.tensor(float(steps), dtype=torch.float32,
                               device=z.device)
    return torch.clamp_min(avg - strike, 0.0)


def _draws(num_steps: int) -> int:
    return -(-num_steps // 4)


def bs_paths_reference(seed: int, num_paths: int, num_steps: int,
                       params: torch.Tensor, device="cpu") -> torch.Tensor:
    """Plain version of the European kernel: its normals, then its path
    arithmetic; ``[num_paths]`` float32 payoffs on ``device``."""
    z = normal_pairs(seed, num_paths, _draws(num_steps), device)[:num_steps]
    return bs_payoffs_with_normals(z, params)


def asian_paths_reference(seed: int, num_paths: int, num_steps: int,
                          params: torch.Tensor, device="cpu") -> torch.Tensor:
    """Plain version of the Asian kernel; ``[num_paths]`` float32 payoffs."""
    z = normal_pairs(seed, num_paths, _draws(num_steps), device)[:num_steps]
    return asian_payoffs_with_normals(z, params)


# ---------------------------------------------------------------------------
# wrappers: the kernel on a CUDA device, the plain version on the CPU
# ---------------------------------------------------------------------------

def _check_sizes(num_paths: int, num_steps: int):
    num_paths, num_steps = int(num_paths), int(num_steps)
    if not 1 <= num_paths < 2 ** 31:
        raise ValueError(f"num_paths={num_paths} outside [1, 2^31)")
    if not 1 <= num_steps < 2 ** 31:
        raise ValueError(f"num_steps={num_steps} outside [1, 2^31)")
    return num_paths, num_steps


def _check_parts(count: int, stride: int):
    count, stride = int(count), int(stride)
    if count < 1 or stride < 1 or (count - 1) * stride >= 2 ** 24:
        raise ValueError(f"count={count}, stride={stride}: the words m << 8 "
                         "need 0 <= m = i * stride < 2^24")
    return count, stride


def _check_params(params) -> torch.Tensor:
    if not isinstance(params, torch.Tensor):
        raise TypeError("params must be a torch.Tensor")
    if params.dtype != torch.float32 or tuple(params.shape) != (6,):
        raise ValueError(f"params must be float32 [6], got {params.dtype} "
                         f"{tuple(params.shape)}")
    return params


def _launch(name: str, launcher: str, *args, device: torch.device) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, launcher)(*args, stream)
    if err != 0:
        msg = lib.mc_paths_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def _paths(name: str, plain, seed, num_paths, num_steps, params, device):
    seed = _check_seed(seed)
    num_paths, num_steps = _check_sizes(num_paths, num_steps)
    params = _check_params(params)
    device = torch.device(device) if device is not None else select_device()
    if device.type == "cpu":
        return plain(seed, num_paths, num_steps, params, device)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    out = torch.empty(num_paths, dtype=torch.float32, device=device)
    p = [float(v) for v in params[:4].tolist()]
    _launch(name, f"mc_{name}_launch", out.data_ptr(), num_paths, num_steps,
            seed, *p, device=device)
    return out


def bs_payoffs(seed: int, num_paths: int, num_steps: int,
               params: torch.Tensor, device=None) -> torch.Tensor:
    """European-call payoffs of ``num_paths`` paths, ``[num_paths]``
    float32 on ``device`` (default ``select_device()``): the kernel on a
    CUDA device, ``bs_paths_reference`` on the CPU."""
    return _paths("bs_paths", bs_paths_reference, seed, num_paths, num_steps,
                  params, device)


def asian_payoffs(seed: int, num_paths: int, num_steps: int,
                  params: torch.Tensor, device=None) -> torch.Tensor:
    """Asian-call payoffs, ``[num_paths]`` float32 (see ``bs_payoffs``)."""
    return _paths("asian_paths", asian_paths_reference, seed, num_paths,
                  num_steps, params, device)


def philox_normals(seed: int, num_paths: int, draws: int,
                   device=None) -> torch.Tensor:
    """The normals the path kernels draw, ``[4 * draws, num_paths]``
    float32, written by the kernels' own device generator on a CUDA device
    (``normal_pairs`` on the CPU). For checking the generator; no pricing
    path calls it."""
    seed = _check_seed(seed)
    num_paths, draws = _check_sizes(num_paths, draws)
    device = torch.device(device) if device is not None else select_device()
    if device.type == "cpu":
        return normal_pairs(seed, num_paths, draws, device)
    if device.type != "cuda":
        raise ValueError(f"philox_normals: unsupported device {device}")
    out = torch.empty((4 * draws, num_paths), dtype=torch.float32,
                      device=device)
    _launch("philox_normals", "mc_philox_normals_launch", out.data_ptr(),
            num_paths, draws, seed, device=device)
    return out


def box_muller_parts(count: int = 2 ** 24, stride: int = 1,
                     device=None) -> torch.Tensor:
    """The Box-Muller radius and angle of the words ``m << 8``, ``m = i *
    stride`` (``box_muller_parts_reference``), written by the kernels' own
    device functions on a CUDA device. At the defaults every input a draw
    can see: with the final multiply, every normal the kernels can draw.
    For checking; no pricing path calls it."""
    count, stride = _check_parts(count, stride)
    device = torch.device(device) if device is not None else select_device()
    if device.type == "cpu":
        return box_muller_parts_reference(count, stride, device)
    if device.type != "cuda":
        raise ValueError(f"box_muller_parts: unsupported device {device}")
    out = torch.empty((3, count), dtype=torch.float32, device=device)
    _launch("box_muller_parts", "mc_box_muller_parts_launch", out.data_ptr(),
            count, stride, device=device)
    return out


def _discounted_mean(payoffs: torch.Tensor, risk_free_rate: float,
                     maturity: float) -> torch.Tensor:
    mean = torch.sum(payoffs, dtype=torch.float64) / payoffs.shape[0]
    return mean * math.exp(-risk_free_rate * maturity)


def bs_paths_kernel(seed: int, num_paths: int, num_steps: int, s0, r, sigma,
                    maturity, strike, device=None) -> torch.Tensor:
    """Discounted Monte-Carlo European-call price (float64 0-d tensor on
    ``device``): the path kernel's payoffs, their float64 mean, exp(-rT)."""
    params = path_params(num_steps, s0, r, sigma, maturity, strike)
    return _discounted_mean(bs_payoffs(seed, num_paths, num_steps, params,
                                       device), r, maturity)


def asian_paths_kernel(seed: int, num_paths: int, num_steps: int, s0, r,
                       sigma, maturity, strike, device=None) -> torch.Tensor:
    """Discounted Monte-Carlo arithmetic-average Asian-call price (float64
    0-d tensor), observations at every step."""
    params = path_params(num_steps, s0, r, sigma, maturity, strike)
    return _discounted_mean(asian_payoffs(seed, num_paths, num_steps, params,
                                          device), r, maturity)


def mc_european_call_price_kernel(seed: int, num_paths: int, num_steps: int,
                                  initial_value: float, risk_free_rate: float,
                                  volatility: float, maturity: float,
                                  strike: float, device=None) -> float:
    """Alternative to ``models.black_scholes.mc_european_call_price`` with
    the whole path loop in one kernel launch."""
    return float(bs_paths_kernel(
        seed, num_paths, num_steps, float(initial_value),
        float(risk_free_rate), float(volatility), float(maturity),
        float(strike), device))


def mc_asian_call_price_kernel(seed: int, num_paths: int, num_steps: int,
                               initial_value: float, risk_free_rate: float,
                               volatility: float, maturity: float,
                               strike: float, device=None) -> float:
    """Arithmetic-average Asian call in one kernel launch (the observation
    dates are the Euler time steps)."""
    return float(asian_paths_kernel(
        seed, num_paths, num_steps, float(initial_value),
        float(risk_free_rate), float(volatility), float(maturity),
        float(strike), device))


# the JAX package's names for the same entry points
mc_european_call_price_pallas = mc_european_call_price_kernel
mc_asian_call_price_pallas = mc_asian_call_price_kernel
