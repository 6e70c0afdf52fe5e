"""One observation date of a netting set's exposure collection: the CUDA
kernel, its plain PyTorch version, and the wrapper that picks between
them by device.

At the date with tenor index ``e``, from the live forwards ``L`` ``[n - e,
paths]`` (``L[j]`` is forward ``e + j``, in the path dtype; the
valuation engine's collector contract) and the spot numeraire ``N``
``[paths]`` (the collect dtype), the collection forms the bond curve
``cp[k] = P(T_e, T_{e+k})`` and values every trade of the netting set on
it: the swaps' netted value, the sum of their positive parts and ``1 /
N(T_e)`` (float64), and each optionality underlying's remaining-swap value
(float64) and par rate (the path dtype), each written into the profile's
``[dates, ...]`` buffers (``CollectBuffers``) at the date's row. A path
whose outputs at a date are not all finite is zeroed in every output
afterwards (``zero_broken``).

``exposure_collect(L, N, plan, ev, out)`` routes on the device alone:
for CUDA tensors it launches the kernel (``csrc/exposure_collect.cu``) on
the current stream and returns without synchronising (it raises if the
launch fails, and on forwards or a numeraire that require grad, since
the kernel has no backward: ``profile`` collects under
``torch.no_grad()``); for CPU tensors it runs
``exposure_collect_reference``, the engine's composition of about 45
launches a date, and writes its outputs into the buffers. ``LAUNCHES``
counts kernel launches.

The kernel reads the forwards once and writes each output once; its
curve is the plain version's bit for bit; its annuities are k-order sums
with one fma a term where the plain version's product takes cuBLAS's (or
the CPU BLAS's) order, and its netted and positive-part sums run over
the trades in the table's order. So the two agree to rounding, not to the
bit (``tests/test_torch_exposure_collect.py`` states the bounds). The
kernel keeps a path's curve in shared memory while it fits a block's
(up to 223 periods with a float64 curve, 446 with a float32 one); on a
longer grid a launch allocates the curve in device memory, ``[m + 1,
paths]`` in the collect dtype (the library's
``exposure_collect_scratch_rows`` says when), and otherwise allocates
nothing, so calls from several threads into distinct buffers are safe.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _cuda_build
from ._products import SWEEP_FLAGS
from .random_variable import ACC_DTYPE

SOURCE = "exposure_collect.cu"
FLAGS = SWEEP_FLAGS

#: the kernel table's row kinds (``csrc/exposure_collect.cu``)
SWAP, UNDERLYING, MATURED = 0, 1, 2

#: kernel launches since the last reset (plain integer; a run resets it
#: and reads it to show that its main path went through the kernel);
#: counted under a lock, since engines may collect from several threads
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

_DTYPE_BYTES = {torch.float32: 4, torch.float64: 8}
_PAIRS = ((torch.float32, torch.float64), (torch.float64, torch.float64),
          (torch.float32, torch.float32))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE, (), FLAGS)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.exposure_collect_launch.argtypes = (
        [i32, i32, ptr, i64, ptr, ptr, i32, ptr, ptr, i32, i32, i32]
        + [ptr] * 8)
    lib.exposure_collect_launch.restype = i32
    lib.exposure_collect_scratch_rows.argtypes = [i32, i32]
    lib.exposure_collect_scratch_rows.restype = i32
    lib.exposure_collect_error_string.argtypes = [i32]
    lib.exposure_collect_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> None:
    """Build and load the kernel's library (first use only)."""
    _library()


@dataclasses.dataclass(frozen=True)
class CollectPlan:
    """A netting set's collection tables on one device, built once.

    ``dates``: the tenor index ``e`` of each observation date;
    ``deltas``: the period lengths ``[n]`` float64; the plain version's
    dense tables per date: ``swap_tables[ev]`` / ``und_tables[ev]`` (the
    pay mask ``[T, n - e]`` in the path dtype, the start and end rows of
    the curve), ``swap_strikes`` ``[T]``, ``swap_coefs`` ``[E, T]`` (signed
    notional, 0 once matured), ``und_strikes`` ``[K]``, ``und_alive``
    ``[E, K]`` (None without underlyings); the kernel's packed table,
    ``rows`` int32 ``[E, R, 4]`` (lo, hi, kind, underlying index) and
    ``reals`` float64 ``[E, R, 2]`` (strike, coefficient), of which date
    ``ev`` uses the first ``counts[ev]`` (``pack_rows``)."""

    dates: tuple
    deltas: torch.Tensor
    swap_tables: list
    swap_strikes: torch.Tensor
    swap_coefs: torch.Tensor
    und_tables: Optional[list]
    und_strikes: Optional[torch.Tensor]
    und_alive: Optional[torch.Tensor]
    rows: torch.Tensor
    reals: torch.Tensor
    counts: tuple
    path_dtype: torch.dtype
    collect_dtype: torch.dtype
    spot: bool

    @property
    def underlyings(self) -> int:
        return 0 if self.und_strikes is None else self.und_strikes.shape[0]


def pack_rows(dates: Sequence[int], swaps, swap_coefs: np.ndarray,
              underlyings, device):
    """The kernel's table: ``(rows int32 [E, R, 4], reals float64 [E, R,
    2], counts)``. ``swaps``: ``(first, last, strike)`` per swap, with
    ``swap_coefs`` ``[E, T]``; ``underlyings``: ``(first, last, strike)``
    per underlying (its index is its row in the buffers). At date ``e`` a
    trade with ``e < last`` pays over ``[max(e, first), last)``: its row
    is ``lo = max(e, first) - e``, ``hi = last - e``; a matured swap has no
    row and a matured underlying a ``MATURED`` one (its outputs are 0).
    The live rows are sorted by ``(lo, hi)``, so that rows of one start
    share one running sum in the kernel; the matured rows come last."""
    tables = []
    for ev, e in enumerate(dates):
        live, dead = [], []
        for t, (first, last, strike) in enumerate(swaps):
            if e < last:
                live.append((max(e, first) - e, last - e, SWAP, 0,
                             strike, float(swap_coefs[ev, t])))
        for k, (first, last, strike) in enumerate(underlyings):
            if e < last:
                live.append((max(e, first) - e, last - e, UNDERLYING, k,
                             strike, 0.0))
            else:
                dead.append((0, 0, MATURED, k, 0.0, 0.0))
        tables.append(sorted(live, key=lambda r: (r[0], r[1])) + dead)
    counts = tuple(len(t) for t in tables)
    R = max(max(counts), 1)
    rows = np.zeros((len(dates), R, 4), dtype=np.int32)
    reals = np.zeros((len(dates), R, 2), dtype=np.float64)
    for ev, table in enumerate(tables):
        for i, (lo, hi, kind, index, strike, coef) in enumerate(table):
            rows[ev, i] = (lo, hi, kind, index)
            reals[ev, i] = (strike, coef)
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(reals, device=device), counts)


class CollectBuffers(NamedTuple):
    """A profile's collected values, one row a date: ``net``, ``plus``,
    ``inv`` ``[E, paths]`` float64; with underlyings ``und`` ``[E, K,
    paths]`` float64, ``rates`` ``[E, K, paths]`` in the path dtype and
    ``und_finite`` ``[E, paths]`` bool (else None)."""

    net: torch.Tensor
    plus: torch.Tensor
    inv: torch.Tensor
    und: Optional[torch.Tensor]
    rates: Optional[torch.Tensor]
    und_finite: Optional[torch.Tensor]


def collect_buffers(plan: CollectPlan, paths: int, device) -> CollectBuffers:
    """Uninitialised buffers for one profile of ``paths`` paths."""
    E, K = len(plan.dates), plan.underlyings

    def empty(*shape, dtype=ACC_DTYPE):
        return torch.empty(shape, dtype=dtype, device=device)

    if not K:
        return CollectBuffers(empty(E, paths), empty(E, paths),
                              empty(E, paths), None, None, None)
    return CollectBuffers(empty(E, paths), empty(E, paths), empty(E, paths),
                          empty(E, K, paths),
                          empty(E, K, paths, dtype=plan.path_dtype),
                          empty(E, paths, dtype=torch.bool))


def zero_broken(out: CollectBuffers) -> None:
    """Zero, in every buffer, each (date, path) whose outputs are not all
    finite: its netted value, positive-part sum, 1/N and (with
    underlyings) its underlyings' flag."""
    finite = (torch.isfinite(out.net) & torch.isfinite(out.inv)
              & torch.isfinite(out.plus))
    if out.und is not None:
        finite = finite & out.und_finite
    broken = ~finite
    for buf in (out.net, out.plus, out.inv, out.und, out.rates):
        if buf is not None:
            buf.masked_fill_(broken if buf.dim() == 2 else broken[:, None],
                             0.0)


def _check(name, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the forwards on "
                         f"{device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_inputs(L, N, plan: CollectPlan, ev: int, out: CollectBuffers):
    """``(e, paths)``; raises on what the kernel does not take."""
    if (plan.path_dtype, plan.collect_dtype) not in _PAIRS:
        raise ValueError(f"path / collect dtypes {plan.path_dtype} / "
                         f"{plan.collect_dtype}: not an engine's pair")
    if not 0 <= ev < len(plan.dates):
        raise ValueError(f"date ordinal {ev} outside [0, "
                         f"{len(plan.dates)})")
    if not isinstance(L, torch.Tensor) or L.dim() != 2:
        raise ValueError("L must be a [n - e, paths] tensor")
    e = plan.dates[ev]
    n, paths = plan.deltas.shape[0], L.shape[1]
    if not 1 <= e < n:
        raise ValueError(f"date {ev} at tenor index {e}: outside [1, {n})")
    device = L.device
    _check("L", L, plan.path_dtype, (n - e, paths), device)
    if paths < 1 or L.stride(1) != 1:
        raise ValueError("L's path axis must be contiguous (stride 1)")
    _check("N", N, plan.collect_dtype, (paths,), device)
    _check("plan.deltas", plan.deltas, ACC_DTYPE, (n,), device)
    E, K = len(plan.dates), plan.underlyings
    R = plan.rows.shape[1]
    _check("plan.rows", plan.rows, torch.int32, (E, R, 4), device)
    _check("plan.reals", plan.reals, ACC_DTYPE, (E, R, 2), device)
    for name in ("net", "plus", "inv"):
        _check(f"out.{name}", getattr(out, name), ACC_DTYPE, (E, paths),
               device)
    if K:
        _check("out.und", out.und, ACC_DTYPE, (E, K, paths), device)
        _check("out.rates", out.rates, plan.path_dtype, (E, K, paths),
               device)
        _check("out.und_finite", out.und_finite, torch.bool, (E, paths),
               device)
    elif out.und is not None:
        raise ValueError("out.und given, but the plan has no underlyings")
    for name, t in out._asdict().items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"out.{name} must be contiguous")
    return e, paths


def exposure_collect(L, N, plan: CollectPlan, ev: int,
                     out: CollectBuffers) -> None:
    """Collect date ``ev`` of ``plan`` into row ``ev`` of ``out`` (see the
    module docstring)."""
    global LAUNCHES
    e, paths = _check_inputs(L, N, plan, ev, out)
    device = L.device
    if device.type == "cpu":
        write_rows(out, ev, exposure_collect_reference(L, N, plan, ev))
        return
    if device.type != "cuda":
        raise ValueError(f"exposure_collect: unsupported device {device}")
    if torch.is_grad_enabled() and (L.requires_grad or N.requires_grad):
        raise ValueError("exposure_collect: the kernel has no backward; "
                         "collect forwards that require grad under "
                         "torch.no_grad()")
    m = L.shape[0]
    ld = L.stride(0) if m > 1 else paths

    def row(t):
        return t[ev].data_ptr() if t is not None else None

    lib = _library()
    rows = lib.exposure_collect_scratch_rows(
        _DTYPE_BYTES[plan.collect_dtype], m)
    curve = (torch.empty((rows, paths), dtype=plan.collect_dtype,
                         device=device) if rows else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.exposure_collect_launch(
            _DTYPE_BYTES[plan.path_dtype], _DTYPE_BYTES[plan.collect_dtype],
            L.data_ptr(), ld, N.data_ptr(), plan.deltas[e:].data_ptr(), m,
            plan.rows[ev].data_ptr(), plan.reals[ev].data_ptr(),
            plan.counts[ev], int(plan.spot), paths, row(out.net),
            row(out.plus), row(out.inv), row(out.und), row(out.rates),
            row(out.und_finite),
            curve.data_ptr() if curve is not None else None, stream)
    if err != 0:
        msg = lib.exposure_collect_error_string(err).decode()
        raise RuntimeError(f"exposure_collect launch failed: {msg} ({err})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1


def swap_values(cp, table, strikes, path_dtype):
    """(``[T, paths]`` remaining-swap values, ``[T, paths]`` annuities),
    float64, from the bond curve: the annuity is one product in the path
    dtype, cast to float64."""
    ann = (table["mask"] @ cp[1:].to(path_dtype)).to(ACC_DTYPE)
    p_start = cp[table["start"]].to(ACC_DTYPE)
    p_end = cp[table["end"]].to(ACC_DTYPE)
    return p_start - p_end - strikes[:, None] * ann, ann


def exposure_collect_reference(L, N, plan: CollectPlan, ev: int):
    """Plain PyTorch version on any device: ``(net, plus, inv)`` without
    underlyings, else ``(net, plus, und, rates, inv)``, the underlyings'
    ``[K, paths]`` rates in float64 (the buffers round them to the path
    dtype). The bond curve is a ``cumprod`` in the collect dtype, the
    annuities one ``[trades, n - e] @ [n - e, paths]`` product in the path
    dtype, cast to float64."""
    e = plan.dates[ev]
    cd = plan.collect_dtype
    d = plan.deltas[e:, None].to(cd)
    cp = torch.cumprod(1.0 / (1.0 + d * L.to(cd)), dim=0)
    cp = torch.cat([torch.ones_like(cp[:1]), cp])
    inv_n = (1.0 / N.to(ACC_DTYPE) if plan.spot
             else 1.0 / cp[-1].to(ACC_DTYPE))
    raw, _ = swap_values(cp, plan.swap_tables[ev], plan.swap_strikes,
                          plan.path_dtype)
    v_trade = plan.swap_coefs[ev][:, None] * raw
    v_net = torch.sum(v_trade, dim=0)                          # [paths]
    s_plus = torch.sum(torch.clamp_min(v_trade, 0.0), dim=0)   # [paths]
    if not plan.underlyings:
        return v_net, s_plus, inv_n
    # the underlyings: remaining swap value and par rate (the
    # regression feature), unit notional, alive-masked
    raw_u, ann_u = swap_values(cp, plan.und_tables[ev], plan.und_strikes,
                                plan.path_dtype)
    alive = plan.und_alive[ev][:, None]
    v_und = alive * raw_u                                      # [K, paths]
    float_u = v_und + plan.und_strikes[:, None] * ann_u * alive
    srate = float_u / torch.clamp_min(ann_u, 1e-12)
    return v_net, s_plus, v_und, srate, inv_n


def write_rows(out: CollectBuffers, ev: int, values) -> None:
    """Row ``ev`` of the buffers from the plain version's ``values``: an
    underlying's flag is a date's one sum of ``(v - v) + (s - s)`` (0
    where all are finite, NaN otherwise)."""
    out.net[ev].copy_(values[0])
    out.plus[ev].copy_(values[1])
    out.inv[ev].copy_(values[-1])
    if out.und is not None:
        v_u, s_u = values[2], values[3]
        out.und_finite[ev] = ((v_u - v_u) + (s_u - s_u)).sum(dim=0) == 0.0
        out.und[ev].copy_(v_u)
        out.rates[ev].copy_(s_u)
