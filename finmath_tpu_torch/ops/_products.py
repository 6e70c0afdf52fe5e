"""What the two LMM products kernels' wrappers (``lmm_kernel``,
``lmm_stochvol_kernel``) share: input checks, the per-step product tables,
the instantiation a launch runs (``sweep_variant``), the parameter sets
packed as the kernels stage them (``pack_parameter_sets``), and the
kernels' running sums in their own order of float32 additions, which the
plain versions take (``running_sums``, ``bond_prefix``), and their float64
path reduction in its own order (``tile_partials``).

A product is ``(exercise index, periods, strike)``; the products are
grouped by ascending exercise index, the engine's order.

The kernels (``csrc/lmm_sweep.cuh``) carry one path a thread, its forward
curve in registers, and take every running sum over the libors one
addition after another from 0, in float32. ``torch.cumsum`` is not that
order on the CPU, where it accumulates float32 in float64; the helpers here
are. The kernels are built with ``-fmad=false`` (``SWEEP_FLAGS``), so
``nvcc`` fuses no multiply and the add after it into one FMA: every float32
operation rounds once, as in the plain versions, and a kernel's partials
equal ``tile_partials`` of its plain version's path values bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

Product = Tuple[int, int, float]


class ProductTables(NamedTuple):
    """The products as the kernels read them, on one device."""

    step_first: torch.Tensor   # [S+2] int32: products of step s are
                               # [step_first[s], step_first[s+1])
    periods: torch.Tensor      # [P] int32
    strikes: torch.Tensor      # [P] float32
    order: torch.Tensor        # [P] int32: the products of each step by
                               # ascending end period (then index)


def check_products(products: Sequence[Product], num_libors: int) -> int:
    """Validate the product packing; returns the step count S."""
    if not products:
        raise ValueError("at least one product is required")
    es = [int(e) for e, _, _ in products]
    if any(b < a for a, b in zip(es, es[1:])):
        raise ValueError("products must be grouped by ascending exercise "
                         "index (engine order)")
    for e, m, _ in products:
        if e < 1 or m < 1 or e + m > num_libors:
            raise ValueError(f"product (e={e}, m={m}) does not fit on "
                             f"{num_libors} libors")
    return es[-1]


def check_tensor(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, z on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=8)
def product_tables(products: Tuple[Product, ...],
                   device: torch.device) -> ProductTables:
    """The step offsets, periods and strikes of ``products`` on ``device``."""
    S = products[-1][0]
    counts = np.bincount([e for e, _, _ in products], minlength=S + 2)
    step_first = np.concatenate([[0], np.cumsum(counts)[:S + 1]])
    order = sorted(range(len(products)),
                   key=lambda k: (products[k][0], products[k][1], k))
    return ProductTables(
        torch.from_numpy(step_first.astype(np.int32)).to(device),
        torch.from_numpy(np.asarray([m for _, m, _ in products],
                                    np.int32)).to(device),
        torch.from_numpy(np.asarray([k for _, _, k in products],
                                    np.float32)).to(device),
        torch.from_numpy(np.asarray(order, np.int32)).to(device))


# ---------------------------------------------------------------------------
# the instantiation, packed parameter sets, and the kernels' order of sums
# ---------------------------------------------------------------------------

MAX_LIBORS = 128              # LMM_K <= 128 in csrc/lmm_sweep.cuh
THREADS = 256                 # threads (paths) a block (kThreads)
WARP = 32
#: the products kernels' extra nvcc flags: no FMA contraction, so that each
#: float32 multiply and add rounds as in the plain versions
SWEEP_FLAGS = ("-fmad=false",)


def row_chunk(num_factors: int) -> int:
    """Rows of the drift sweep that a kernel computes between two checks
    for dead rows (``LMM_R``): no branch splits a chunk, so its rows'
    independent work overlaps. Measured on an H100 (``PERF.md``, PR 5):
    8 rows at one factor, 4 above."""
    return 8 if num_factors == 1 else 4


def sweep_variant(num_libors: int, num_factors: int):
    """``(K, F, R)``: the instantiation of a products kernel for a curve of
    ``K = num_libors`` libors and ``F`` factors."""
    return (int(num_libors), int(num_factors), row_chunk(int(num_factors)))


def sweep_defines(K: int, F: int, R: int):
    """The ``nvcc`` defines of the ``(K, F, R)`` instantiation of a
    products kernel."""
    return (("LMM_K", K), ("LMM_F", F), ("LMM_R", R))


def padded_libors(num_libors: int) -> int:
    """``NP``: the libor count of the packed tables, rounded up to 4
    (``kNP``)."""
    return -(-num_libors // 4) * 4


def loading_layout(num_factors: int) -> Tuple[int, int]:
    """``(C, V)``: a libor's F loadings, padded to 1, 2, 4 or 8 floats, as
    ``C`` vectors of ``V`` floats (``kC``, ``kV`` in the kernels)."""
    F = num_factors
    fp = 1 if F == 1 else 2 if F == 2 else 4 if F <= 4 else 8
    return fp // min(fp, 4), min(fp, 4)


def pack_parameter_sets(volT_b, scal_b, columns: Sequence[torch.Tensor], *,
                        num_factors: int) -> torch.Tensor:
    """``[B, W]`` float32, one parameter set a row, as a kernel block stages
    it: the 8 scalars, the per-libor ``columns`` (each ``[B, n]`` or
    ``[n]``) interleaved ``[NP][Q]``, then the loadings step-major
    ``[S][C][NP][V]``; padding is zero. A fresh contiguous tensor, so the
    table is 16-byte aligned, and ``W`` is a multiple of 4 floats (``NP``
    is): every set a whole number of the bulk copies' 16-byte chunks."""
    B, rows, S = volT_b.shape
    F = num_factors
    n = rows // F
    NP = padded_libors(n)
    C, V = loading_layout(F)
    vol = nnf.pad(volT_b.view(B, F, n, S), (0, 0, 0, NP - n, 0, C * V - F))
    vol = vol.view(B, C, V, NP, S).permute(0, 4, 1, 3, 2)
    cols = torch.stack([c.expand(B, n) for c in columns], dim=-1)
    cols = nnf.pad(cols, (0, 0, 0, NP - n))
    return torch.cat([scal_b, cols.reshape(B, -1), vol.reshape(B, -1)],
                     dim=1).contiguous()


def running_sums(c: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Inclusive running sums of ``c`` ``[..., n, paths]`` along the
    libors, one addition after another in ``c``'s type from 0 at libor
    ``first`` (the kernels' order, each addition rounded on its own as the
    kernels built without contraction round it); the libors before
    ``first`` (dead, adding nothing in the kernels) come out 0."""
    out = torch.zeros_like(c)
    acc = torch.zeros_like(c[..., 0, :])
    for i in range(first, c.shape[-2]):
        acc = acc + c[..., i, :]
        out[..., i, :] = acc
    return out


def bond_prefix(L: torch.Tensor, d: torch.Tensor, first: int, last: int):
    """The running bond product and annuity of the forward curve ``L``
    ``[..., n, paths]`` with period lengths ``d`` (``[n, 1]``, or
    broadcasting with ``L``), from period ``first`` on, one period after
    another as the kernels take them: ``cp = cp * (1 / (1 + d L))``, ``ann
    = ann + cp * d``, each operation rounded on its own (no FMA). Valid at
    the periods ``first .. last`` (1 and 0 elsewhere)."""
    cp_out, ann_out = torch.ones_like(L), torch.zeros_like(L)
    cp = torch.ones_like(L[..., 0, :])
    ann = torch.zeros_like(cp)
    for i in range(first, last + 1):
        di = d[..., i, :]
        cp = cp * (1.0 / (1.0 + di * L[..., i, :]))
        ann = ann + cp * di
        cp_out[..., i, :], ann_out[..., i, :] = cp, ann
    return cp_out, ann_out


def tile_partials(values: torch.Tensor) -> torch.Tensor:
    """The float64 partials ``[B, tiles, R]`` that a products kernel writes
    for the path values ``values`` ``[B, R, num_paths]`` (float64, a
    dropped path 0.0), in the kernel's order of additions
    (``csrc/lmm_sweep.cuh::warp_path_sum`` and the tile sum after it): per
    warp of 32 paths the shuffle tree at offsets 16, 8, 4, 2, 1, lane ``i``
    adding lane ``i + offset``; per tile of ``THREADS`` paths the warp sums
    added one after another from warp 0. Paths past ``num_paths`` count as
    0.0."""
    B, R, paths = values.shape
    tiles = -(-paths // THREADS)
    v = nnf.pad(values, (0, tiles * THREADS - paths))
    v = v.reshape(B, R, tiles, THREADS // WARP, WARP)
    half = WARP // 2
    while half >= 1:
        v = v[..., :half] + v[..., half:2 * half]
        half //= 2
    warps = v[..., 0]                                   # [B, R, tiles, warps]
    acc = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        acc = acc + warps[..., w]
    return acc.transpose(1, 2).contiguous()
