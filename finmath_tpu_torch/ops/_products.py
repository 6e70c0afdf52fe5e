"""Input checks and per-step product tables shared by the path-sweep kernel
wrappers (``lmm_kernel``, ``lmm_stochvol_kernel``).

A product is ``(exercise index, periods, strike)``; the products are
grouped by ascending exercise index, the engine's order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

Product = Tuple[int, int, float]


class ProductTables(NamedTuple):
    """The products as the kernels read them, on one device."""

    step_first: torch.Tensor   # [S+2] int32: products of step s are
                               # [step_first[s], step_first[s+1])
    periods: torch.Tensor      # [P] int32
    strikes: torch.Tensor      # [P] float32


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
    return ProductTables(
        torch.from_numpy(step_first.astype(np.int32)).to(device),
        torch.from_numpy(np.asarray([m for _, m, _ in products],
                                    np.int32)).to(device),
        torch.from_numpy(np.asarray([k for _, _, k in products],
                                    np.float32)).to(device))
