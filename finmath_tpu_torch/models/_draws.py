"""The random draws and the packed prices of the equity engines (Heston,
Merton, Variance-Gamma, Bates, Bachelier, displaced lognormal).

Each engine takes its draws from the caller, in the JAX kernel's shapes
(a ``[steps, paths]`` float32 block per kind, ``paths / 2`` when
antithetic), or draws them from a ``torch.Generator`` of the device seeded
with the engine's ``seed``. The antithetic mirrors are the JAX ones:
``[z, -z]`` for normals, ``[u, 1 - u]`` for uniforms, and the gamma clock
shared between the halves, not mirrored.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..utils.config import to_device


def np_dtype(dtype: torch.dtype):
    """The NumPy scalar type of a path dtype (float32 or float64): the
    engines round their scalar coefficients in it, as the JAX kernels cast
    their parameters to the path dtype."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"not {dtype}")
    return np.float32 if dtype == torch.float32 else np.float64


def draw_block(gen: torch.Generator, kind: str, shape, device,
               low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """A float32 block from ``gen`` on ``device``: standard normals
    (``kind="normal"``) or uniforms in [low, high) clamped to [low, high]
    (``"uniform"``)."""
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=FLOAT_DTYPE,
                           device=device)
    u = torch.rand(shape, generator=gen, dtype=FLOAT_DTYPE, device=device)
    if (low, high) == (0.0, 1.0):
        return u
    lo, hi = np.float32(low), np.float32(high)
    return torch.clamp(u * float(hi - lo) + float(lo), float(lo), float(hi))


def injected_block(z, shape, device, what: str) -> torch.Tensor:
    """A caller's block as float32 on ``device``, checked to be ``shape``."""
    if not isinstance(z, torch.Tensor):
        z = np.array(z, dtype=np.float32)     # a writable copy
    z = torch.as_tensor(z, dtype=FLOAT_DTYPE).to(device)
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"{what} of shape {tuple(z.shape)}; need "
                         f"{list(shape)}")
    return z


def mirror(block: torch.Tensor, kind: str, antithetic: bool) -> torch.Tensor:
    """The antithetic mirror along the path axis (the last): ``[z, -z]``
    for normals, ``[u, 1 - u]`` for uniforms, ``[g, g]`` for the gamma
    clock."""
    if not antithetic:
        return block
    other = {"normal": lambda b: -b, "uniform": lambda b: 1.0 - b,
             "gamma": lambda b: b}[kind](block)
    return torch.cat([block, other], dim=-1)


def draws(given, kinds, shape, antithetic: bool, seed: int, device, names,
          bounds=None) -> list:
    """The mirrored blocks of one engine: the caller's (``given``, one
    block of ``shape`` per kind) or, when ``given`` is None, drawn in
    ``kinds`` order ("normal" or "uniform") from a generator of ``device``
    seeded with ``seed``. ``bounds`` maps a block's position to its
    uniforms' (low, high)."""
    if given is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        blocks = [draw_block(gen, k, shape, device,
                             *(bounds or {}).get(i, (0.0, 1.0)))
                  for i, k in enumerate(kinds)]
    else:
        if len(given) != len(kinds):
            raise ValueError(f"need {len(kinds)} injected blocks "
                             f"({', '.join(names)}), got {len(given)}")
        blocks = [injected_block(z, shape, device, name)
                  for z, name in zip(given, names)]
    return [mirror(b, k, antithetic) for b, k in zip(blocks, kinds)]


def terminal_mean(x: torch.Tensor, df: float = 1.0) -> torch.Tensor:
    """The float64 mean of a [paths] tensor, times ``df`` (0-dim)."""
    return torch.sum(x.to(ACC_DTYPE)) / x.shape[-1] * df


def pack_prices(st: torch.Tensor, strikes, df: float, head) -> np.ndarray:
    """``[*head, prices...]`` float64 in one host copy: the terminal values
    ``st`` [paths] priced as calls at every strike (rounded to ``st``'s
    dtype) with float64 means, discounted by ``df``."""
    n = st.shape[-1]
    ks = to_device(np.asarray(strikes, dtype=np.float64), ACC_DTYPE,
                   st.device).to(st.dtype)
    payoff = torch.clamp_min(st[None, :] - ks[:, None], 0.0)
    prices = torch.sum(payoff.to(ACC_DTYPE), dim=1) / n * df
    return torch.cat([torch.stack(list(head)), prices]).cpu().numpy()
