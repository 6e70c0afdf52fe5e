"""The normals that the program's pricer kernels draw for themselves,
worked out again: Philox4x32-10 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011) with the key = the 64-bit seed as (low,
high) words and the counter = (path, draw, 0, 0); each draw's four words
give two Box-Muller pairs, u1 = (w0 >> 8) 2^-24 + 2^-25, u2 = (w1 >> 8)
2^-24, theta = float32(2 pi) u2, normals r cos theta and r sin theta.
Normal q of a path is component q mod 4 of draw q // 4. The uniforms are
the stream's; the radius and the angle are taken in float64 here."""

from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _mul(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m, a < 2^32, from 16-bit halves so
    that no product leaves 63 bits."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    lo_lo = a_lo * m_lo
    mid1 = a_hi * m_lo
    mid2 = a_lo * m_hi
    hi_hi = a_hi * m_hi
    carry = (lo_lo >> 16) + (mid1 & 0xFFFF) + (mid2 & 0xFFFF)
    low = ((carry & 0xFFFF) << 16) | (lo_lo & 0xFFFF)
    high = hi_hi + (mid1 >> 16) + (mid2 >> 16) + (carry >> 16)
    return high & _MASK, low & _MASK


def philox_words(seed: int, paths: torch.Tensor, draw: int) -> torch.Tensor:
    """``[4, len(paths)]`` int64 output words of draw ``draw``."""
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    c0 = paths.to(torch.int64)
    c1 = torch.full_like(c0, draw)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for r in range(10):
        hi0, lo0 = _mul(c0, _M0)
        hi1, lo1 = _mul(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return torch.stack([c0, c1, c2, c3])


def _pair(w1: torch.Tensor, w2: torch.Tensor):
    u1 = (w1 >> 8).double() * 2.0 ** -24 + 2.0 ** -25
    u1 = u1.float().double()          # the stream rounds u1 to float32
    u2 = (w2 >> 8).double() * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI_F32 * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def normals(seed: int, lo: int, hi: int, count: int,
            device="cpu") -> torch.Tensor:
    """``[count, hi - lo]`` float64: normals 0 .. count - 1 of paths lo ..
    hi - 1."""
    paths = torch.arange(lo, hi, dtype=torch.int64, device=device)
    rows = []
    for draw in range(-(-count // 4)):
        w = philox_words(int(seed), paths, draw)
        rows.extend(_pair(w[0], w[1]))
        rows.extend(_pair(w[2], w[3]))
    return torch.stack(rows[:count])
