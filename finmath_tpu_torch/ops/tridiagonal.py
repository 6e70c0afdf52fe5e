"""Batched tridiagonal solver by parallel prefix (doubling scans).

Counterpart of ``finmath_tpu.ops.tridiagonal``. The finite-difference layer
(``models/pde.py``) solves one tridiagonal system per time step, batched
over strikes, volatilities or scenarios. The Thomas algorithm is written as
three prefix scans along the grid axis, so each scan takes log2(n) rounds
of element-wise tensor operations over every batch element at once:

* forward elimination of the superdiagonal is a Moebius (linear-fractional)
  recurrence c_i = up_i / (di_i - lo_i c_{i-1}); composing Moebius maps is
  2x2 matrix multiplication, which is associative;
* the forward-substituted right-hand side and the back substitution are
  first-order affine recurrences y_i = a_i y_{i-1} + b_i, composed as
  (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2).

torch has no associative scan, so each prefix is an inclusive doubling
(Hillis-Steele) scan: round j combines every element with the one 2^j
places before it, the first 2^j padded with the identity map. The JAX
package's ``lax.associative_scan`` combines in another order, so the two
differ in rounding only. The Moebius combine renormalises by the largest
entry, as the JAX one does, so prefix products cannot over- or underflow.
Everything is element-wise arithmetic, so autograd differentiates through
the solve.

``method="scan"``, the sequential Thomas sweep (a Python loop over the
grid axis, the batch axes vectorised), is kept as the plain reference: it
issues some 2n operations a solve where the prefix method issues a few
dozen per round.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["tridiagonal_solve", "tridiagonal_matvec"]


def tridiagonal_matvec(lo: torch.Tensor, di: torch.Tensor, up: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """y_i = lo_i x_{i-1} + di_i x_i + up_i x_{i+1} along the last axis.

    lo[..., 0] and up[..., -1] are ignored (outside the band).
    """
    y = di * x
    y = y + F.pad(lo[..., 1:] * x[..., :-1], (1, 0))
    y = y + F.pad(up[..., :-1] * x[..., 1:], (0, 1))
    return y


def _shifted(v: torch.Tensor, s: int, fill: float,
             reverse: bool) -> torch.Tensor:
    """``v`` moved ``s`` places along the last axis, towards its end (its
    start when ``reverse``), the vacated places set to ``fill``."""
    if reverse:
        return F.pad(v[..., s:], (0, s), value=fill)
    return F.pad(v[..., :-s], (s, 0), value=fill)


def _doubling_scan(combine, elems, identity, reverse: bool = False):
    """Inclusive prefix of ``elems`` (a tuple of tensors, the scan on their
    last axis) under the associative ``combine(left, right)``, ``left``
    the earlier part; from the end of the axis when ``reverse``."""
    n = elems[0].shape[-1]
    s = 1
    while s < n:
        left = tuple(_shifted(v, s, e, reverse)
                     for v, e in zip(elems, identity))
        elems = combine(left, elems)
        s *= 2
    return elems


def _affine_combine(left, right):
    """Compose affine maps: apply ``left`` first, then ``right``."""
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def _affine_prefix(a: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """Inclusive prefix of y_i = a_i y_prev + b_i with y_start = 0.

    Forward: y_i over i = 0..n-1 with y_{-1} = 0. Reverse: the same
    recurrence run from the other end (y_i = a_i y_{i+1} + b_i, y_n = 0).
    Scanned along the LAST axis; batch axes broadcast element-wise.
    """
    _, y = _doubling_scan(_affine_combine, (a, b), (1.0, 0.0), reverse)
    return y


def _moebius_combine(left, right):
    """Compose Moebius maps (2x2 matrices, right @ left) and renormalise.

    The map c -> (A c + B) / (C c + D) is invariant under scaling the
    matrix, so dividing by the largest entry keeps prefix products in
    range regardless of n."""
    a1, b1, c1, d1 = left
    a2, b2, c2, d2 = right
    a = a2 * a1 + b2 * c1
    b = a2 * b1 + b2 * d1
    c = c2 * a1 + d2 * c1
    d = c2 * b1 + d2 * d1
    norm = torch.maximum(torch.maximum(torch.abs(a), torch.abs(b)),
                         torch.maximum(torch.abs(c), torch.abs(d)))
    norm = torch.where(norm > 0, norm, 1.0)
    return a / norm, b / norm, c / norm, d / norm


def _factor(lo, di, up):
    """The elimination of the superdiagonal, which depends on the matrix
    alone: ``(-lo / m, m, -c)`` with c the eliminated superdiagonal and m
    the pivots. A matrix that does not change between solves is factored
    once (``models/pde.py``)."""
    # c_i = up_i / (di_i - lo_i c_{i-1}), c_{-1} = 0: Moebius map with
    # matrix [[0, up_i], [-lo_i, di_i]] applied to the projective point
    # (0 : 1). The inclusive prefix matrix [[A, B], [C, D]] gives c_i = B/D.
    zeros = torch.zeros_like(di)
    _, B, _, D = _doubling_scan(_moebius_combine, (zeros, up, -lo, di),
                                (1.0, 0.0, 0.0, 1.0))
    c = B / D
    c_prev = F.pad(c[..., :-1], (1, 0))
    # pivot of the eliminated system; diagonal dominance (theta-scheme
    # matrices are strictly dominant) keeps it away from zero
    m = di - lo * c_prev
    return -lo / m, m, -c


def _solve_factored(factors, rhs):
    """Forward and back substitution on a factored matrix (``_factor``);
    the factors broadcast against ``rhs``'s batch axes."""
    a, m, neg_c = factors
    # forward substitution: d_i = (rhs_i - lo_i d_{i-1}) / m_i
    d = _affine_prefix(a, rhs / m)
    # back substitution: x_i = d_i - c_i x_{i+1}, x_n = 0
    return _affine_prefix(neg_c, d, reverse=True)


def _solve_scan(lo, di, up, rhs):
    """Sequential Thomas sweep, a loop over the grid (last) axis."""
    n = di.shape[-1]
    c_prev = d_prev = torch.zeros_like(di[..., 0])
    cs, ds = [], []
    for i in range(n):
        m = di[..., i] - lo[..., i] * c_prev
        c_prev = up[..., i] / m
        d_prev = (rhs[..., i] - lo[..., i] * d_prev) / m
        cs.append(c_prev)
        ds.append(d_prev)
    x_next = torch.zeros_like(di[..., 0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = ds[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def tridiagonal_solve(lo: torch.Tensor, di: torch.Tensor, up: torch.Tensor,
                      rhs: torch.Tensor, method: str = "prefix") -> torch.Tensor:
    """Solve lo_i x_{i-1} + di_i x_i + up_i x_{i+1} = rhs_i on the last axis.

    All four tensors broadcast to one shape ``[..., n]``; leading axes are
    batch (each batch element is an independent system). ``lo[..., 0]`` and
    ``up[..., -1]`` lie outside the band and are ignored.

    method="prefix" (default, on every device): three doubling scans,
    log2(n) rounds each. method="scan": the sequential Thomas sweep, the
    plain reference. Both are differentiable by autograd.
    """
    if method not in ("prefix", "scan"):
        raise ValueError(f"unknown method {method!r}; use 'prefix' or 'scan'")
    lo, di, up, rhs = torch.broadcast_tensors(lo, di, up, rhs)
    if method == "prefix":
        return _solve_factored(_factor(lo, di, up), rhs)
    return _solve_scan(lo, di, up, rhs)
