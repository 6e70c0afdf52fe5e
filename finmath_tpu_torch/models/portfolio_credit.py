"""Portfolio credit: one-factor Gaussian copula default baskets, the exact
loss-distribution recursion, CDO tranche pricing, kth-to-default, the
Vasicek large-pool closed form, and a Monte Carlo over the full names x
paths latent matrix.

Counterpart of ``finmath_tpu.models.portfolio_credit``. The market-standard
one-factor Gaussian copula (Li 2000; Andersen-Sidenius-Basu 2003
bucketing; Vasicek 1991 large pool):

  X_i = beta_i Z + sqrt(1 - beta_i^2) eps_i,   tau_i <= t  iff
  X_i <= C_i(t) = Phi^{-1}(PD_i(t))

conditionally independent given the common factor Z.

* Host float64 analytic layer (NumPy, the JAX module's arithmetic
  unchanged): conditional PDs, the EXACT conditional-independence
  recursion for the loss and count distributions (Gauss-Hermite over the
  factor), tranche expected losses, tranche legs and par spreads,
  kth-to-default legs, and the Vasicek LHP closed form through the
  framework's bivariate normal CDF (``models/multi_asset.py``).
* Device Monte Carlo: ONE float32 latent matrix [names, paths] shared by
  all horizons (default times are coherent in t by construction); a loop
  over the horizons holds one horizon's indicator at a time; float64
  statistics packed into one tensor and one host copy.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..native.host_rng import inverse_normal_cdf_as241
from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..parallel.mesh import check_mesh, mesh_device, path_block, path_means
from ._draws import injected_block
from .analytic import _norm_cdf
from .credit import SurvivalCurve
from .curves import DiscountCurve
from .multi_asset import bivariate_normal_cdf


def _norm_cdf_vec(x) -> np.ndarray:
    """Vectorized standard normal CDF."""
    from scipy.special import ndtr
    return np.asarray(ndtr(np.asarray(x, dtype=np.float64)))


def _gh_nodes(n: int = 96):
    """Probabilists' Gauss-Hermite nodes/weights: int f(z) phi(z) dz
    ~= sum w_k f(z_k). Machine-precision for the smooth conditional-PD
    integrands at |beta| <= ~0.95; near the comonotone pole the
    integrand degenerates to a step and the error floor is ~4e-3 at 96
    nodes (tested). numpy's hermegauss overflows above ~200 nodes —
    keep n below that."""
    if n > 200:
        raise ValueError("hermegauss overflows above ~200 nodes")
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return x, w / math.sqrt(2.0 * math.pi)


class GaussianCopulaPortfolio:
    """One-factor Gaussian copula over ``names`` obligors. Marginals
    are ``SurvivalCurve``s (or one curve shared by all names); factor
    loadings ``betas`` in (-1, 1); ``recoveries`` and ``notionals``
    per name. Loss amounts l_i = notional_i (1 - R_i)."""

    def __init__(self, survival_curves, betas, recoveries=0.4,
                 notionals=None):
        if isinstance(survival_curves, SurvivalCurve):
            survival_curves = [survival_curves]
        self.curves = list(survival_curves)
        n = len(self.curves)
        b = np.broadcast_to(np.asarray(betas, dtype=np.float64),
                            (n,)).copy()
        if np.any(np.abs(b) >= 1.0):
            raise ValueError("betas must lie in (-1, 1)")
        r = np.broadcast_to(np.asarray(recoveries, dtype=np.float64),
                            (n,)).copy()
        if np.any((r < 0) | (r >= 1)):
            raise ValueError("recoveries must lie in [0, 1)")
        if notionals is None:
            notionals = 1.0
        w = np.broadcast_to(np.asarray(notionals, dtype=np.float64),
                            (n,)).copy()
        if np.any(w <= 0):
            raise ValueError("notionals must be positive")
        self.num_names = n
        self.betas = b
        self.recoveries = r
        self.notionals = w
        self.losses = w * (1.0 - r)
        self.total_notional = float(np.sum(w))

    # ------------------------------------------------------------------
    def default_probabilities(self, t) -> np.ndarray:
        """Unconditional PD_i(t), [names] (or [names, T])."""
        return np.stack([1.0 - c.get_survival_probability(t)
                         for c in self.curves])

    def default_thresholds(self, t) -> np.ndarray:
        """C_i(t) = Phi^{-1}(PD_i(t)), clipped away from the poles."""
        pd = np.clip(self.default_probabilities(t), 1e-16, 1 - 1e-16)
        return inverse_normal_cdf_as241(pd)

    def conditional_pd(self, t, z) -> np.ndarray:
        """p_i(t | Z=z): [names, Z]."""
        c = self.default_thresholds(t)[:, None]
        b = self.betas[:, None]
        s = np.sqrt(1.0 - b * b)
        return _norm_cdf_vec((c - b * np.asarray(z)[None, :]) / s)

    # ------------------------------------------------------------------
    # exact conditional-independence recursion (host f64)
    # ------------------------------------------------------------------
    def _units(self, unit: Optional[float]):
        """Integer loss units per name on a bucket grid. Exact when
        every loss is an integer multiple of ``unit`` (e.g. any
        homogeneous pool); otherwise LOUDLY refuses unless the rounding
        error is below 1e-9 relative — bucket-grid approximations must
        be opted into via an explicit unit."""
        if unit is None:
            unit = float(np.min(self.losses))
        k = self.losses / unit
        ki = np.rint(k).astype(np.int64)
        if np.any(ki < 1) or np.max(np.abs(k - ki)) > 1e-9 * np.max(k):
            raise ValueError(
                "losses are not integer multiples of the loss unit; pass "
                "an explicit unit= that divides every notional*(1-R)")
        return ki, unit

    def loss_distribution(self, t: float, unit: Optional[float] = None,
                          num_quadrature: int = 96):
        """(grid, pmf): the EXACT portfolio loss distribution at ``t``
        by the Andersen-Sidenius-Basu recursion conditional on the
        factor, integrated with Gauss-Hermite. grid[j] = j * unit."""
        ki, unit = self._units(unit)
        z, wq = _gh_nodes(num_quadrature)
        p = self.conditional_pd(t, z)                    # [N, Z]
        size = int(np.sum(ki)) + 1
        pmf = np.zeros((size, z.size))
        pmf[0] = 1.0
        top = 0
        for i in range(self.num_names):
            k = int(ki[i])
            top += k
            pmf[k:top + 1] = (pmf[k:top + 1] * (1.0 - p[i])
                              + pmf[:top + 1 - k] * p[i])
            pmf[:k] *= 1.0 - p[i]
        pmf = pmf @ wq
        return np.arange(size) * unit, pmf

    def default_count_distribution(self, t: float,
                                   num_quadrature: int = 96):
        """P(#defaults by t = k), k = 0..names — the same recursion on
        unit counts (exact for ANY heterogeneous pool)."""
        z, wq = _gh_nodes(num_quadrature)
        p = self.conditional_pd(t, z)
        pmf = np.zeros((self.num_names + 1, z.size))
        pmf[0] = 1.0
        for i in range(self.num_names):
            pmf[1:i + 2] = pmf[1:i + 2] * (1.0 - p[i]) + pmf[:i + 1] * p[i]
            pmf[0] *= 1.0 - p[i]
        return pmf @ wq

    def expected_tranche_loss(self, t: float, attachment: float,
                              detachment: float,
                              unit: Optional[float] = None) -> float:
        """E[min(max(L(t) - A, 0), D - A)] — exact from the loss
        distribution. A/D are absolute loss amounts (fractions of
        total notional times total notional)."""
        if not 0.0 <= attachment < detachment:
            raise ValueError("need 0 <= attachment < detachment")
        grid, pmf = self.loss_distribution(t, unit=unit)
        tranche = np.minimum(np.maximum(grid - attachment, 0.0),
                             detachment - attachment)
        return float(np.sum(tranche * pmf))

    def kth_to_default_probability(self, t: float, k: int) -> float:
        """P(at least k defaults by t) — exact."""
        if not 1 <= k <= self.num_names:
            raise ValueError("k must be in [1, names]")
        pmf = self.default_count_distribution(t)
        return float(np.sum(pmf[k:]))

    # ------------------------------------------------------------------
    # leg pricing off the exact distributions
    # ------------------------------------------------------------------
    def tranche_legs(self, discount_curve: DiscountCurve, attachment,
                     detachment, maturity: float,
                     payment_interval: float = 0.25,
                     unit: Optional[float] = None):
        """(protection, rpv01) of a synthetic CDO tranche: protection
        pays the tranche-loss increments (discounted mid-bucket),
        premium accrues on the OUTSTANDING tranche notional (average of
        bucket endpoints — the standard discretization)."""
        n = int(round(maturity / payment_interval))
        if abs(n * payment_interval - maturity) > 1e-9 or n < 1:
            raise ValueError("maturity must be a whole number of "
                             "payment intervals")
        pay = np.arange(1, n + 1) * payment_interval
        grid = np.concatenate([[0.0], pay])
        etl = np.array([self.expected_tranche_loss(t, attachment,
                                                   detachment, unit=unit)
                        if t > 0 else 0.0 for t in grid])
        d_etl = np.diff(etl)
        df_pay = discount_curve.get_discount_factor(pay)
        df_mid = discount_curve.get_discount_factor(
            0.5 * (grid[:-1] + grid[1:]))
        protection = float(np.sum(df_mid * d_etl))
        width = detachment - attachment
        outstanding = width - 0.5 * (etl[:-1] + etl[1:])
        rpv01 = float(np.sum(payment_interval * df_pay * outstanding))
        return protection, rpv01

    def tranche_par_spread(self, discount_curve: DiscountCurve,
                           attachment, detachment, maturity: float,
                           payment_interval: float = 0.25,
                           unit: Optional[float] = None) -> float:
        p, a = self.tranche_legs(discount_curve, attachment, detachment,
                                 maturity, payment_interval, unit=unit)
        return p / a

    def kth_to_default_legs(self, discount_curve: DiscountCurve, k: int,
                            maturity: float,
                            payment_interval: float = 0.25):
        """(protection, rpv01) of a kth-to-default CDS on the basket:
        protection pays the basket's AVERAGE loss-given-default at the
        kth default (homogeneous-LGD convention; exact for homogeneous
        pools), premium accrues while fewer than k names have
        defaulted."""
        n = int(round(maturity / payment_interval))
        if abs(n * payment_interval - maturity) > 1e-9 or n < 1:
            raise ValueError("maturity must be a whole number of "
                             "payment intervals")
        pay = np.arange(1, n + 1) * payment_interval
        grid = np.concatenate([[0.0], pay])
        pk = np.array([self.kth_to_default_probability(t, k)
                       if t > 0 else 0.0 for t in grid])
        dpk = np.diff(pk)
        df_pay = discount_curve.get_discount_factor(pay)
        df_mid = discount_curve.get_discount_factor(
            0.5 * (grid[:-1] + grid[1:]))
        lgd = float(np.mean(self.losses))
        protection = lgd * float(np.sum(df_mid * dpk))
        surv = 1.0 - pk[1:]
        rpv01 = float(np.sum(payment_interval * df_pay * surv)
                      + np.sum(0.5 * payment_interval * df_pay * dpk))
        return protection, rpv01


# ---------------------------------------------------------------------------
# Vasicek large homogeneous pool (closed form)
# ---------------------------------------------------------------------------

def lhp_expected_tranche_loss(pd: float, beta: float, attachment: float,
                              detachment: float,
                              recovery: float = 0.4) -> float:
    """Vasicek large-pool E[min(max(L - A, 0), D - A)] per unit total
    notional: L(z) = (1-R) Phi((C - beta z)/sqrt(1-beta^2)), using
    E[(L-K)+] = (1-R) Phi2(z_K, C; beta) - K Phi(z_K) with z_K the
    factor level where L = K (the N -> infinity limit of the exact
    recursion — tested against it)."""
    if not 0.0 <= attachment < detachment:
        raise ValueError("need 0 <= attachment < detachment")
    if not 0.0 < beta < 1.0:
        raise ValueError("beta must be in (0, 1) for the LHP form")
    lgd = 1.0 - recovery
    c = float(inverse_normal_cdf_as241(
        np.clip(np.array([pd]), 1e-16, 1 - 1e-16))[0])
    s = math.sqrt(1.0 - beta * beta)

    def e_excess(k: float) -> float:
        if k <= 0.0:
            return lgd * pd - k
        if k >= lgd:
            return 0.0
        z_k = (c - s * float(inverse_normal_cdf_as241(
            np.array([k / lgd]))[0])) / beta
        return lgd * bivariate_normal_cdf(z_k, c, beta) \
            - k * _norm_cdf(z_k)

    return e_excess(attachment) - e_excess(detachment)


# ---------------------------------------------------------------------------
# device Monte Carlo
# ---------------------------------------------------------------------------

def _copula_scan_core(lat, thresholds, losses, attach: float,
                      detach: float, ks: Sequence[int],
                      mesh=None) -> torch.Tensor:
    """Per-horizon tranche losses and kth-to-default indicators from ONE
    latent matrix. lat [N, paths] float32; thresholds [H, N] float32;
    losses [N] float64; ks integer ranks. A loop over the horizons holds
    one [N, paths] indicator at a time. Returns packed [H, 2 + K]
    float64: (ETL mean, ETL stderr, P(count >= k_j)...). Under a ``mesh``
    ``lat`` is this rank's block of the paths and a horizon's means are
    one all-reduce."""
    n_paths = lat.shape[1] * (1 if mesh is None else mesh.world_size)
    rows = []
    for row in thresholds:
        ind = (lat <= row[:, None]).to(ACC_DTYPE)         # [N, paths]
        loss = losses @ ind                               # [paths]
        tr = torch.clamp(torch.clamp_min(loss - attach, 0.0),
                         max=detach - attach)
        count = torch.sum(ind, dim=0)
        # released before the next horizon's indicator is made (1 GB at
        # 125 names x 1M paths)
        del ind
        m, m2, *pk = path_means(
            [tr, tr * tr] + [(count >= kk).to(ACC_DTYPE) for kk in ks], mesh)
        se = torch.sqrt(torch.clamp_min(m2 - m * m, 0.0) / n_paths)
        rows.append(torch.stack([m, se, *pk]))
    return torch.stack(rows)


class GaussianCopulaSimulation:
    """Monte Carlo on the copula: one latent matrix [names, paths]
    (factor + idiosyncratic), shared across ALL horizons so default
    indicators are pathwise monotone in t. All horizon statistics come
    back packed in one host copy.

    The draws: ``normals=(z, eps)``, the JAX shapes ``[1, half]`` and
    ``[names, half]`` (``half = num_paths / 2`` when antithetic), mirrored
    ``[z, -z]`` along the path axis; or ``latent=``, the ``[names,
    num_paths]`` float32 matrix itself; otherwise both blocks from
    ``torch.Generator(device).manual_seed(seed)``. ``device`` defaults to
    ``select_device()``.

    ``mesh``: a ``parallel.PathMesh``. Every rank makes (or is given) the
    global latent matrix above, the unmeshed stream, mirrored before it is
    split, and keeps its ``[names, num_paths / W]`` block (``num_paths``
    divisible by the world size); the statistics' means are all-reduced,
    so every rank returns the unsharded statistics up to the order of the
    float64 sums. The global matrix is made on every rank before the
    split: 0.5 GB of float32 at 125 names x 1M paths."""

    def __init__(self, portfolio: GaussianCopulaPortfolio,
                 num_paths: int = 200_000, seed: int = 4242,
                 antithetic: bool = True,
                 mesh=None, path_axis: str = "paths", *, device=None,
                 normals=None, latent=None):
        if antithetic and num_paths % 2:
            raise ValueError("antithetic needs an even num_paths")
        self.mesh = check_mesh(mesh)
        self.path_axis = path_axis
        if self.mesh is not None:
            self.mesh.local_count(num_paths)
        self.portfolio = portfolio
        self.num_paths = int(num_paths)
        self.seed = int(seed)
        self.antithetic = bool(antithetic)
        self.device = mesh_device(self.mesh, device)
        dev = self.device
        n = portfolio.num_names
        if latent is not None:
            self._lat = path_block(injected_block(
                latent, (n, self.num_paths), dev, "latent"), self.mesh)
            return
        half = num_paths // 2 if antithetic else num_paths
        if normals is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            z = torch.randn((1, half), generator=gen, dtype=FLOAT_DTYPE,
                            device=dev)
            eps = torch.randn((n, half), generator=gen, dtype=FLOAT_DTYPE,
                              device=dev)
        else:
            z = injected_block(normals[0], (1, half), dev, "normals z")
            eps = injected_block(normals[1], (n, half), dev, "normals eps")
        if antithetic:
            z = torch.cat([z, -z], dim=1)
            eps = torch.cat([eps, -eps], dim=1)
        b = torch.as_tensor(portfolio.betas, dtype=FLOAT_DTYPE).to(dev)[:, None]
        self._lat = path_block(b * z + torch.sqrt(1.0 - b * b) * eps,
                               self.mesh)

    def tranche_statistics(self, times, attachment: float,
                           detachment: float, ks: Sequence[int] = ()):
        """dict with 'etl' [H], 'etl_stderr' [H] and
        'kth_prob' [H, len(ks)] = P(#defaults by t >= k) for the
        requested ranks, from one packed host copy."""
        if not 0.0 <= attachment < detachment:
            raise ValueError("need 0 <= attachment < detachment")
        t = np.atleast_1d(np.asarray(times, dtype=np.float64))
        thresholds = self.portfolio.default_thresholds(t).T  # [H, N]
        dev = self.device
        out = _copula_scan_core(
            self._lat, torch.as_tensor(thresholds, dtype=FLOAT_DTYPE).to(dev),
            torch.as_tensor(self.portfolio.losses, dtype=ACC_DTYPE).to(dev),
            float(attachment), float(detachment),
            tuple(int(k) for k in ks), self.mesh).cpu().numpy()
        return {"etl": out[:, 0], "etl_stderr": out[:, 1],
                "kth_prob": out[:, 2:]}
