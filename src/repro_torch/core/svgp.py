"""Collapsed variational bound for sparse GPs (paper eq. (2)-(3)).

Counterpart of `repro.core.svgp`, down to its numerical choices: direct
Cholesky of (Kuu + beta Psi2) rather than the whitened GPy form, a jitter
relative to mean(diag Kuu) that is 100x larger in float32, and an
eps-scaled floor on LA.

    L   = chol(Kuu + jitter I)
    LA  = chol(Kuu + beta Psi2 + jitter I)
    c   = LA^-1 PsiY                             (M, D)

    F = D N/2 log(beta / 2 pi) - D/2 (log|LA LA^T| - log|L L^T|)
        - beta/2 yy + beta^2/2 ||c||_F^2
        - beta D/2 psi0 + beta D/2 tr(L^-1 Psi2 L^-T)

A Cholesky that fails returns NaN, as `jnp.linalg.cholesky` does, so the
serving layer's condition guard sees the same signal.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.psi_stats import SuffStats

DEFAULT_JITTER = 1e-6


class BoundTerms(NamedTuple):
    bound: torch.Tensor
    logdet_term: torch.Tensor
    quad_term: torch.Tensor
    trace_term: torch.Tensor
    L: torch.Tensor  # chol(Kuu + jitter)
    LA: torch.Tensor  # chol(Kuu + beta Psi2 + jitter)
    c: torch.Tensor  # LA^-1 PsiY


class PosteriorFactors(NamedTuple):
    """The O(M^3) factorization epilogue on its own: what prediction and
    the serving layer's `PosteriorState` need, without the bound value."""

    L: torch.Tensor
    LA: torch.Tensor
    c: torch.Tensor


def _jitter_eff(Kuu: torch.Tensor, jitter: float) -> torch.Tensor:
    """Relative, dtype-aware jitter: f32 needs ~100x f64's."""
    scale = Kuu.diagonal().mean()
    boost = 1.0 if Kuu.dtype == torch.float64 else 100.0
    return jitter * boost * scale.clamp_min(1e-12)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN-filled where the factorization fails
    (no host synchronization)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, math.nan))


def _solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def posterior_factors(Kuu: torch.Tensor, stats: SuffStats, beta: torch.Tensor,
                      *, jitter: float = DEFAULT_JITTER) -> PosteriorFactors:
    """L = chol(Kuu + jit I), LA = chol(Kuu + beta Psi2 + jit I),
    c = LA^-1 PsiY from sufficient statistics alone: O(M^3 + M^2 D)."""
    M = Kuu.shape[0]
    eye = torch.eye(M, dtype=Kuu.dtype, device=Kuu.device)
    # one consistent jittered model for every consumer below
    Kuu_j = Kuu + _jitter_eff(Kuu, jitter) * eye
    L = _cholesky(Kuu_j)
    psi2 = 0.5 * (stats.psi2 + stats.psi2.T)
    Abig = Kuu_j + beta * psi2
    # eps-scaled floor for Psi2's own roundoff (~eps * ||Psi2||)
    eps = torch.finfo(Kuu.dtype).eps
    LA = _cholesky(Abig + 100.0 * eps * Abig.diagonal().mean() * eye)
    c = _solve_lower(LA, stats.psiY)
    return PosteriorFactors(L, LA, c)


def collapsed_bound(Kuu: torch.Tensor, stats: SuffStats, beta: torch.Tensor,
                    D: int, *, jitter: float = DEFAULT_JITTER) -> BoundTerms:
    """The paper's eq. (3), evaluated from sufficient statistics."""
    N = stats.n
    L, LA, c = posterior_factors(Kuu, stats, beta, jitter=jitter)
    psi2 = 0.5 * (stats.psi2 + stats.psi2.T)
    logdetB = 2.0 * (torch.log(LA.diagonal()).sum()
                     - torch.log(L.diagonal()).sum())
    tmp = _solve_lower(L, psi2)
    A = _solve_lower(L, tmp.T).T
    logdet_term = 0.5 * D * N * torch.log(beta / (2.0 * math.pi)) - 0.5 * D * logdetB
    quad_term = -0.5 * beta * stats.yy + 0.5 * beta**2 * (c * c).sum()
    trace_term = -0.5 * beta * D * stats.psi0 + 0.5 * beta * D * torch.trace(A)
    bound = logdet_term + quad_term + trace_term
    return BoundTerms(bound, logdet_term, quad_term, trace_term, L, LA, c)


class Posterior(NamedTuple):
    """Optimal q(u) = N(mean_u, cov_u) implied by the collapsed bound."""

    mean_u: torch.Tensor  # (M, D)
    cov_u: torch.Tensor  # (M, M)
    Kuu_inv_mean: torch.Tensor  # (M, D)  Kuu^-1 mean_u, cached for prediction
    L: torch.Tensor
    LA: torch.Tensor


def optimal_qu(terms: "BoundTerms | PosteriorFactors",
               beta: torch.Tensor) -> Posterior:
    """q(u): mean = beta Kuu (Kuu + beta Psi2)^-1 PsiY,
    cov = Kuu (Kuu + beta Psi2)^-1 Kuu — in Cholesky factors."""
    L, LA, c = terms.L, terms.LA, terms.c
    # Kuu^-1 mean_u = beta (Kuu + beta Psi2)^-1 PsiY = beta LA^-T c
    Kuu_inv_mean = beta * torch.linalg.solve_triangular(LA.T, c, upper=True)
    Kuu = L @ L.T
    mean_u = Kuu @ Kuu_inv_mean
    LAiK = _solve_lower(LA, Kuu)
    cov_u = LAiK.T @ LAiK
    return Posterior(mean_u, cov_u, Kuu_inv_mean, L, LA)


def predict_f(post: Posterior, Ksu: torch.Tensor,
              Kss_diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior p(f*) at test points: mean (N*, D) and marginal var (N*,).

    mean = Ksu Kuu^-1 mean_u
    var  = Kss_diag - diag(Ksu [Kuu^-1 - (Kuu + beta Psi2)^-1] Kus)
    """
    mean = Ksu @ post.Kuu_inv_mean
    v1 = _solve_lower(post.L, Ksu.T)
    v2 = _solve_lower(post.LA, Ksu.T)
    var = Kss_diag - (v1 * v1).sum(0) + (v2 * v2).sum(0)
    return mean, var


def predict_f_full(post: Posterior, Ksu: torch.Tensor,
                   Kss: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior p(f*) with the full (N*, N*) covariance:
    cov = Kss - Ksu [Kuu^-1 - (Kuu + beta Psi2)^-1] Kus."""
    mean = Ksu @ post.Kuu_inv_mean
    v1 = _solve_lower(post.L, Ksu.T)
    v2 = _solve_lower(post.LA, Ksu.T)
    return mean, Kss - v1.T @ v1 + v2.T @ v2
