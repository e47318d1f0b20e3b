"""Cached posterior state for online serving.

Counterpart of `repro.serve.state`. The posterior epilogue is a pure
function of the O(M^2) `SuffStats` summary, so a fitted model is fully
described by

    PosteriorState = (kernel hyperparams, Z, log_beta,
                      SuffStats,                      # the raw monoid
                      L, LA, Kuu_inv_mean)            # factorized epilogue

and each request costs O(M B + M^2 B): one cross-covariance block and two
triangular solves, no Cholesky. The raw statistics ride along so the state
can absorb or shed data (`repro_torch.serve.online`) in O(M^3).

The kernel object is not a field: functions here take it beside the state.
A temporal model's state is `repro_torch.temporal.TemporalState`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import svgp
from repro_torch.core.psi_stats import SuffStats
from repro_torch.gp.kernels import Kernel
from repro_torch.temporal.model import TemporalState, _tree_nbytes, forecast
from repro_torch.tracing import span

Params = Dict[str, torch.Tensor]


class PosteriorState(NamedTuple):
    """Everything a fitted collapsed-bound GP needs to serve and to learn
    online: tensors on one device."""

    kern: Params  # kernel hyperparameters (log-transformed)
    Z: torch.Tensor  # (M, Q) inducing inputs
    log_beta: torch.Tensor  # scalar log noise precision
    stats: SuffStats  # the raw sufficient-statistics monoid
    L: torch.Tensor  # (M, M) chol(Kuu + jitter)
    LA: torch.Tensor  # (M, M) chol(Kuu + beta Psi2 + jitter)
    Kuu_inv_mean: torch.Tensor  # (M, D) woodbury vector Kuu^-1 mean_u

    @property
    def M(self) -> int:
        return self.Z.shape[0]

    @property
    def D(self) -> int:
        return self.Kuu_inv_mean.shape[1]

    @property
    def nbytes(self) -> int:
        """Resident bytes of every tensor in the state (the kernel's params
        nested as a composite's are); constant for a registration (every
        shape is fixed by (M, Q, D))."""
        return _tree_nbytes(tuple(self))


def build_state(kernel: Kernel, params: Params, stats: SuffStats, *,
                jitter: float = svgp.DEFAULT_JITTER) -> PosteriorState:
    """The O(M^3) refold: statistics -> factorized posterior state, on the
    device the tensors live on. `params` needs "kern", "Z", "log_beta";
    extra keys (the GP-LVM's q(X)) are ignored."""
    kern_p, Z, log_beta = params["kern"], params["Z"], params["log_beta"]
    with span("repro_torch.epilogue"):
        beta = torch.exp(log_beta)
        factors = svgp.posterior_factors(kernel.K(kern_p, Z), stats, beta,
                                         jitter=jitter)
        post = svgp.optimal_qu(factors, beta)
    return PosteriorState(kern=kern_p, Z=Z, log_beta=log_beta, stats=stats,
                          L=post.L, LA=post.LA, Kuu_inv_mean=post.Kuu_inv_mean)


def _as_posterior(state: PosteriorState) -> svgp.Posterior:
    """The state through the svgp.Posterior lens prediction expects
    (mean_u / cov_u are not read by predict_f)."""
    return svgp.Posterior(mean_u=state.Kuu_inv_mean, cov_u=state.LA,
                          Kuu_inv_mean=state.Kuu_inv_mean, L=state.L,
                          LA=state.LA)


def _predict_closure(kernel: Kernel, diag: bool):
    """The predict epilogue closed over a kernel (eager PyTorch)."""

    def fn(state: PosteriorState, Xt: torch.Tensor):
        Ksu = kernel.K(state.kern, Xt, state.Z)
        post = _as_posterior(state)
        if diag:
            return svgp.predict_f(post, Ksu, kernel.Kdiag(state.kern, Xt))
        return svgp.predict_f_full(post, Ksu, kernel.K(state.kern, Xt))

    return fn


def predict(kernel: Kernel, state, Xt: torch.Tensor, *,
            diag: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior p(f*) at Xt from the cached state: mean (B, D) plus the
    marginal variance (B,) (`diag=True`) or the full (B, B) covariance.
    A `repro_torch.temporal.TemporalState` gives O(B d^3) marginal
    forecasts from its terminal filtered state (diag only)."""
    if isinstance(state, TemporalState):
        if not diag:
            raise ValueError(
                "diag=False (full predictive covariance) is not available "
                "for a TemporalState: the served forecast state carries "
                "per-timestamp marginals only; use "
                "TemporalGPRegression.predict on the fitted model for "
                "smoothed joint structure")
        return forecast(kernel, state, Xt)
    if not isinstance(state, PosteriorState):
        raise TypeError(
            f"predict takes a PosteriorState or a TemporalState, got "
            f"{type(state).__name__}")
    return _predict_closure(kernel, bool(diag))(state, Xt)
