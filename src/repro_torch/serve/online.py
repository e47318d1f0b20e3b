"""Online learning on a served posterior: fold data in, fold data out,
without revisiting the training set.

Counterpart of `repro.serve.online`. Every statistic in `SuffStats` is a
plain sum over datapoints, so

    update:    stats' = stats + suff_stats(new chunk)      (monoid combine)
    downdate:  stats' = stats - suff_stats(old chunk)      (monoid inverse)

followed by the O(M^3) refold (`serve.state.build_state`). The incremental
statistics ride the same engine as everything else — with
backend="fused" on the card, the CUDA statistics kernel.

`update` only adds PSD mass and needs no guard. `downdate` subtracts, so
floating cancellation can leave the downdated Psi2 indefinite: it refolds
behind a condition-number guard with escalating jitter before giving up.
`refit` re-optimizes log_beta by Adam against the cached statistics.

A `repro_torch.temporal.TemporalState` goes through `update` to the
Kalman path (`temporal.update_state`: the sequential filter forward from
the stored terminal state); `downdate` and `refit` refuse it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import inference, svgp
from repro_torch.core.psi_stats import SuffStats
from repro_torch.gp.kernels import Kernel
from repro_torch.gp.stats import Batch, ExactBatch, suff_stats
from repro_torch.serve.state import PosteriorState, build_state
from repro_torch.temporal.model import TemporalState, update_state

# downdate guard: refold with jitter * 10^k, k = 0..ESCALATIONS, then raise
ESCALATIONS = 4
# LA diag-ratio^2 above this (~1/sqrt(eps) in f64) counts as ill-conditioned
MAX_CONDITION = 1e8


def _as_2d(Y: torch.Tensor) -> torch.Tensor:
    return Y[:, None] if Y.ndim == 1 else Y


def batch_stats(kernel: Kernel, state: PosteriorState, batch: Batch, *,
                backend: str = "jnp", chunk: Union[int, str, None] = None,
                bwd_backend: str = "auto") -> SuffStats:
    """Statistics of an incremental batch under the state's
    hyperparameters, through the standard engine (gp.stats.suff_stats)."""
    return suff_stats(kernel, state.kern, batch, backend=backend,
                      chunk=chunk, bwd_backend=bwd_backend)


def _params(state: PosteriorState) -> dict:
    return {"kern": state.kern, "Z": state.Z, "log_beta": state.log_beta}


def update(kernel: Kernel, state: PosteriorState, X_new: torch.Tensor,
           Y_new: torch.Tensor, *, backend: str = "jnp",
           chunk: Union[int, str, None] = None, bwd_backend: str = "auto",
           jitter: float = svgp.DEFAULT_JITTER) -> PosteriorState:
    """Absorb new observations: O(B M^2) statistics + O(M^3) refold. Equal
    (to roundoff) to rebuilding the statistics from scratch on the
    concatenated data at the same hyperparameters.

    A `TemporalState` filters forward from its terminal (m, P) instead:
    X_new must be sorted timestamps after the state's forecast origin, and
    the statistics knobs (backend/chunk/bwd_backend/jitter) are ignored."""
    if isinstance(state, TemporalState):
        return update_state(kernel, state, X_new, Y_new)
    batch = ExactBatch(X_new, _as_2d(Y_new), state.Z)
    new = batch_stats(kernel, state, batch, backend=backend, chunk=chunk,
                      bwd_backend=bwd_backend)
    return build_state(kernel, _params(state),
                       SuffStats.combine(state.stats, new), jitter=jitter)


def _condition_estimate(LA: torch.Tensor) -> float:
    """cond(LA LA^T) estimated from the Cholesky diagonal — O(M), enough to
    flag a downdate that cancelled most of the PSD mass."""
    d = LA.diagonal().abs()
    lo = float(d.min())
    if lo == 0.0 or not bool(torch.isfinite(d).all()):
        return math.inf
    return (float(d.max()) / lo) ** 2


def refold(kernel: Kernel, state: PosteriorState, stats: SuffStats, *,
           jitter: float = svgp.DEFAULT_JITTER) -> PosteriorState:
    """Refactorize `state` around replacement statistics, behind the
    condition guard: if the Cholesky comes back NaN/Inf or with condition
    estimate above MAX_CONDITION, refold again with 10x the jitter (up to
    ESCALATIONS decades) before raising. Reads device values, so it
    synchronizes; the O(M^3) refold is not the per-request path."""
    for k in range(ESCALATIONS + 1):
        candidate = build_state(kernel, _params(state), stats,
                                jitter=jitter * 10.0**k)
        LA = candidate.LA
        if bool(torch.isfinite(LA).all()) and \
                _condition_estimate(LA) <= MAX_CONDITION:
            return candidate
    raise FloatingPointError(
        f"refold: downdated statistics are numerically indefinite even at "
        f"jitter={jitter * 10.0**ESCALATIONS:g} — the removed chunk carried "
        f"too much of the posterior's mass; rebuild the statistics from the "
        f"surviving data instead")


def downdate(kernel: Kernel, state: PosteriorState, X_old: torch.Tensor,
             Y_old: torch.Tensor, *, backend: str = "jnp",
             chunk: Union[int, str, None] = None,
             jitter: float = svgp.DEFAULT_JITTER) -> PosteriorState:
    """Remove previously absorbed observations by subtracting their exact
    statistics, then refold behind the condition guard."""
    if isinstance(state, TemporalState):
        raise TypeError(
            "downdate is a statistics-monoid operation; a TemporalState is "
            "a filtered terminal state with no per-chunk inverse (the "
            "Kalman recursion only runs forward) — re-fit "
            "TemporalGPRegression on the surviving data instead")
    batch = ExactBatch(X_old, _as_2d(Y_old), state.Z)
    old = batch_stats(kernel, state, batch, backend=backend, chunk=chunk)
    return refold(kernel, state, SuffStats.subtract(state.stats, old),
                  jitter=jitter)


def refit(kernel: Kernel, state: PosteriorState, *, steps: int = 50,
          lr: float = 5e-2,
          jitter: float = svgp.DEFAULT_JITTER) -> Tuple[PosteriorState, list]:
    """Warm-started noise touch-up from the cached statistics alone.

    The collapsed bound is an exact function of (stats, beta): the
    statistics depend on (theta, Z) but not on beta, so log_beta is the one
    hyperparameter that can be re-optimized without the datapoints. Runs
    `steps` Adam steps on the bound, warm-started at the served value, and
    refolds. Returns (new_state, loss_history); the history leads with the
    loss at the served value."""
    if isinstance(state, TemporalState):
        raise TypeError(
            "refit re-optimizes log_beta against cached SuffStats; a "
            "TemporalState caches no statistics (its likelihood needs the "
            "whole timeline) — re-fit TemporalGPRegression instead")
    with torch.no_grad():
        Kuu = kernel.K(state.kern, state.Z)
    D = state.D
    stats = state.stats

    def loss(params: dict) -> torch.Tensor:
        terms = svgp.collapsed_bound(Kuu, stats, torch.exp(params["log_beta"]),
                                     D, jitter=jitter)
        return -terms.bound / stats.n

    with torch.no_grad():
        start = float(loss({"log_beta": state.log_beta}))
    params, history = inference.fit_adam(loss, {"log_beta": state.log_beta},
                                         (), steps=steps, lr=lr)
    new = {"kern": state.kern, "Z": state.Z, "log_beta": params["log_beta"]}
    with torch.no_grad():
        return build_state(kernel, new, stats, jitter=jitter), [start, *history]
