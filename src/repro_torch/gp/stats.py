"""Kernel-dispatched sufficient statistics for the collapsed bound.

Counterpart of `repro.gp.stats`: one entry point, `suff_stats(kernel,
params, batch, backend=..., chunk=...)`. The batch type selects exact
(deterministic X) vs expected (Gaussian q(X)) statistics, the kernel
supplies the math, and `backend` routes the hot path through the fused op
("fused"), the single-statistic ops ("pallas": K_fu for the exact
statistics, psi1 and psi2 for the expected ones) or plain PyTorch ("jnp").

`chunk=` streams the N datapoints in chunks of that size and combines the
per-chunk `SuffStats` through the monoid: a Python loop over the full
chunks, then one explicit tail chunk (no padding), so peak live memory is
O(chunk * M + M^2) regardless of N. Each chunk of the plain and "pallas"
backends is checkpointed, as the reference's scan is (a "pallas" chunk's
psi1^T Y or K_fu^T K_fu and K_fu^T Y products keep their (chunk, M)
operand for the backward pass), so a
backward pass through the loop also stays at O(chunk * M + M^2) beyond the
per-point inputs; the fused op saves only its inputs already and is not.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core.psi_stats import SuffStats, checkpointed
from repro_torch.gp.kernels import Kernel, Params


class ExactBatch(NamedTuple):
    """Supervised sparse-GP data: deterministic inputs X."""

    X: torch.Tensor  # (N, Q)
    Y: torch.Tensor  # (N, D)
    Z: torch.Tensor  # (M, Q)


class ExpectedBatch(NamedTuple):
    """Bayesian GP-LVM data: Gaussian q(X) = prod_n N(mu_n, diag(S_n))."""

    mu: torch.Tensor  # (N, Q)
    S: torch.Tensor  # (N, Q)
    Y: torch.Tensor  # (N, D)
    Z: torch.Tensor  # (M, Q)


Batch = Union[ExactBatch, ExpectedBatch]


def _dispatch(kernel: Kernel, params: Params, batch: Batch, backend: str,
              bwd_backend: str = "auto") -> SuffStats:
    if isinstance(batch, ExactBatch):
        return kernel.exact_suff_stats(params, batch.X, batch.Y, batch.Z,
                                       backend=backend, bwd_backend=bwd_backend)
    if isinstance(batch, ExpectedBatch):
        return kernel.expected_suff_stats(params, batch.mu, batch.S, batch.Y,
                                          batch.Z, backend=backend,
                                          bwd_backend=bwd_backend)
    raise TypeError(f"expected ExactBatch or ExpectedBatch, got {type(batch).__name__}")


def streaming_suff_stats(kernel: Kernel, params: Params, batch: Batch, *,
                         backend: str = "jnp", chunk: Union[int, str] = 4096,
                         bwd_backend: str = "auto") -> SuffStats:
    """`suff_stats` as a loop over N in chunks: O(chunk * M + M^2) live,
    each chunk of the plain and "pallas" backends checkpointed. A
    non-dividing N ends in an explicit tail chunk."""
    if not isinstance(batch, (ExactBatch, ExpectedBatch)):
        raise TypeError(f"expected ExactBatch or ExpectedBatch, got {type(batch).__name__}")
    if isinstance(chunk, str):
        if chunk == "auto":
            raise NotImplementedError(
                'chunk="auto" needs the autotuner (repro.tune), which comes '
                'with a later slice of the port; pass a positive int')
        raise ValueError(f'chunk must be a positive int or "auto", got {chunk!r}')
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    per_point = [a for name, a in zip(batch._fields, batch) if name != "Z"]
    N = per_point[0].shape[0]
    rebuild = type(batch)

    def chunk_stats(Z, *chunk_arrays) -> SuffStats:
        return _dispatch(kernel, params, rebuild(*chunk_arrays, Z), backend,
                         bwd_backend)

    def one(lo: int, hi: int) -> SuffStats:
        args = (batch.Z, *(a[lo:hi] for a in per_point))
        if backend == "fused":
            # the fused op saves only its O(chunk * (Q + D)) inputs: a
            # checkpoint would save nothing and run its forward twice
            return chunk_stats(*args)
        return checkpointed(chunk_stats, *args)

    n_full, rem = divmod(N, chunk)
    stats: Optional[SuffStats] = None
    for i in range(n_full):
        s = one(i * chunk, (i + 1) * chunk)
        stats = s if stats is None else SuffStats.combine(stats, s)
    if rem:
        tail = one(n_full * chunk, N)
        stats = tail if stats is None else SuffStats.combine(stats, tail)
    if stats is None:  # N == 0: the one-shot path's zero statistics
        return one(0, 0)
    return stats


def suff_stats(kernel: Kernel, params: Params, batch: Batch, *,
               backend: str = "jnp", chunk: Optional[Union[int, str]] = None,
               bwd_backend: str = "auto") -> SuffStats:
    """Sufficient statistics of `batch` under `kernel`, kernel-dispatched.

    `chunk=None` evaluates in one shot; an integer streams the datapoints
    in chunks of that size. The "fused" backend ignores `chunk`: its op
    already streams over N inside the kernel.
    """
    if chunk is not None and backend != "fused":
        return streaming_suff_stats(kernel, params, batch, backend=backend,
                                    chunk=chunk, bwd_backend=bwd_backend)
    return _dispatch(kernel, params, batch, backend, bwd_backend)
