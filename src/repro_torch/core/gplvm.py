"""Bayesian GP-LVM (paper eq. (4)) — the unsupervised model the paper's
experiments use (counterpart of `repro.core.gplvm`).

X is latent with prior p(x_n) = N(0, I_Q) and factorized Gaussian
variational posterior q(x_n) = N(mu_n, diag(S_n)). The collapsed bound of
`svgp` is reused verbatim; the sufficient statistics become expectations
under q(X) and the KL term is subtracted:

    log p(Y) >= <F>_q(X) - sum_n KL(q(x_n) || p(x_n))

Every entry point takes an optional `kernel` (default: the paper's RBF).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.core import psi_stats, svgp
from repro_torch.gp.kernels import Kernel, default_rbf
from repro_torch.gp.stats import ExpectedBatch, suff_stats
from repro_torch.tracing import span

Params = Dict[str, torch.Tensor]


def init_params(
    generator: torch.Generator,
    Y: torch.Tensor,
    Q: int,
    M: int,
    *,
    init_X: torch.Tensor | None = None,
    kernel: Optional[Kernel] = None,
) -> Params:
    """PCA-style init of the q(X) means (or user-provided), Z as M rows of
    them, on Y's device. `generator` (a CPU `torch.Generator`) picks the
    rows; it draws other numbers than the reference's `jax.random.choice`,
    and the SVD's column signs may differ from JAX's."""
    N = Y.shape[0]
    if init_X is None:
        # PCA init: project Y onto its top-Q principal directions
        Yc = Y - Y.mean(0)
        _, _, Vt = torch.linalg.svd(Yc, full_matrices=False)
        init_X = Yc @ Vt[:Q].T
        init_X = init_X / (init_X.std(0, correction=0) + 1e-6)
    kern = default_rbf(kernel, Q).init(device=Y.device)
    if N < M:
        idx = torch.randint(N, (M,), generator=generator)
    else:
        idx = torch.randperm(N, generator=generator)[:M]
    return {
        "kern": kern,
        "Z": init_X[idx.to(init_X.device)],
        "log_beta": torch.tensor(math.log(100.0), dtype=torch.float32,
                                 device=Y.device),
        "q_mu": init_X,
        "q_logS": torch.full((N, Q), math.log(0.1), dtype=torch.float32,
                             device=Y.device),
    }


def kl_qp(q_mu: torch.Tensor, q_logS: torch.Tensor) -> torch.Tensor:
    """sum_n KL(N(mu_n, diag(S_n)) || N(0, I)) — also a plain sum over n."""
    S = torch.exp(q_logS)
    return 0.5 * (S + q_mu**2 - q_logS - 1.0).sum()


def local_stats(params: Params, Y_local: torch.Tensor, *,
                kernel: Optional[Kernel] = None,
                backend: str = "jnp",
                chunk: Union[int, str, None] = None,
                bwd_backend: str = "auto") -> psi_stats.SuffStats:
    """Sufficient statistics of the local data, kernel-dispatched. `chunk=`
    streams the datapoints (O(chunk * M) live memory); `backend` is "jnp",
    "fused" or "pallas" (the psi1 and psi2 ops); `bwd_backend` picks the
    ops' reverse passes."""
    kern = default_rbf(kernel, params["q_mu"].shape[1])
    with span("repro_torch.stats"):
        S = torch.exp(params["q_logS"])
        return suff_stats(kern, params["kern"],
                          ExpectedBatch(params["q_mu"], S, Y_local, params["Z"]),
                          backend=backend, chunk=chunk, bwd_backend=bwd_backend)


def bound(params: Params, Y: torch.Tensor, *, kernel: Optional[Kernel] = None,
          backend: str = "jnp", chunk: Union[int, str, None] = None,
          bwd_backend: str = "auto") -> torch.Tensor:
    """Single-device GP-LVM evidence lower bound."""
    stats = local_stats(params, Y, kernel=kernel, backend=backend, chunk=chunk,
                        bwd_backend=bwd_backend)
    return bound_from_stats(params, stats, kl_qp(params["q_mu"], params["q_logS"]),
                            Y.shape[1], kernel=kernel)


def bound_from_stats(
    params: Params, stats: psi_stats.SuffStats, kl: torch.Tensor, D: int,
    *, kernel: Optional[Kernel] = None,
) -> torch.Tensor:
    """The O(M^3) epilogue of the bound, from the statistics."""
    kern = default_rbf(kernel, params["Z"].shape[1])
    with span("repro_torch.epilogue"):
        Kuu = kern.K(params["kern"], params["Z"])
        beta = torch.exp(params["log_beta"])
        terms = svgp.collapsed_bound(Kuu, stats, beta, D)
    return terms.bound - kl


def loss(params: Params, Y: torch.Tensor, *, kernel: Optional[Kernel] = None,
         backend: str = "jnp", chunk: Union[int, str, None] = None,
         bwd_backend: str = "auto") -> torch.Tensor:
    """Negative ELBO per datapoint (scale-stable objective for Adam)."""
    return -bound(params, Y, kernel=kernel, backend=backend, chunk=chunk,
                  bwd_backend=bwd_backend) / Y.shape[0]
