"""Plain PyTorch oracles for the psi-statistic kernels (paper §3, Tables 1-2).

Counterpart of `repro.kernels.ref`, formula for formula:

  - ``kfu``  : cross covariance K_fu (N x M)        [sparse GP, deterministic X]
  - ``psi0`` : sum_n <k(x_n, x_n)>_{q(x_n)}          (scalar)
  - ``psi1`` : Psi1[n,m] = <k(x_n, z_m)>_{q(x_n)}    (N x M)
  - ``psi2`` : Psi2 = sum_n <k_fu(x_n)^T k_fu(x_n)>  (M x M)

Closed forms for the RBF-ARD kernel under diagonal Gaussian
q(x_n) = N(mu_n, diag(S_n)) follow Titsias & Lawrence (2010). The fused
statistics kernel (`repro_torch.kernels.suffstats`) is tested against these.
"""
from __future__ import annotations

import torch


def kfu_rbf(X: torch.Tensor, Z: torch.Tensor, variance: torch.Tensor,
            lengthscale: torch.Tensor) -> torch.Tensor:
    """K_fu[n, m] = sigma^2 exp(-0.5 sum_q (x_nq - z_mq)^2 / l_q^2)."""
    Xs = X / lengthscale
    Zs = Z / lengthscale
    d2 = ((Xs**2).sum(-1)[:, None] + (Zs**2).sum(-1)[None, :]
          - 2.0 * Xs @ Zs.T)
    return variance * torch.exp(-0.5 * d2.clamp_min(0.0))


def psi0_rbf(mu: torch.Tensor, S: torch.Tensor, variance: torch.Tensor,
             lengthscale: torch.Tensor) -> torch.Tensor:
    """psi0 = sum_n <k(x_n,x_n)> = N * sigma^2 for the RBF kernel."""
    del S, lengthscale
    return mu.shape[0] * variance


def psi1_rbf(mu: torch.Tensor, S: torch.Tensor, Z: torch.Tensor,
             variance: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Psi1[n,m] = sigma^2 prod_q (1+S_nq/l_q^2)^(-1/2)
    exp(-0.5 (mu_nq - z_mq)^2 / (l_q^2 + S_nq))."""
    l2 = lengthscale**2
    denom = l2[None, :] + S
    lognorm = -0.5 * torch.log1p(S / l2[None, :]).sum(-1)
    diff = mu[:, None, :] - Z[None, :, :]
    expo = -0.5 * (diff**2 / denom[:, None, :]).sum(-1)
    return variance * torch.exp(lognorm[:, None] + expo)


def psi2_n_rbf(mu: torch.Tensor, S: torch.Tensor, Z: torch.Tensor,
               variance: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Per-datapoint psi2: (N, M, M) tensor before the sum over n.

    psi2[n,m,m'] = sigma^4 prod_q (1 + 2 S_nq/l_q^2)^(-1/2)
        * exp(-(z_mq - z_m'q)^2 / (4 l_q^2) - (mu_nq - zbar_q)^2 / (l_q^2 + 2 S_nq))
    with zbar = (z_m + z_m') / 2.
    """
    l2 = lengthscale**2
    denom = l2[None, :] + 2.0 * S
    lognorm = -0.5 * torch.log1p(2.0 * S / l2[None, :]).sum(-1)
    zdiff = Z[:, None, :] - Z[None, :, :]
    zterm = -(zdiff**2 / (4.0 * l2[None, None, :])).sum(-1)
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    mudiff = mu[:, None, None, :] - zbar[None, :, :, :]
    muterm = -(mudiff**2 / denom[:, None, None, :]).sum(-1)
    return variance**2 * torch.exp(lognorm[:, None, None] + zterm[None, :, :]
                                   + muterm)


def psi2_rbf(mu: torch.Tensor, S: torch.Tensor, Z: torch.Tensor,
             variance: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    """Psi2 = sum_n psi2^{(n)} (M x M): the textbook (N, M, M, Q) broadcast,
    kept as an implementation independent of the streaming ones."""
    return psi2_n_rbf(mu, S, Z, variance, lengthscale).sum(0)
