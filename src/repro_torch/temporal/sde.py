"""Kernel -> LTI SDE conversion for the state-space (temporal) GP backend.

Counterpart of `repro.temporal.sde`. A stationary 1-D GP prior
f(t) ~ GP(0, k(t - t')) with a rational spectral density is exactly the
stationary distribution of a linear time-invariant SDE

    dx(t) = F x(t) dt + L dW(t),     f(t) = H x(t),

with state dimension d (1 for Matern-1/2, 2 for 3/2, 3 for 5/2). The
stationary covariance P_inf solves F P_inf + P_inf F^T + L q L^T = 0, and
k(tau) = H expm(F tau) P_inf H^T for tau >= 0. Between observation times
the SDE discretizes exactly:

    A_k = expm(F dt_k),     Q_k = P_inf - A_k P_inf A_k^T

(the stationary shortcut for Q_k lets Sum/Product compositions discretize
without a closed-form noise integral). Compositions mirror
`repro_torch.gp.kernels.Sum` / `Product`:

    sum:     F, Qc, P_inf block-diagonal; H concatenated      (f = f1 + f2)
    product: F = F1 (+) F2 (Kronecker sum), H = H1 (x) H2,
             P_inf = P1 (x) P2, Qc = Qc1 (x) P2 + P1 (x) Qc2

The module holds plain tensor constructors and no kernel classes, so
`repro_torch.gp.kernels` can import it lazily from its `to_sde()` hooks.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class LTISDE(NamedTuple):
    """The LTI SDE behind a stationary kernel (see the module docstring).

    `L` is the (d, w) noise loading of leaf and sum models; Kronecker
    products mix the white-noise channels, so `product` models carry
    `L=None` and only the diffusion matrix `Qc = L q L^T`, which is all the
    discretization needs.
    """

    F: torch.Tensor  # (d, d) drift
    H: torch.Tensor  # (d,)   observation row: f(t) = H x(t)
    Pinf: torch.Tensor  # (d, d) stationary covariance
    Qc: torch.Tensor  # (d, d) diffusion L q L^T
    L: Optional[torch.Tensor] = None  # (d, w) noise loading, when meaningful

    @property
    def d(self) -> int:
        return self.F.shape[-1]


def _scalar(x: torch.Tensor) -> torch.Tensor:
    """ARD-shaped (1,) lengthscales and scalars both become 0-d."""
    return torch.as_tensor(x).reshape(())


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(list(r)) for r in rows])


def matern12_sde(variance: torch.Tensor, lengthscale: torch.Tensor) -> LTISDE:
    """Matern nu=1/2 (Ornstein-Uhlenbeck): lam = 1/l, q = 2 sigma^2 lam."""
    var, lam = _scalar(variance), 1.0 / _scalar(lengthscale)
    one = torch.ones_like(var)
    q = 2.0 * var * lam
    return LTISDE(F=(-lam * one)[None, None], H=one[None], Pinf=var[None, None],
                  Qc=q[None, None], L=one[None, None])


def matern32_sde(variance: torch.Tensor, lengthscale: torch.Tensor) -> LTISDE:
    """Matern nu=3/2: lam = sqrt(3)/l, q = 4 sigma^2 lam^3."""
    var, ls = _scalar(variance), _scalar(lengthscale)
    lam = math.sqrt(3.0) / ls
    zero, one = torch.zeros_like(var), torch.ones_like(var)
    F = _mat([(zero, one), (-(lam**2), -2.0 * lam)])
    q = 4.0 * var * lam**3
    return LTISDE(F=F, H=torch.stack([one, zero]),
                  Pinf=_mat([(var, zero), (zero, var * lam**2)]),
                  Qc=_mat([(zero, zero), (zero, q)]),
                  L=torch.stack([zero, one])[:, None])


def matern52_sde(variance: torch.Tensor, lengthscale: torch.Tensor) -> LTISDE:
    """Matern nu=5/2: lam = sqrt(5)/l, q = 16/3 sigma^2 lam^5."""
    var, ls = _scalar(variance), _scalar(lengthscale)
    lam = math.sqrt(5.0) / ls
    zero, one = torch.zeros_like(var), torch.ones_like(var)
    F = _mat([(zero, one, zero), (zero, zero, one),
              (-(lam**3), -3.0 * lam**2, -3.0 * lam)])
    q = var * lam**5 * (16.0 / 3.0)
    kappa = var * lam**2 / 3.0  # -E[f(t) f''(t)], the (0,2) cross moment
    Pinf = _mat([(var, zero, -kappa), (zero, kappa, zero),
                 (-kappa, zero, var * lam**4)])
    return LTISDE(F=F, H=torch.stack([one, zero, zero]), Pinf=Pinf,
                  Qc=_mat([(zero, zero, zero), (zero, zero, zero),
                           (zero, zero, q)]),
                  L=torch.stack([zero, zero, one])[:, None])


def sum_sde(*parts: LTISDE) -> LTISDE:
    """f = sum_i f_i with independent part states: everything
    block-diagonal, H concatenated."""
    L = None
    if all(p.L is not None for p in parts):
        L = torch.block_diag(*(p.L for p in parts))
    return LTISDE(F=torch.block_diag(*(p.F for p in parts)),
                  H=torch.cat([p.H for p in parts]),
                  Pinf=torch.block_diag(*(p.Pinf for p in parts)),
                  Qc=torch.block_diag(*(p.Qc for p in parts)), L=L)


def _product_pair(a: LTISDE, b: LTISDE) -> LTISDE:
    """Kronecker composition: expm((F1 (+) F2) t) = expm(F1 t) (x) expm(F2 t)
    makes H expm(F tau) Pinf H^T = k1(tau) k2(tau); Qc follows from the
    Lyapunov identity applied to the composite."""
    Ia = torch.eye(a.d, dtype=a.F.dtype, device=a.F.device)
    Ib = torch.eye(b.d, dtype=b.F.dtype, device=b.F.device)
    return LTISDE(F=torch.kron(a.F, Ib) + torch.kron(Ia, b.F),
                  H=torch.kron(a.H, b.H),
                  Pinf=torch.kron(a.Pinf, b.Pinf),
                  Qc=torch.kron(a.Qc, b.Pinf) + torch.kron(a.Pinf, b.Qc),
                  L=None)


def product_sde(*parts: LTISDE) -> LTISDE:
    out = parts[0]
    for p in parts[1:]:
        out = _product_pair(out, p)
    return out


def discretize(sde: LTISDE,
               dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact discretization over gaps `dt` (N,): A (N, d, d), Q (N, d, d).

    A_k = expm(F dt_k) (`torch.linalg.matrix_exp`); Q_k = Pinf - A_k Pinf
    A_k^T, PSD by construction, and dt = 0 gives (A, Q) = (I, 0). The dtype
    is promoted before the arithmetic, as in the reference (float32
    hyperparameters with float64 timestamps is the default setup).
    """
    dtype = torch.promote_types(sde.F.dtype, dt.dtype)
    F, Pinf = sde.F.to(dtype), sde.Pinf.to(dtype)
    A = torch.linalg.matrix_exp(F[None] * dt.to(dtype)[:, None, None])
    Q = Pinf[None] - A @ Pinf @ A.mT
    return A, 0.5 * (Q + Q.mT)
