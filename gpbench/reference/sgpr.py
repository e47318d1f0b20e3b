"""Plain PyTorch reference of sparse GP regression with an RBF kernel on
the collapsed (Titsias) bound (the paper's eq. (2)-(3), arXiv:1410.4984;
GPy's `SparseGPRegression`): the loss, its gradient and the Adam step,
computed in blocks of points.

The function it computes is the model as the program defines it, written
out again from the equations:

    K_fu[n, m] = v exp(-1/2 sum_q (x_nq - z_mq)^2 / l_q^2)
    psi0 = N v,  psi2 = K_fu^T K_fu,  psiY = K_fu^T Y,  yy = sum_n y_n . y_n
    loss = -F / N

with F the collapsed bound of `gplvm.py` (the same K_uu, jitter, factors
and terms) at these exact statistics; the inputs X are data, so there is
no KL term and no gradient for them. The parameters are the kernel's,
Z and log_beta. Adam is `gplvm.py`'s.

`precision` is `gplvm.py`'s: the matrix products through `Numerics.mm`,
the statistics' inputs and K_fu's entries through `Numerics.stat`.

The gradient comes from autograd: through the epilogue to the kernel's
parameters, Z, log_beta and the cotangents of psi2 and psiY, then through
each block's K_fu^T K_fu and K_fu^T Y weighted by those cotangents.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .gplvm import (Numerics, Params, Stats, adam_init, adam_update, bound, cast,  # noqa: F401
                    ieee_float32, kuu)

# (points x M) elements of K_fu a block, 128 MiB of float64: autograd through
# a block keeps a few of them
BLOCK_ELEMENTS = 1 << 24


def kfu(X, Z, variance, lengthscale) -> torch.Tensor:
    """(B, M), the direct (x - z)^2 / l^2 form."""
    d = X[:, None, :] - Z[None, :, :]
    return variance * torch.exp(-0.5 * (d * d / (lengthscale * lengthscale)).sum(-1))


def _block(N: int, M: int) -> int:
    return max(1, min(N, BLOCK_ELEMENTS // M))


def _cross(X, Y, Z, variance, lengthscale, num: Numerics):
    """One block's (K_fu^T K_fu, K_fu^T Y, Y as the arithmetic holds it)."""
    K = num.stat(kfu(num.stat(X), num.stat(Z), variance, lengthscale))
    Yb = num.stat(Y)
    return num.mm(K.T, K), num.mm(K.T, Yb), Yb


def stats(params: Params, X: torch.Tensor, Y: torch.Tensor, num: Numerics) -> Stats:
    """The five statistics, one block of points at a time."""
    dt = num.dtype
    p = cast(params, dt)
    X, Y = X.to(dt), Y.to(dt)
    var = torch.exp(p["kern"]["log_variance"])
    ls = torch.exp(p["kern"]["log_lengthscale"])
    Z = p["Z"]
    N, M, D = Y.shape[0], Z.shape[0], Y.shape[1]
    psi2, psiY, yy = Z.new_zeros(M, M), Z.new_zeros(M, D), Z.new_zeros(())
    B = _block(N, M)
    with torch.no_grad(), ieee_float32():
        for lo in range(0, N, B):
            p2, pY, Yb = _cross(X[lo:lo + B], Y[lo:lo + B], Z, var, ls, num)
            psi2 += p2
            psiY += pY
            yy += (Yb * Yb).sum()
    return Stats(N * var, psi2, psiY, yy, Z.new_tensor(float(N)))


def value_and_grad(params: Params, X: torch.Tensor, Y: torch.Tensor,
                   num: Numerics) -> Tuple[torch.Tensor, Params]:
    """The loss at `params` and its gradient tree, in `num`'s arithmetic."""
    dt = num.dtype
    p = cast(params, dt)
    X, Y = X.to(dt), Y.to(dt)
    N, D = Y.shape
    st = stats(p, X, Y, num)
    names = ["Z", "log_variance", "log_lengthscale", "log_beta"]
    leaves = {"Z": p["Z"], "log_variance": p["kern"]["log_variance"],
              "log_lengthscale": p["kern"]["log_lengthscale"], "log_beta": p["log_beta"]}
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    psi2 = st.psi2.clone().requires_grad_()
    psiY = st.psiY.clone().requires_grad_()
    with torch.enable_grad(), ieee_float32():
        var = torch.exp(leaves["log_variance"])
        K = kuu(leaves["Z"], var, torch.exp(leaves["log_lengthscale"]), num)
        F = bound(K, Stats(N * var, psi2, psiY, st.yy, st.n), torch.exp(leaves["log_beta"]), D, num)
        loss = -F / N
        g = torch.autograd.grad(loss, [leaves[k] for k in names] + [psi2, psiY])
    grads = dict(zip(names, g[:4]))
    _point_grads(p, X, Y, g[4].detach(), g[5].detach(), grads, num)
    tree = {"kern": {"log_lengthscale": grads["log_lengthscale"],
                     "log_variance": grads["log_variance"]},
            "Z": grads["Z"], "log_beta": grads["log_beta"]}
    return loss.detach(), cast(tree, dt)


def _point_grads(p, X, Y, G2, GY, grads, num: Numerics) -> None:
    """Each block's K_fu^T K_fu and K_fu^T Y weighted by the cotangents G2
    and GY, differentiated by autograd: the Z and kernel parts, added into
    `grads`."""
    N, M = X.shape[0], p["Z"].shape[0]
    Zg = p["Z"].clone().requires_grad_()
    lv = p["kern"]["log_variance"].clone().requires_grad_()
    ll = p["kern"]["log_lengthscale"].clone().requires_grad_()
    B = _block(N, M)
    with torch.enable_grad(), ieee_float32():
        for lo in range(0, N, B):
            p2, pY, _ = _cross(X[lo:lo + B], Y[lo:lo + B], Zg, torch.exp(lv), torch.exp(ll), num)
            val = (G2 * p2).sum() + (GY * pY).sum()
            gz, gv, gl = torch.autograd.grad(val, [Zg, lv, ll])
            grads["Z"] = grads["Z"] + gz
            grads["log_variance"] = grads["log_variance"] + gv
            grads["log_lengthscale"] = grads["log_lengthscale"] + gl


def train(params: Params, X: torch.Tensor, Y: torch.Tensor, steps: int, lr: float,
          num: Numerics) -> dict:
    """`steps` Adam steps from `params`: each step's loss (before its
    update), the first moment after the first step, and the parameters
    after the last."""
    p = cast(params, num.dtype)
    opt = adam_init(p)
    losses, m1 = [], None
    for _ in range(steps):
        loss, g = value_and_grad(p, X, Y, num)
        p, opt = adam_update(g, opt, p, lr)
        losses.append(float(loss))
        if m1 is None:
            m1 = opt.m
    return {"losses": losses, "m1": m1, "params": p}
