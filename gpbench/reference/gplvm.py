"""Plain PyTorch reference of the Bayesian GP-LVM with an RBF kernel on
the collapsed bound (Titsias and Lawrence 2010; the paper's eq. (2)-(4),
arXiv:1410.4984): the loss, its gradient, the Adam step and the served
state, computed in blocks of points so that 2^24 points fit.

The function it computes is the model as the program defines it, written
out again from the equations:

    psi0 = N v,  psi1_nm = v prod_q (1 + S_nq / l_q^2)^-1/2
                           exp(-(mu_nq - z_mq)^2 / (2 (l_q^2 + S_nq)))
    psi2_n,ab = v^2 prod_q (1 + 2 S_nq / l_q^2)^-1/2
                exp(-(z_aq - z_bq)^2 / (4 l_q^2)
                    - (mu_nq - zbar_abq)^2 / (l_q^2 + 2 S_nq))
    psiY = sum_n psi1_n^T y_n,  yy = sum_n y_n . y_n

    L  = chol(Kuu + j I),  j = 1e-6 x (1 in float64, 100 in float32)
                               x mean(diag Kuu)
    A  = Kuu + j I + beta sym(psi2),  LA = chol(A + 100 eps mean(diag A) I)
    c  = LA^-1 psiY
    F  = D N/2 log(beta / 2 pi) - D/2 (log|LA LA^T| - log|L L^T|)
         - beta/2 yy + beta^2/2 ||c||^2 - beta D/2 psi0
         + beta D/2 tr(L^-1 sym(psi2) L^-T)
    loss = -(F - sum_n KL(q(x_n) || N(0, I))) / N

with K's squared distances in the expanded form |a|^2 + |b|^2 - 2 a.b
(GPy's), the jitter and eps of the configuration's dtype, and a failed
Cholesky giving NaN. Adam is the one the system specifies: moments in
float32, bias correction folded into the step size, the parameter rounded
to float32 before the step and cast back.

`precision` picks the arithmetic: "float64" (the reference), "float32", or
float32 with parts of it one precision lower, each rounded as the hardware
would round it so that it reads the same on a CPU:

  * "tf32": every matrix product's operands rounded to TF32's 10 bits of
    mantissa first, as the tensor cores do;
  * "tf32-refold": the operands of every Cholesky factorization and
    triangular solve rounded to TF32, the rest in float32 (K_uu's distance
    product too: in TF32 its Cholesky fails at inducing points off their
    grid, and then there is no number to read);
  * "bf16-stats": the statistics in bfloat16, the nearest precision below
    float32 for work that is not a matrix product: the point terms' inputs
    (mu, S, Z, the pair midpoints and Y) and values (psi1, the pair terms)
    rounded to bfloat16, summed in float32; the rest in float32.

The gradient comes from autograd over each block's own terms, weighted by
the cotangents of the statistics that the epilogue gives; a rounding
passes the gradient through unchanged.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Tuple

import torch

# name -> (dtype, products in TF32, K_uu's product too, Cholesky and solve
# operands in TF32, statistics in bfloat16)
PRECISIONS = {"float64": (torch.float64, False, False, False, False),
              "float32": (torch.float32, False, False, False, False),
              "tf32": (torch.float32, True, True, False, False),
              "tf32-refold": (torch.float32, False, False, True, False),
              "bf16-stats": (torch.float32, False, False, False, True)}
# (points x pairs) elements a block holds, 2 GiB of float64: few enough
# blocks that the host does not pace the reference
BLOCK_ELEMENTS = 1 << 28

Params = Dict


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to the nearest TF32 value (10 mantissa bits, ties
    to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _through(x: torch.Tensor, rounded) -> torch.Tensor:
    """`rounded(x)`'s value with `x`'s gradient."""
    d = x.detach()
    return x + (rounded(d) - d)


@contextlib.contextmanager
def ieee_float32():
    """Float32 matrix products in full float32 inside the block (no TF32
    unless `to_tf32` asked for it)."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


class Numerics(NamedTuple):
    dtype: torch.dtype  # the arithmetic's
    tf32: bool  # matrix products' operands rounded to TF32
    model_dtype: torch.dtype  # the configuration's: sets jitter and eps
    kuu_tf32: bool = False  # K_uu's distance product too
    refold_tf32: bool = False  # Cholesky and triangular-solve operands
    stats_bf16: bool = False  # the statistics' point terms

    @staticmethod
    def of(precision: str, model_dtype: torch.dtype) -> "Numerics":
        dtype, tf32, kuu_tf32, refold_tf32, stats_bf16 = PRECISIONS[precision]
        return Numerics(dtype, tf32, model_dtype, kuu_tf32, refold_tf32, stats_bf16)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return to_tf32(a) @ to_tf32(b)
        return a @ b

    def solver(self, x: torch.Tensor) -> torch.Tensor:
        """A Cholesky or triangular-solve operand as the arithmetic holds it."""
        return _through(x, to_tf32) if self.refold_tf32 else x

    def stat(self, x: torch.Tensor) -> torch.Tensor:
        """A statistic's point term or input as the arithmetic holds it."""
        if self.stats_bf16:
            return _through(x, lambda d: d.to(torch.bfloat16).to(d.dtype))
        return x


class Stats(NamedTuple):
    psi0: torch.Tensor
    psi2: torch.Tensor
    psiY: torch.Tensor
    yy: torch.Tensor
    n: torch.Tensor


class State(NamedTuple):
    """The served state's statistics and factors."""
    stats: Stats
    L: torch.Tensor
    LA: torch.Tensor
    Kuu_inv_mean: torch.Tensor


def cast(params: Params, dtype: torch.dtype) -> Params:
    """A copy of the parameter tree in `dtype`."""
    if isinstance(params, dict):
        return {k: cast(v, dtype) for k, v in params.items()}
    return params.detach().to(dtype)


def kuu(Z, variance, lengthscale, num: Numerics) -> torch.Tensor:
    Zs = Z / lengthscale
    sq = (Zs * Zs).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (num.mm(Zs, Zs.T) if num.kuu_tf32 else Zs @ Zs.T)
    return variance * torch.exp(-0.5 * d2.clamp_min(0.0))


def psi1(mu, S, Z, variance, l2) -> torch.Tensor:
    """(B, M)."""
    den = l2 + S  # (B, Q)
    norm = torch.rsqrt(den / l2).prod(-1)  # prod (1 + S / l^2)^-1/2
    d = mu[:, None, :] - Z[None, :, :]
    return variance * norm[:, None] * torch.exp(-0.5 * (d * d / den[:, None, :]).sum(-1))


def pair_terms(mu, S, zbar, l2) -> torch.Tensor:
    """(B, P): prod_q (1 + 2 S / l^2)^-1/2 exp(-(mu - zbar)^2 / (l^2 + 2 S))
    for each point and packed pair a <= b.

    In float64 the exponent is expanded in zbar and evaluated as one product
    of (B, 1 + 2Q) point terms and (1 + 2Q, P) pair terms: three passes over
    the (B, P) block instead of eight. The expansion cancels terms up to
    (M / 2)^2 / l^2 in size, which costs ~1e-12 of the exponent in float64,
    far below any number the check compares; in a lower precision the
    exponent is evaluated directly, as a careful program at that precision
    would."""
    den = l2 + 2.0 * S
    lognorm = -0.5 * torch.log1p(2.0 * S / l2).sum(-1)
    if mu.dtype == torch.float64:
        point = torch.cat([(lognorm - (mu * mu / den).sum(-1))[:, None], 2.0 * mu / den,
                           -1.0 / den], dim=1)
        pair = torch.cat([torch.ones_like(zbar[:, :1]), zbar, zbar * zbar], dim=1)
        return torch.exp(point @ pair.T)
    expo = lognorm[:, None]
    for q in range(mu.shape[1]):
        d = mu[:, q, None] - zbar[None, :, q]
        expo = expo - d * d / den[:, q, None]
    return torch.exp(expo)


def _pairs(Z, variance, l2):
    M = Z.shape[0]
    a, b = torch.triu_indices(M, M, device=Z.device)
    dz = Z[a] - Z[b]
    pref = variance**2 * torch.exp(-(dz * dz / (4.0 * l2)).sum(-1))
    return a, b, 0.5 * (Z[a] + Z[b]), pref


def _block(N: int, P: int) -> int:
    return max(1, min(N, BLOCK_ELEMENTS // P))


def stats(params: Params, Y: torch.Tensor, num: Numerics) -> Stats:
    """The five statistics, one block of points at a time."""
    dt = num.dtype
    p = cast(params, dt)
    Y = Y.to(dt)
    var = torch.exp(p["kern"]["log_variance"])
    l2 = torch.exp(2.0 * p["kern"]["log_lengthscale"])
    Z = p["Z"]
    N, M, D = Y.shape[0], Z.shape[0], Y.shape[1]
    a, b, zbar, pref = _pairs(Z, var, l2)
    zbar, Zt = num.stat(zbar), num.stat(Z)
    acc2 = Z.new_zeros(a.shape[0])
    accY = Z.new_zeros(M, D)
    yy = Z.new_zeros(())
    B = _block(N, a.shape[0])
    with torch.no_grad(), ieee_float32():
        for lo in range(0, N, B):
            mu = num.stat(p["q_mu"][lo:lo + B])
            S = num.stat(torch.exp(p["q_logS"][lo:lo + B]))
            Yb = num.stat(Y[lo:lo + B])
            acc2 += num.stat(pair_terms(mu, S, zbar, l2)).sum(0)
            accY += num.mm(num.stat(psi1(mu, S, Zt, var, l2)).T, Yb)
            yy += (Yb * Yb).sum()
        psi2 = Z.new_zeros(M, M)
        psi2[a, b] = pref * acc2
        psi2[b, a] = pref * acc2
    return Stats(N * var, psi2, accY, yy, Z.new_tensor(float(N)))


def _cholesky(A, num: Numerics):
    L, info = torch.linalg.cholesky_ex(num.solver(A))
    return torch.where(info == 0, L, torch.full_like(L, math.nan))


def _solve(L, B, num: Numerics, upper: bool = False):
    return torch.linalg.solve_triangular(num.solver(L), num.solver(B), upper=upper)


def factors(Kuu, st: Stats, beta, num: Numerics):
    """(L, LA, c, sym(psi2))."""
    M = Kuu.shape[0]
    eye = torch.eye(M, dtype=Kuu.dtype, device=Kuu.device)
    boost = 1.0 if num.model_dtype == torch.float64 else 100.0
    jitter = 1e-6 * boost * Kuu.diagonal().mean().clamp_min(1e-12)
    Kj = Kuu + jitter * eye
    L = _cholesky(Kj, num)
    psi2 = 0.5 * (st.psi2 + st.psi2.T)
    A = Kj + beta * psi2
    eps = torch.finfo(num.model_dtype).eps
    LA = _cholesky(A + 100.0 * eps * A.diagonal().mean() * eye, num)
    return L, LA, _solve(LA, st.psiY, num), psi2


def bound(Kuu, st: Stats, beta, D: int, num: Numerics):
    L, LA, c, psi2 = factors(Kuu, st, beta, num)
    logdetB = 2.0 * (torch.log(LA.diagonal()).sum() - torch.log(L.diagonal()).sum())
    tmp = _solve(L, psi2, num)
    trace = torch.trace(_solve(L, tmp.T, num).T)
    N = st.n
    return (0.5 * D * N * torch.log(beta / (2.0 * math.pi)) - 0.5 * D * logdetB
            - 0.5 * beta * st.yy + 0.5 * beta**2 * (c * c).sum()
            - 0.5 * beta * D * st.psi0 + 0.5 * beta * D * trace)


def kl(q_mu, q_logS, B: int) -> torch.Tensor:
    out = q_mu.new_zeros(())
    for lo in range(0, q_mu.shape[0], B):
        mu, ls = q_mu[lo:lo + B], q_logS[lo:lo + B]
        out += 0.5 * (torch.exp(ls) + mu * mu - ls - 1.0).sum()
    return out


def value_and_grad(params: Params, Y: torch.Tensor, num: Numerics) -> Tuple[torch.Tensor, Params]:
    """The loss at `params` and its gradient tree, in `num`'s arithmetic."""
    dt = num.dtype
    p = cast(params, dt)
    Y = Y.to(dt)
    N, D = Y.shape
    st = stats(p, Y, num)
    with torch.no_grad():
        klv = kl(p["q_mu"], p["q_logS"], _block(N, 1024))
    leaves = {"Z": p["Z"].clone().requires_grad_(),
              "log_variance": p["kern"]["log_variance"].clone().requires_grad_(),
              "log_lengthscale": p["kern"]["log_lengthscale"].clone().requires_grad_(),
              "log_beta": p["log_beta"].clone().requires_grad_()}
    psi2 = st.psi2.clone().requires_grad_()
    psiY = st.psiY.clone().requires_grad_()
    with torch.enable_grad(), ieee_float32():
        var = torch.exp(leaves["log_variance"])
        ls = torch.exp(leaves["log_lengthscale"])
        K = kuu(leaves["Z"], var, ls, num)
        F = bound(K, Stats(N * var, psi2, psiY, st.yy, st.n), torch.exp(leaves["log_beta"]), D, num)
        loss = -(F - klv) / N
        names = ["Z", "log_variance", "log_lengthscale", "log_beta"]
        g = torch.autograd.grad(loss, [leaves[k] for k in names] + [psi2, psiY])
    grads = dict(zip(names, g[:4]))
    G2, GY = g[4], g[5]
    d_mu, d_logS = _point_grads(p, Y, G2.detach(), GY.detach(), grads, num)
    with torch.no_grad():
        d_mu += p["q_mu"] / N
        d_logS += 0.5 * (torch.exp(p["q_logS"]) - 1.0) / N
    tree = {"kern": {"log_lengthscale": grads["log_lengthscale"],
                     "log_variance": grads["log_variance"]},
            "Z": grads["Z"], "log_beta": grads["log_beta"],
            "q_mu": d_mu, "q_logS": d_logS}
    return loss.detach(), cast(tree, dt)


def _point_grads(p, Y, G2, GY, grads, num: Numerics):
    """Each block's statistics weighted by their cotangents, differentiated
    by autograd: the per-point gradients, and the Z and kernel parts
    added into `grads`."""
    N = Y.shape[0]
    M = p["Z"].shape[0]
    a, b = torch.triu_indices(M, M, device=G2.device)
    W = G2[a, b] + G2[b, a]
    W = torch.where(a == b, 0.5 * W, W)
    d_mu = torch.empty_like(p["q_mu"])
    d_logS = torch.empty_like(p["q_logS"])
    Zg = p["Z"].clone().requires_grad_()
    lv = p["kern"]["log_variance"].clone().requires_grad_()
    ll = p["kern"]["log_lengthscale"].clone().requires_grad_()
    B = _block(N, a.shape[0])
    with torch.enable_grad(), ieee_float32():
        for lo in range(0, N, B):
            mu = p["q_mu"][lo:lo + B].clone().requires_grad_()
            logS = p["q_logS"][lo:lo + B].clone().requires_grad_()
            m, S = num.stat(mu), num.stat(torch.exp(logS))
            var = torch.exp(lv)
            l2 = torch.exp(2.0 * ll)
            _, _, zbar, pref = _pairs(Zg, var, l2)
            terms = num.stat(pair_terms(m, S, num.stat(zbar), l2))
            val = (W * pref * terms.sum(0)).sum()
            p1 = num.stat(psi1(m, S, num.stat(Zg), var, l2))
            val = val + (GY * num.mm(p1.T, num.stat(Y[lo:lo + B]))).sum()
            gm, gs, gz, gv, gl = torch.autograd.grad(val, [mu, logS, Zg, lv, ll])
            d_mu[lo:lo + B] = gm
            d_logS[lo:lo + B] = gs
            grads["Z"] = grads["Z"] + gz
            grads["log_variance"] = grads["log_variance"] + gv
            grads["log_lengthscale"] = grads["log_lengthscale"] + gl
    return d_mu, d_logS


class Adam(NamedTuple):
    """The system's Adam state: step count and the two moments, stored in
    each parameter's dtype."""
    t: int
    m: Params
    v: Params


def adam_init(params: Params) -> Adam:
    return Adam(0, _map(torch.zeros_like, params), _map(torch.zeros_like, params))


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def adam_update(grads: Params, state: Adam, params: Params, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step, as the system specifies it: no clipping, no decay; the
    moments and the update in float32; returns (params, state)."""
    t = state.t + 1
    dev = next(iter(_leaves(params))).device
    tt = torch.tensor(float(t), dtype=torch.float32, device=dev)
    bc1 = 1.0 - b1 ** tt
    bc2 = 1.0 - b2 ** tt
    alpha = torch.tensor(lr, dtype=torch.float32, device=dev) * torch.sqrt(bc2) / bc1

    def leaf(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m.float() + (1.0 - b1) * g32
        v_new = b2 * v.float() + (1.0 - b2) * g32 * g32
        delta = alpha * m_new / (torch.sqrt(v_new) + eps)
        return (p.float() - delta).to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = _map(leaf, params, grads, state.m, state.v)
    pick = lambda i: _map(lambda x: x[i], out)  # noqa: E731
    return pick(0), Adam(t, pick(1), pick(2))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def train(params: Params, Y: torch.Tensor, steps: int, lr: float, num: Numerics) -> dict:
    """`steps` Adam steps from `params`: each step's loss (before its
    update), the first moment after the first step, and the parameters
    after the last."""
    p = cast(params, num.dtype)
    opt = adam_init(p)
    losses, m1 = [], None
    for _ in range(steps):
        loss, g = value_and_grad(p, Y, num)
        p, opt = adam_update(g, opt, p, lr)
        losses.append(float(loss))
        if m1 is None:
            m1 = opt.m
    return {"losses": losses, "m1": m1, "params": p}


def build(params: Params, Y: torch.Tensor, num: Numerics) -> State:
    """The served state: the statistics and L, LA and K_uu^-1 mean_u."""
    dt = num.dtype
    p = cast(params, dt)
    st = stats(p, Y, num)
    with torch.no_grad(), ieee_float32():
        var = torch.exp(p["kern"]["log_variance"])
        ls = torch.exp(p["kern"]["log_lengthscale"])
        beta = torch.exp(p["log_beta"])
        L, LA, c, _ = factors(kuu(p["Z"], var, ls, num), st, beta, num)
        mean = beta * _solve(LA.T, c, num, upper=True)
    return State(st, L, LA, mean)
