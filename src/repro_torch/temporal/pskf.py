"""Kalman filtering and smoothing for state-space GPs: a parallel
associative scan (log depth) and a sequential twin.

Counterpart of `repro.temporal.pskf`. Model (from `sde.discretize`):
per-step transition and noise (A_k, Q_k), a shared observation row H (d,)
and noise variance R, prior x_0 ~ N(m0, P0) at the step before the first
timestamp:

    x_k = A_k x_{k-1} + q_k,  q_k ~ N(0, Q_k)
    y_k = H x_k + r_k,        r_k ~ N(0, R)          (k = 1..N)

Observations are (N, D): the D output columns share the covariance
recursion, so the state mean is a (d, D) matrix. A boolean `mask` marks
the steps that carry an observation; masked steps are pure predictions.

The parallel path is Sarkka & Garcia-Fernandez (2021): filtering is a
prefix scan of five-tuples (A, b, C, eta, J) under an associative combine,
smoothing a suffix scan of triples (E, g, L). `associative_scan` below is
written in torch ops and follows `jax.lax.associative_scan`'s recursion
(combine adjacent pairs, recurse on the results, fill the even positions),
so the combines run on the same operands in the same order as the
reference's and round alike. Every level is a handful of batched (d, d)
products and solves over the level's elements, and autograd saves
O(N d^2) in all. The sequential twin is one Python step per timestamp.

Both paths return the exact log marginal likelihood sum_k log N(y_k |
H m^-_k, S_k), computed by shared code (`_lml`) from their own filtered
moments.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch


class FilterResult(NamedTuple):
    means: torch.Tensor  # (N, d, D) filtered state means
    covs: torch.Tensor  # (N, d, d) filtered state covariances (shared over D)
    lml: torch.Tensor  # scalar: exact log marginal likelihood of observed steps


def _sym(P: torch.Tensor) -> torch.Tensor:
    return 0.5 * (P + P.mT)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched outer product a[..., i] b[..., j]."""
    return a[..., :, None] * b[..., None, :]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along the first axis (even may
    be one longer)."""
    n = odd.shape[0]
    pairs = torch.stack([even[:n], odd], 1).reshape(2 * n, *odd.shape[1:])
    return torch.cat([pairs, even[n:]]) if even.shape[0] > n else pairs


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], *,
                     reverse: bool = False) -> list:
    """Inclusive scan of `fn` over the first axis of every tensor in
    `elems`, with `jax.lax.associative_scan`'s recursion and argument
    order: `fn(a, b)` gets the earlier element first, and with
    ``reverse=True`` the scan runs from the end, so `a` is the later one."""
    elems = [e.flip(0) for e in elems] if reverse else list(elems)

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        # combine adjacent pairs, then scan their results
        odd = scan(fn([x[0:n - 1:2] for x in xs], [x[1::2] for x in xs]))
        if n % 2 == 0:
            even = fn([o[:-1] for o in odd], [x[2::2] for x in xs])
        else:
            even = fn(odd, [x[2::2] for x in xs])
        # the scan's first element is the first element
        return [_interleave(torch.cat([x[:1], e]), o)
                for x, e, o in zip(xs, even, odd)]

    out = scan(elems)
    return [o.flip(0) for o in out] if reverse else out


def _lml(A, Q, H, R, y, mask, m0, P0, means, covs) -> torch.Tensor:
    """Exact lml from filtered moments: shift (means, covs) one step right,
    predict through (A, Q), and sum the Gaussian log-densities of the
    observed steps. O(N d^2), shared by both filter paths."""
    prev_m = torch.cat([m0[None], means[:-1]])
    prev_P = torch.cat([P0[None], covs[:-1]])
    mp = A @ prev_m  # (N, d, D)
    Pp = A @ prev_P @ A.mT + Q
    S = (Pp @ H) @ H + R  # (N,)
    v = y - H @ mp  # (N, D)
    D = y.shape[1]
    ll = -0.5 * (D * torch.log(2.0 * math.pi * S) + (v * v).sum(1) / S)
    return torch.where(mask, ll, torch.zeros_like(ll)).sum()


def _filter_sequential(A, Q, H, R, y, mask, m0, P0):
    """Textbook predict/update recursion, one Python step per timestamp."""
    m, P = m0, P0
    means, covs = [], []
    observed = mask.tolist()
    for k in range(A.shape[0]):
        A_k = A[k]
        mp = A_k @ m
        Pp = _sym(A_k @ P @ A_k.T + Q[k])
        if observed[k]:
            PH = Pp @ H
            K = PH / (PH @ H + R)
            m = mp + torch.outer(K, y[k] - H @ mp)
            P = _sym(Pp - torch.outer(K, H) @ Pp)
        else:  # a masked step: the reference's zero gain leaves the prediction
            m, P = mp, Pp
        means.append(m)
        covs.append(P)
    return torch.stack(means), torch.stack(covs)


def _filter_elements(A, Q, H, R, y, mask, m0, P0):
    """Per-step associative filtering elements (A, b, C, eta, J).

    Generic step, with S = H Q H^T + R and K = Q H^T / S:
    A_el = (I - K H) A, b = K y, C = (I - K H) Q, eta = A^T H^T y / S,
    J = A^T H^T H A / S. A masked step is the pure prediction element
    (A, 0, Q, 0, 0), reached by zeroing K and H/S. The first element folds
    in the prior through step 1's predict and update."""
    obs = mask[:, None]
    y = torch.where(obs, y, torch.zeros_like(y))  # masked y may be padding
    QH = Q @ H  # (N, d)
    S = QH @ H + R  # (N,)
    K = torch.where(obs, QH / S[:, None], torch.zeros_like(QH))
    KH = _outer(K, H)
    A_el = A - KH @ A
    b = _outer(K, y)
    C = _sym(Q - KH @ Q)
    HS = torch.where(obs, H / S[:, None], torch.zeros_like(QH))
    AtHS = (A.mT @ HS[..., None])[..., 0]
    eta = _outer(AtHS, y)
    J = _sym(_outer(AtHS, H @ A))

    # first element: fold the prior through step 1's predict + update
    m1p = A[0] @ m0
    P1p = _sym(A[0] @ P0 @ A[0].T + Q[0])
    P1pH = P1p @ H
    K1 = torch.where(mask[0], P1pH / (P1pH @ H + R), torch.zeros_like(H))
    b1 = m1p + torch.outer(K1, y[0] - H @ m1p)
    C1 = _sym(P1p - torch.outer(K1, H) @ P1p)
    zero = torch.zeros_like(A[:1])
    return (torch.cat([zero, A_el[1:]]), torch.cat([b1[None], b[1:]]),
            torch.cat([C1[None], C[1:]]),
            torch.cat([torch.zeros_like(eta[:1]), eta[1:]]),
            torch.cat([zero, J[1:]]))


def _filter_op(a, b):
    """Associative filtering combine: `a` is the earlier prefix, `b` the
    later element, each batched over a leading axis."""
    A1, b1, C1, e1, J1 = a
    A2, b2, C2, e2, J2 = b
    I = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    # G = A2 (I + C1 J2)^-1, from the right via a transposed solve
    G = torch.linalg.solve((I + C1 @ J2).mT, A2.mT).mT
    # Et^T = A1^T (I + J2 C1)^-1
    EtT = torch.linalg.solve((I + J2 @ C1).mT, A1).mT
    return (G @ A1, G @ (b1 + C1 @ e2) + b2, _sym(G @ C1 @ A2.mT + C2),
            EtT @ (e2 - J2 @ b1) + e1, _sym(EtT @ J2 @ A1 + J1))


def kalman_filter(A: torch.Tensor, Q: torch.Tensor, H: torch.Tensor,
                  R: torch.Tensor, y: torch.Tensor, m0: torch.Tensor,
                  P0: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                  parallel: bool = True) -> FilterResult:
    """Kalman filter over N steps; `parallel=` picks the associative scan
    (log depth) or the sequential twin. `m0` is (d, D), `P0` (d, d)."""
    if mask is None:
        mask = torch.ones(y.shape[0], dtype=torch.bool, device=y.device)
    # one common dtype up front, as in the reference
    dtype = A.dtype
    for t in (Q, y, m0, P0):
        dtype = torch.promote_types(dtype, t.dtype)
    A, Q, y, m0, P0 = (t.to(dtype) for t in (A, Q, y, m0, P0))
    H, R = torch.as_tensor(H).to(dtype), torch.as_tensor(R).to(dtype)
    if parallel:
        elems = _filter_elements(A, Q, H, R, y, mask, m0, P0)
        _, means, covs, _, _ = associative_scan(_filter_op, elems)
    else:
        means, covs = _filter_sequential(A, Q, H, R, y, mask, m0, P0)
    y_eff = torch.where(mask[:, None], y, torch.zeros_like(y))
    return FilterResult(means, covs,
                        _lml(A, Q, H, R, y_eff, mask, m0, P0, means, covs))


def _rts_gain(m_k, P_k, A_next, Q_next):
    """One-step predicted covariance and the RTS gain P_k A^T Pp^-1."""
    Pp = _sym(A_next @ P_k @ A_next.mT + Q_next)
    return Pp, torch.linalg.solve(Pp, A_next @ P_k).mT


def _smooth_sequential(A, Q, means, covs):
    """Textbook RTS backward recursion."""
    ms, Ps = [means[-1]], [covs[-1]]
    for k in range(means.shape[0] - 2, -1, -1):
        m_k, P_k, A_next = means[k], covs[k], A[k + 1]
        Pp, G = _rts_gain(m_k, P_k, A_next, Q[k + 1])
        ms.append(m_k + G @ (ms[-1] - A_next @ m_k))
        Ps.append(_sym(P_k + G @ (Ps[-1] - Pp) @ G.T))
    return torch.stack(ms[::-1]), torch.stack(Ps[::-1])


def _smooth_elements(A, Q, means, covs):
    """Associative smoothing elements (E, g, L): for k < N the RTS gain
    triple, for k = N the filtered terminal."""
    m_k, P_k, A_next = means[:-1], covs[:-1], A[1:]
    Pp, E = _rts_gain(m_k, P_k, A_next, Q[1:])
    g = m_k - E @ (A_next @ m_k)
    L = _sym(P_k - E @ Pp @ E.mT)
    return (torch.cat([E, torch.zeros_like(E[-1:])]),
            torch.cat([g, means[-1:]]), torch.cat([L, covs[-1:]]))


def _smooth_op(a, b):
    """Associative smoothing combine. Under the reverse scan the first
    argument is the already-combined later suffix, the second the earlier
    element."""
    Ea, ga, La = a
    Eb, gb, Lb = b
    return Eb @ Ea, Eb @ ga + gb, _sym(Eb @ La @ Eb.mT + Lb)


def rts_smoother(A: torch.Tensor, Q: torch.Tensor, means: torch.Tensor,
                 covs: torch.Tensor, *,
                 parallel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """RTS smoother over filtered moments: (N, d, D) means, (N, d, d) covs
    -> the same shapes, conditioned on all observations. `A`/`Q` are the
    discretization the filter consumed."""
    if parallel:
        _, ms, Ps = associative_scan(
            _smooth_op, _smooth_elements(A, Q, means, covs), reverse=True)
        return ms, Ps
    return _smooth_sequential(A, Q, means, covs)
