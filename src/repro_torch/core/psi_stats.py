"""Sufficient statistics of the collapsed sparse-GP bound (paper §2).

Counterpart of `repro.core.psi_stats`. Everything the bound needs from the
N datapoints is reduced to

    stats.psi0   scalar   sum_n <k(x_n, x_n)>
    stats.psi2   (M, M)   sum_n <k_fu(x_n)^T k_fu(x_n)>     ("Phi" in the paper)
    stats.psiY   (M, D)   sum_n <k_fu(x_n)>^T y_n           ("Psi" in the paper)
    stats.yy     scalar   sum_n y_n y_n^T
    stats.n      scalar   number of datapoints accumulated

All five are plain sums over n, so `SuffStats` is a commutative monoid
under `combine` (with `subtract` as its inverse).

`backend="fused"` routes the RBF statistics through the fused op
(`repro_torch.kernels.ops.suffstats`: the CUDA kernel on the card, its
plain version on the CPU; the exact path rides it with S = 0);
`backend="pallas"` routes the expected statistics through the
single-statistic ops `ops.psi1` and `ops.psi2` and the exact ones through
`ops.kfu` (their CUDA kernels on the card), with psiY = psi1^T Y, or
psi2 = K_fu^T K_fu and psiY = K_fu^T Y, as matrix products outside any
kernel, as in the reference; `backend="jnp"` keeps the name of the
reference's plain path and computes with plain PyTorch (a chunked loop over
N for Psi2).

The matrix products (psi2 = K_fu^T K_fu, psiY = K_fu^T Y or psi1^T Y, and
their reverse products) run in full float32 for float32 tensors whatever
the caller has set: `full_float32_matmul` pins cuBLAS to IEEE float32 while
they run and gives the caller's setting back afterwards (TF32 keeps ~3
digits, and the float32 bound is already fragile).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ref


def _rbf_variance(kern_params) -> torch.Tensor:
    return torch.exp(kern_params["log_variance"])


def _rbf_lengthscale(kern_params) -> torch.Tensor:
    return torch.exp(kern_params["log_lengthscale"])


class SuffStats(NamedTuple):
    psi0: torch.Tensor  # scalar
    psi2: torch.Tensor  # (M, M)
    psiY: torch.Tensor  # (M, D)
    yy: torch.Tensor  # scalar
    n: torch.Tensor  # scalar (float, like the reference)

    @staticmethod
    def combine(a: "SuffStats", b: "SuffStats") -> "SuffStats":
        return SuffStats(*(x + y for x, y in zip(a, b)))

    @staticmethod
    def subtract(a: "SuffStats", b: "SuffStats") -> "SuffStats":
        """Monoid inverse: remove `b`'s datapoints from `a`. Exact algebra,
        but floating cancellation can leave `a - b` indefinite when b
        carries most of a's mass — hence the serving-layer downdate's
        condition guard (repro_torch.serve.online)."""
        return SuffStats(*(x - y for x, y in zip(a, b)))


_precision_lock = threading.Lock()
_pinned = 0  # threads inside full_float32_matmul
_saved = None  # the caller's setting, given back when the last one leaves


@contextlib.contextmanager
def full_float32_matmul():
    """Float32 matrix products in full IEEE float32 (no TF32) inside the
    block (`torch.backends.cuda.matmul.fp32_precision`, which the legacy
    `allow_tf32` and `set_float32_matmul_precision` also set); the caller's
    setting is restored when the last thread inside leaves. Counted under
    a lock, so concurrent statistics passes (a `GPServer` worker beside its
    caller, autograd's device thread) never give the setting back while one
    of them is still inside.

    The setting is process-wide, so two effects reach other threads: while
    any thread is inside, every other thread's float32 products also run
    without TF32; and a setting another thread makes meanwhile is kept (the
    last thread to leave restores the caller's only if the flag still reads
    "ieee"), except that one made to "ieee" itself is then undone."""
    global _pinned, _saved
    matmul = torch.backends.cuda.matmul
    with _precision_lock:
        if _pinned == 0:
            _saved = matmul.fp32_precision
            matmul.fp32_precision = "ieee"
        _pinned += 1
    try:
        yield
    finally:
        with _precision_lock:
            _pinned -= 1
            if _pinned == 0 and matmul.fp32_precision == "ieee":
                matmul.fp32_precision = _saved


def _column_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.size(0)


class _FullPrecisionMatmul(torch.autograd.Function):
    """a @ b with both directions' products inside `full_float32_matmul`.
    The gradients are PyTorch's own mm backward's, product for product: each
    comes out in its input's layout (K_fu^T's transposed), so autograd's sum
    of K_fu's cotangents stays one contiguous add."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_float32_matmul():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with full_float32_matmul():
            if ctx.needs_input_grad[0]:
                ga = (b @ g.T).T if _column_major(a) else g @ b.T
            if ctx.needs_input_grad[1]:
                gb = (g.T @ a).T if _column_major(b) else a.T @ g
        return ga, gb


def stat_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for the statistics, never in TF32 (`full_float32_matmul`)."""
    return _FullPrecisionMatmul.apply(a, b)


def checkpointed(fn, *args):
    """fn(*args), recomputed in the backward pass instead of keeping its
    intermediates (`torch.utils.checkpoint`, the counterpart of
    `jax.checkpoint`); a plain call where no graph is being built."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


BACKENDS = ("jnp", "fused", "pallas")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _count(X: torch.Tensor) -> torch.Tensor:
    return X.new_full((), float(X.shape[0]))


# ---------------------------------------------------------------------------
# exact statistics (deterministic X)
# ---------------------------------------------------------------------------

def exact_stats_rbf(kern_params, X, Y, Z, *, backend: str = "jnp",
                    bwd_backend: str = "auto") -> SuffStats:
    _check_backend(backend)
    variance = _rbf_variance(kern_params)
    lengthscale = _rbf_lengthscale(kern_params)
    if backend == "fused":
        # S -> 0 collapses the expected statistics to the exact ones, so the
        # supervised path rides the same fused kernel
        from repro_torch.kernels import ops

        psi2, psiY = ops.suffstats(X, torch.zeros_like(X), Y, Z, variance,
                                   lengthscale, bwd_backend=bwd_backend)
    else:
        if backend == "pallas":
            # K_fu through its kernel in both directions; the two products
            # are plain matrix products outside any kernel, as in the
            # reference
            from repro_torch.kernels import ops

            Kfu = ops.kfu(X, Z, variance, lengthscale, bwd_backend=bwd_backend)
        else:
            Kfu = ref.kfu_rbf(X, Z, variance, lengthscale)
        psi2, psiY = stat_matmul(Kfu.T, Kfu), stat_matmul(Kfu.T, Y)
    return SuffStats(psi0=X.shape[0] * variance, psi2=psi2, psiY=psiY,
                     yy=(Y * Y).sum(), n=_count(X))


# ---------------------------------------------------------------------------
# expected statistics under q(X) (Bayesian GP-LVM)
# ---------------------------------------------------------------------------

def _psi2_chunk_sum(mu_i, S_i, zbar, l2) -> torch.Tensor:
    """sum over one chunk of exp(lognorm2_n + muterm_n,m,m'): (M, M)."""
    denom = l2[None, :] + 2.0 * S_i
    lognorm = -0.5 * torch.log1p(2.0 * S_i / l2[None, :]).sum(-1)
    M = zbar.shape[0]
    expo = mu_i.new_zeros(mu_i.shape[0], M, M)
    for q in range(mu_i.shape[1]):  # Q is small (latent dim)
        d = mu_i[:, None, None, q] - zbar[None, :, :, q]
        expo = expo - d * d / denom[:, None, None, q]
    return torch.exp(lognorm[:, None, None] + expo).sum(0)


def _psi2_rbf_chunked(mu, S, Z, variance, lengthscale, *,
                      chunk: int = 256) -> torch.Tensor:
    """Psi2 accumulated over N in chunks: O(chunk * M^2) live memory — the
    paper's GPU kernel structure (Table 1) as a plain loop: the (M, M)
    accumulator stays resident while datapoints stream through. Each chunk
    is checkpointed (the reference's `jax.checkpoint`), so a backward pass
    keeps only the chunk's inputs and recomputes its (chunk, M, M)
    intermediates: O(chunk * M^2 + N * Q) saved, not O(N * M^2)."""
    N = mu.shape[0]
    M = Z.shape[0]
    l2 = lengthscale**2
    zdiff = Z[:, None, :] - Z[None, :, :]
    zterm = -(zdiff**2 / (4.0 * l2)).sum(-1)
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    acc = mu.new_zeros(M, M)
    for i in range(0, N, chunk):
        acc = acc + checkpointed(_psi2_chunk_sum, mu[i:i + chunk],
                                 S[i:i + chunk], zbar, l2)
    return variance**2 * torch.exp(zterm) * acc


def expected_stats_rbf(kern_params, mu, S, Y, Z, *, backend: str = "jnp",
                       bwd_backend: str = "auto",
                       psi2_chunk: int = 256) -> SuffStats:
    _check_backend(backend)
    variance = _rbf_variance(kern_params)
    lengthscale = _rbf_lengthscale(kern_params)
    if backend == "fused":
        # one pass over N producing (psi2, psiY) together
        from repro_torch.kernels import ops

        psi2, psiY = ops.suffstats(mu, S, Y, Z, variance, lengthscale,
                                   bwd_backend=bwd_backend)
    elif backend == "pallas":
        # the single-statistic ops, kernelized in both directions; psiY is a
        # plain matrix product outside any kernel, as in the reference
        from repro_torch.kernels import ops

        psi1 = ops.psi1(mu, S, Z, variance, lengthscale,
                        bwd_backend=bwd_backend)
        psi2 = ops.psi2(mu, S, Z, variance, lengthscale,
                        bwd_backend=bwd_backend)
        psiY = stat_matmul(psi1.T, Y)
    else:
        psi1 = ref.psi1_rbf(mu, S, Z, variance, lengthscale)
        psi2 = _psi2_rbf_chunked(mu, S, Z, variance, lengthscale,
                                 chunk=psi2_chunk)
        psiY = stat_matmul(psi1.T, Y)
    return SuffStats(psi0=mu.shape[0] * variance, psi2=psi2, psiY=psiY,
                     yy=(Y * Y).sum(), n=_count(mu))
