"""The differentiable statistics ops, dispatched by device.

Counterpart of `repro.kernels.ops`: the fused `suffstats` op and the
single-statistic ops `kfu`, `psi1` and `psi2`. Each forward sends a CUDA
tensor to its hand-written kernel (`suffstats.suffstats_cuda`,
`kfu.kfu_cuda`, `psi1.psi1_cuda`, `psi2.psi2_cuda`) and a CPU tensor to the
plain PyTorch version, for no other reason than that it lies on the CPU.
The backward is picked by `bwd_backend`, as in the reference:

  * ``"auto"``   — the reverse kernel (`suffstats.suffstats_bwd_cuda`,
    `suffstats.kfu_bwd_cuda`, `suffstats.psi1_bwd_cuda`,
    `suffstats.psi2_bwd_cuda`) for CUDA tensors, the plain reverse pass for
    CPU tensors;
  * ``"pallas"`` — the reverse kernel only; raises on CPU tensors (a CUDA
    kernel has no interpret mode);
  * ``"jnp"``    — the plain reverse pass on any device.

Each op saves only its inputs. As in the reference, every input is cast to
the first input's dtype (mu's, or X's for `kfu`) at the op's boundary and each cotangent is returned in its own
input's dtype. There is no `block=` and no autotuner yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kfu import kfu_cuda, kfu_plain
from repro_torch.kernels.psi1 import psi1_cuda, psi1_plain
from repro_torch.kernels.psi2 import psi2_cuda, psi2_plain
from repro_torch.kernels.suffstats import (kfu_bwd_cuda, kfu_vjp_plain,
                                           psi1_bwd_cuda, psi1_vjp_plain,
                                           psi2_bwd_cuda, psi2_vjp_plain,
                                           suffstats_bwd_cuda, suffstats_cuda,
                                           suffstats_fused_plain,
                                           suffstats_vjp_plain)

BWD_BACKENDS = ("auto", "pallas", "jnp")


def _check_bwd_backend(bwd_backend: str) -> None:
    if bwd_backend not in BWD_BACKENDS:
        raise ValueError(
            f"bwd_backend must be one of {BWD_BACKENDS}, got {bwd_backend!r}")


def _forward(ctx, inputs, bwd_backend, plain, kernel):
    """Save the inputs cast to mu's dtype, then run the plain version on
    CPU tensors and the kernel on CUDA tensors."""
    ctx.dtypes = [t.dtype for t in inputs]
    ctx.bwd_backend = bwd_backend
    x = [t.to(inputs[0].dtype) for t in inputs]
    ctx.save_for_backward(*x)
    if x[0].device.type == "cpu":
        return plain(*x)
    return kernel(*(t.contiguous() for t in x))


def _backward(ctx, cotangents, plain, kernel):
    """The reverse pass `bwd_backend` picks, each cotangent in its input's
    dtype (None where no gradient is needed), plus None for the knob."""
    x = ctx.saved_tensors
    g = [c.to(x[0].dtype) for c in cotangents]
    on_cpu = x[0].device.type == "cpu"
    if ctx.bwd_backend == "jnp" or (ctx.bwd_backend == "auto" and on_cpu):
        grads = plain(*x, *g)
    elif on_cpu:
        raise ValueError(
            "bwd_backend='pallas' needs CUDA tensors: the reverse kernel "
            "has no CPU mode; use 'auto' or 'jnp' on the CPU")
    else:
        grads = kernel(*(t.contiguous() for t in (*x, *g)))
    return (*(gr.to(dt) if need else None for gr, dt, need in
              zip(grads, ctx.dtypes, ctx.needs_input_grad)), None)


# The kernel functions are looked up in this module's namespace at call
# time, so a caller that replaces one (to watch its arguments) is obeyed.

class _SuffStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Y, Z, variance, lengthscale, bwd_backend):
        return _forward(ctx, (mu, S, Y, Z, variance, lengthscale), bwd_backend,
                        suffstats_fused_plain, suffstats_cuda)

    @staticmethod
    def backward(ctx, g2, gY):
        return _backward(ctx, (g2, gY), suffstats_vjp_plain, suffstats_bwd_cuda)


class _Kfu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, X, Z, variance, lengthscale, bwd_backend):
        return _forward(ctx, (X, Z, variance, lengthscale), bwd_backend,
                        kfu_plain, kfu_cuda)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, (g,), kfu_vjp_plain, kfu_bwd_cuda)


class _Psi1(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Z, variance, lengthscale, bwd_backend):
        return _forward(ctx, (mu, S, Z, variance, lengthscale), bwd_backend,
                        psi1_plain, psi1_cuda)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, (g,), psi1_vjp_plain, psi1_bwd_cuda)


class _Psi2(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Z, variance, lengthscale, bwd_backend):
        return _forward(ctx, (mu, S, Z, variance, lengthscale), bwd_backend,
                        psi2_plain, psi2_cuda)

    @staticmethod
    def backward(ctx, g2):
        return _backward(ctx, (g2,), psi2_vjp_plain, psi2_bwd_cuda)


def suffstats(mu, S, Y, Z, variance, lengthscale, *,
              bwd_backend: str = "auto"):
    """Fused (psi2 (M, M), psiY (M, D)) in one pass over N, in mu's dtype,
    differentiable through the hand-derived reverse pass that
    `bwd_backend` selects."""
    _check_bwd_backend(bwd_backend)
    return _SuffStats.apply(mu, S, Y, Z, variance, lengthscale, bwd_backend)


def kfu(X, Z, variance, lengthscale, *, bwd_backend: str = "auto"):
    """RBF cross covariance K_fu (N, M) in X's dtype, differentiable through
    the hand-derived reverse pass that `bwd_backend` selects (psi1's at
    S = 0: the psi1 reverse kernel on the card)."""
    _check_bwd_backend(bwd_backend)
    return _Kfu.apply(X, Z, variance, lengthscale, bwd_backend)


def psi1(mu, S, Z, variance, lengthscale, *, bwd_backend: str = "auto"):
    """Psi1 statistic (N, M) in mu's dtype, differentiable through the
    hand-derived reverse pass that `bwd_backend` selects (eq. (10)-(14),
    branch weight W1 = g psi1)."""
    _check_bwd_backend(bwd_backend)
    return _Psi1.apply(mu, S, Z, variance, lengthscale, bwd_backend)


def psi2(mu, S, Z, variance, lengthscale, *, bwd_backend: str = "auto"):
    """Psi2 statistic (M, M) in mu's dtype, differentiable through the
    hand-derived reverse pass that `bwd_backend` selects (the fused op's
    psi2 branch alone: eq. (9), (15)-(20))."""
    _check_bwd_backend(bwd_backend)
    return _Psi2.apply(mu, S, Z, variance, lengthscale, bwd_backend)
