"""The fused statistics op, differentiable, dispatched by device.

Counterpart of `repro.kernels.ops.suffstats`. The forward sends a CUDA
tensor to the hand-written kernel (`suffstats.suffstats_cuda`) and a CPU
tensor to the plain PyTorch version, for no other reason than that it lies
on the CPU. The backward is picked by `bwd_backend`, as in the reference:

  * ``"auto"``   — the reverse kernel (`suffstats.suffstats_bwd_cuda`) for
    CUDA tensors, the plain reverse pass for CPU tensors;
  * ``"pallas"`` — the reverse kernel only; raises on CPU tensors (a CUDA
    kernel has no interpret mode);
  * ``"jnp"``    — the plain reverse pass on any device.

As in the reference, every input is cast to mu's dtype at the op's
boundary and each cotangent is returned in its own input's dtype. There is
no `block=` and no autotuner yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.suffstats import (suffstats_bwd_cuda, suffstats_cuda,
                                           suffstats_fused_plain,
                                           suffstats_vjp_plain)

BWD_BACKENDS = ("auto", "pallas", "jnp")


def _check_bwd_backend(bwd_backend: str) -> None:
    if bwd_backend not in BWD_BACKENDS:
        raise ValueError(
            f"bwd_backend must be one of {BWD_BACKENDS}, got {bwd_backend!r}")


class _SuffStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Y, Z, variance, lengthscale, bwd_backend):
        inputs = (mu, S, Y, Z, variance, lengthscale)
        ctx.dtypes = [t.dtype for t in inputs]
        ctx.bwd_backend = bwd_backend
        x = [t.to(mu.dtype) for t in inputs]
        ctx.save_for_backward(*x)
        if mu.device.type == "cpu":
            return suffstats_fused_plain(*x)
        return suffstats_cuda(*(t.contiguous() for t in x))

    @staticmethod
    def backward(ctx, g2, gY):
        x = ctx.saved_tensors
        g2, gY = g2.to(x[0].dtype), gY.to(x[0].dtype)
        on_cpu = x[0].device.type == "cpu"
        if ctx.bwd_backend == "jnp" or (ctx.bwd_backend == "auto" and on_cpu):
            grads = suffstats_vjp_plain(*x, g2, gY)
        elif on_cpu:
            raise ValueError(
                "bwd_backend='pallas' needs CUDA tensors: the reverse kernel "
                "has no CPU mode; use 'auto' or 'jnp' on the CPU")
        else:
            grads = suffstats_bwd_cuda(*(t.contiguous() for t in (*x, g2, gY)))
        return (*(g.to(dt) if need else None for g, dt, need in
                  zip(grads, ctx.dtypes, ctx.needs_input_grad)), None)


def suffstats(mu, S, Y, Z, variance, lengthscale, *,
              bwd_backend: str = "auto"):
    """Fused (psi2 (M, M), psiY (M, D)) in one pass over N, in mu's dtype,
    differentiable through the hand-derived reverse pass that
    `bwd_backend` selects."""
    _check_bwd_backend(bwd_backend)
    return _SuffStats.apply(mu, S, Y, Z, variance, lengthscale, bwd_backend)
