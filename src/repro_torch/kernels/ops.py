"""The fused statistics op, dispatched by device.

Counterpart of `repro.kernels.ops.suffstats`, forward only for now: a
CUDA tensor goes to the hand-written kernel (`suffstats.suffstats_cuda`),
a CPU tensor to the plain PyTorch version — for no other reason than that
it lies on the CPU. The result is not differentiable: the reverse kernel
(`suffstats_bwd_pallas`'s port) comes with the training slice, so a
backward through this op raises rather than quietly differentiating the
plain version.

`bwd_backend` is accepted and validated as in `repro.kernels.ops` so call
sites keep their shape; there is no `block=` and no autotuner yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.suffstats import suffstats_cuda, suffstats_fused_plain

BWD_BACKENDS = ("auto", "pallas", "jnp")


def _check_bwd_backend(bwd_backend: str) -> None:
    if bwd_backend not in BWD_BACKENDS:
        raise ValueError(
            f"bwd_backend must be one of {BWD_BACKENDS}, got {bwd_backend!r}")


class _SuffStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Y, Z, variance, lengthscale):
        if mu.device.type == "cpu":
            return suffstats_fused_plain(mu, S, Y, Z, variance, lengthscale)
        return suffstats_cuda(mu.contiguous(), S.contiguous(), Y.contiguous(),
                              Z.contiguous(), variance, lengthscale)

    @staticmethod
    def backward(ctx, g2, gY):
        raise NotImplementedError(
            "repro_torch.kernels.ops.suffstats is forward-only: its reverse "
            "kernel (the port of suffstats_bwd_pallas) comes with the "
            "training slice")


def suffstats(mu, S, Y, Z, variance, lengthscale, *,
              bwd_backend: str = "auto"):
    """Fused (psi2 (M, M), psiY (M, D)) in one pass over N: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_bwd_backend(bwd_backend)
    return _SuffStats.apply(mu, S, Y, Z, variance, lengthscale)
