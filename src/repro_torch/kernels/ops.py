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
the first input's dtype (mu's, or X's for `kfu`) at the op's boundary and
each cotangent is returned in its own input's dtype. The kernels take
float32 and float64; half-precision inputs (bfloat16, float16) on the card
go through them in float32 and come back in their own dtypes, the
reference's compiled policy (its kernels compute in float32).

Launch geometry: `block=` / `bwd_block=` (the reference's names) pin the
forward / reverse kernel's N-split count, as a number of waves of the
card's resident blocks (`repro_torch.tune.search`); `None` consults
`tune.best_blocks` for that direction under the reference's kernel name
(`suffstats_pallas`, `suffstats_bwd_pallas`, `kfu_pallas`, `psi1_pallas`,
`psi1_bwd_pallas` — K_fu's reverse too —, `psi2_pallas`,
`psi2_bwd_pallas`), at the moment the kernel launches. With tuning off
and nothing cached that is one wave, the split counts of an untuned
launch. The CPU path has no grid: it never consults the tuner and ignores
a pinned value.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def _check_block(block, what: str) -> Optional[int]:
    if block is None:
        return None
    if isinstance(block, bool) or not isinstance(block, int) or block < 1:
        raise ValueError(f"{what} must be None or a positive int (waves of "
                         f"the card's resident blocks), got {block!r}")
    return block


class _Knobs(NamedTuple):
    """An op's static knobs: the reverse-pass choice, the tuner's names of
    its forward and reverse kernels, the pinned wave counts (None: ask the
    tuner) and M for the tuner's key."""
    bwd_backend: str
    fwd_name: str
    bwd_name: str
    block: Optional[int]
    bwd_block: Optional[int]
    m: int


def _knobs(bwd_backend, fwd_name, bwd_name, block, bwd_block, Z) -> _Knobs:
    _check_bwd_backend(bwd_backend)
    return _Knobs(bwd_backend, fwd_name, bwd_name, _check_block(block, "block"),
                  _check_block(bwd_block, "bwd_block"), int(Z.shape[0]))


_HALF = (torch.bfloat16, torch.float16)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in _HALF else dtype


def _waves(name: str, block: Optional[int], x: torch.Tensor, m: int) -> int:
    """The wave count of a launch on x's card: `block` if pinned, else the
    tuner's winner for `name` at (dtype, M, Q), else one wave."""
    if block is not None:
        return block
    from repro_torch import tune  # tune measures through these wrappers

    win = tune.best_blocks(name, dtype=_compute_dtype(x.dtype), m=m,
                           q=x.shape[1], device=x.device)
    return tune.DEFAULT_WAVES if win is None else win


def _on_card(kernel, tensors, dtype, waves: int):
    """`kernel` on the card's tensors in the dtype it computes in (float32
    for half inputs) at `waves`, each output cast back to `dtype`."""
    ct = _compute_dtype(dtype)
    out = kernel(*(t.to(ct).contiguous() for t in tensors), waves=waves)
    if ct == dtype:
        return out
    if isinstance(out, tuple):
        return tuple(o.to(dtype) for o in out)
    return out.to(dtype)


def _forward(ctx, inputs, knobs: _Knobs, plain, kernel):
    """Save the inputs cast to mu's dtype, then run the plain version on
    CPU tensors and the kernel on CUDA tensors."""
    ctx.dtypes = [t.dtype for t in inputs]
    ctx.knobs = knobs
    x = [t.to(inputs[0].dtype) for t in inputs]
    ctx.save_for_backward(*x)
    if x[0].device.type == "cpu":
        return plain(*x)
    return _on_card(kernel, x, x[0].dtype,
                    _waves(knobs.fwd_name, knobs.block, x[0], knobs.m))


def _backward(ctx, cotangents, plain, kernel):
    """The reverse pass `bwd_backend` picks, each cotangent in its input's
    dtype (None where no gradient is needed), plus None for the knobs."""
    x = ctx.saved_tensors
    knobs = ctx.knobs
    g = [c.to(x[0].dtype) for c in cotangents]
    on_cpu = x[0].device.type == "cpu"
    if knobs.bwd_backend == "jnp" or (knobs.bwd_backend == "auto" and on_cpu):
        grads = plain(*x, *g)
    elif on_cpu:
        raise ValueError(
            "bwd_backend='pallas' needs CUDA tensors: the reverse kernel "
            "has no CPU mode; use 'auto' or 'jnp' on the CPU")
    else:
        grads = _on_card(kernel, (*x, *g), x[0].dtype,
                         _waves(knobs.bwd_name, knobs.bwd_block, x[0], knobs.m))
    return (*(gr.to(dt) if need else None for gr, dt, need in
              zip(grads, ctx.dtypes, ctx.needs_input_grad)), None)


# The kernel functions are looked up in this module's namespace at call
# time, so a caller that replaces one (to watch its arguments) is obeyed.

class _SuffStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Y, Z, variance, lengthscale, knobs):
        return _forward(ctx, (mu, S, Y, Z, variance, lengthscale), knobs,
                        suffstats_fused_plain, suffstats_cuda)

    @staticmethod
    def backward(ctx, g2, gY):
        return _backward(ctx, (g2, gY), suffstats_vjp_plain, suffstats_bwd_cuda)


class _Kfu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, X, Z, variance, lengthscale, knobs):
        return _forward(ctx, (X, Z, variance, lengthscale), knobs,
                        kfu_plain, kfu_cuda)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, (g,), kfu_vjp_plain, kfu_bwd_cuda)


class _Psi1(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Z, variance, lengthscale, knobs):
        return _forward(ctx, (mu, S, Z, variance, lengthscale), knobs,
                        psi1_plain, psi1_cuda)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, (g,), psi1_vjp_plain, psi1_bwd_cuda)


class _Psi2(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, S, Z, variance, lengthscale, knobs):
        return _forward(ctx, (mu, S, Z, variance, lengthscale), knobs,
                        psi2_plain, psi2_cuda)

    @staticmethod
    def backward(ctx, g2):
        return _backward(ctx, (g2,), psi2_vjp_plain, psi2_bwd_cuda)


def suffstats(mu, S, Y, Z, variance, lengthscale, *,
              bwd_backend: str = "auto", block: Optional[int] = None,
              bwd_block: Optional[int] = None):
    """Fused (psi2 (M, M), psiY (M, D)) in one pass over N, in mu's dtype,
    differentiable through the hand-derived reverse pass that
    `bwd_backend` selects. `block` / `bwd_block` pin the forward / reverse
    kernel's waves; None consults the tuner."""
    knobs = _knobs(bwd_backend, "suffstats_pallas", "suffstats_bwd_pallas",
                   block, bwd_block, Z)
    return _SuffStats.apply(mu, S, Y, Z, variance, lengthscale, knobs)


def kfu(X, Z, variance, lengthscale, *, bwd_backend: str = "auto",
        block: Optional[int] = None, bwd_block: Optional[int] = None):
    """RBF cross covariance K_fu (N, M) in X's dtype, differentiable through
    the hand-derived reverse pass that `bwd_backend` selects (psi1's at
    S = 0: the psi1 reverse kernel on the card, so its tuner key is
    `psi1_bwd_pallas`). `block` / `bwd_block` pin the waves; None consults
    the tuner."""
    knobs = _knobs(bwd_backend, "kfu_pallas", "psi1_bwd_pallas", block,
                   bwd_block, Z)
    return _Kfu.apply(X, Z, variance, lengthscale, knobs)


def psi1(mu, S, Z, variance, lengthscale, *, bwd_backend: str = "auto",
         block: Optional[int] = None, bwd_block: Optional[int] = None):
    """Psi1 statistic (N, M) in mu's dtype, differentiable through the
    hand-derived reverse pass that `bwd_backend` selects (eq. (10)-(14),
    branch weight W1 = g psi1). `block` / `bwd_block` pin the waves; None
    consults the tuner."""
    knobs = _knobs(bwd_backend, "psi1_pallas", "psi1_bwd_pallas", block,
                   bwd_block, Z)
    return _Psi1.apply(mu, S, Z, variance, lengthscale, knobs)


def psi2(mu, S, Z, variance, lengthscale, *, bwd_backend: str = "auto",
         block: Optional[int] = None, bwd_block: Optional[int] = None):
    """Psi2 statistic (M, M) in mu's dtype, differentiable through the
    hand-derived reverse pass that `bwd_backend` selects (the fused op's
    psi2 branch alone: eq. (9), (15)-(20)). `block` / `bwd_block` pin the
    waves; None consults the tuner."""
    knobs = _knobs(bwd_backend, "psi2_pallas", "psi2_bwd_pallas", block,
                   bwd_block, Z)
    return _Psi2.apply(mu, S, Z, variance, lengthscale, knobs)
