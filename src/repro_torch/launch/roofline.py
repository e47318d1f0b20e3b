"""Roofline terms and the kernels' work counts on an NVIDIA H100 (the port's
counterpart of `repro.launch.roofline`).

    compute term    = operations / the card's peak rate for their type
    memory term     = bytes that must move / the HBM rate
    collective term = ring traffic a rank sends / the link rate

Hardware model: NVIDIA H100 SXM5 (80 GB HBM3), the data sheet's peaks at
its 700 W limit. A card set to a lower power limit runs slower under load,
so every measured time this model is held against is reported beside the
card's name and power limit.

Rule for exponentials, as the kernels use them: in float32 an exp runs on
the special-function units (16 results a clock per multiprocessor,
compute capability 9.0) beside the FP32 pipes, so the compute term is the
larger of the two; float64 has no exp unit, so each exp counts as one FP64
operation. Tensor-core peaks (TF32, BF16) bound only matrix products.

Collective bandwidths are documented assumptions, as the reference states
its own: NVLink 4 within a node (900 GB/s a GPU, both directions, so
450 GB/s each way) and 400 Gb/s (50 GB/s) a GPU across nodes; a ring
all-reduce moves 2 (W - 1) / W of its payload through each rank's link.

The work counts of the seven kernels (B1-B7) are plain functions of
(N, M, Q, D, dtype): the least each function must do — every input read
once, every output written once, each exponential evaluated once — which
`chip_smoke.py` holds every kernel's time against and `launch.cost` sums
over a training step.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

__all__ = [
    "HBM_BYTES_PER_S", "FP32_PER_S", "FP64_PER_S", "SFU_EXP_PER_S",
    "TF32_TENSOR_PER_S", "BF16_TENSOR_PER_S", "NVLINK_BYTES_PER_S",
    "INTERNODE_BYTES_PER_S", "Work", "KERNEL_WORK", "bound", "roofline_terms",
    "ring_allreduce_bytes",
    "suffstats_work", "suffstats_bwd_work", "psi2_work", "psi2_bwd_work",
    "psi1_work", "psi1_bwd_work", "kfu_work",
    "bound_ms", "bwd_bound_ms", "psi2_bound_ms", "psi2_bwd_bound_ms",
    "psi1_bound_ms", "psi1_bwd_bound_ms", "kfu_bound_ms",
]

# NVIDIA H100 SXM5 data sheet, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
FP64_PER_S = 34e12
# exp on the special-function units: 16 a clock per SM x 132 SMs x 1.98 GHz
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# dense tensor-core peaks (the data sheet's figures with sparsity, halved)
TF32_TENSOR_PER_S = 494.7e12
BF16_TENSOR_PER_S = 989.4e12
# documented assumptions: NVLink 4 within a node, one way; 400 Gb/s across
NVLINK_BYTES_PER_S = 450e9
INTERNODE_BYTES_PER_S = 50e9


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _float32(dtype: torch.dtype) -> bool:
    return _itemsize(dtype) <= 4


class Work(NamedTuple):
    """Least work of a function: floating-point operations besides the
    exponentials, exponentials, and HBM bytes."""
    flops: float
    exps: float
    nbytes: float


def _compute_s(flops: float, exps: float, dtype: torch.dtype) -> tuple:
    """(seconds, the term that binds) of the operations alone."""
    if _float32(dtype):
        return max((flops / FP32_PER_S, "FP32 flops"),
                   (exps / SFU_EXP_PER_S, "exps on the SFUs"))
    return (flops + exps) / FP64_PER_S, "FP64 flops and exps"


def bound(work: Work, dtype: torch.dtype) -> tuple:
    """(ms, "bytes" or "operations", the term that binds): the larger of
    the bytes over the memory rate and the operations over their peak rate
    (the exp rule of the module docstring)."""
    t_bytes = work.nbytes / HBM_BYTES_PER_S
    t_ops, term = _compute_s(work.flops, work.exps, dtype)
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes", "HBM bytes"
    return 1e3 * t_ops, "operations", term


def roofline_terms(flops: float, exps: float, nbytes: float,
                   collective_bytes: float, dtype: torch.dtype) -> Dict:
    """The three roofline terms of a step (seconds), the dominant one, their
    maximum (the step's lower bound) and compute's share of it.
    `collective_bytes` is the ring traffic a rank sends, over NVLink (the
    ranks of one host)."""
    t_compute, compute_term = _compute_s(flops, exps, dtype)
    t_memory = nbytes / HBM_BYTES_PER_S
    t_coll = collective_bytes / NVLINK_BYTES_PER_S
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    lower = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "compute_term": compute_term,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_lower_bound_s": lower,
        "compute_fraction_of_bound": t_compute / lower if lower > 0 else 0.0,
    }


def ring_allreduce_bytes(payload: float, world: int) -> float:
    """Bytes each rank sends in a ring all-reduce of `payload` bytes over
    `world` ranks, as the reference models it: 2 (W - 1) / W of the
    payload."""
    if world <= 1:
        return 0.0
    return 2 * payload * (world - 1) / world


# ---------------------------------------------------------------------------
# the kernels' work counts
# ---------------------------------------------------------------------------

def suffstats_work(N, M, Q, D, dtype) -> Work:
    """B1, the fused forward. psi2 is symmetric, so M (M + 1) / 2 pairs per
    point need an exp and ~(3Q + 2) flops; psiY needs M exps and
    ~(3Q + 2D) flops per point. Bytes: mu, S, Y, Z, l read, psi2 and psiY
    written once."""
    nbytes = _itemsize(dtype) * (N * (2 * Q + D) + M * Q + Q + M * M + M * D)
    pairs = N * M * (M + 1) // 2
    return Work(pairs * (3 * Q + 2) + N * M * (3 * Q + 2 * D), pairs + N * M, nbytes)


def suffstats_bwd_work(N, M, Q, D, dtype) -> Work:
    """B2, the fused reverse pass, each exponential evaluated once. Per
    (point, pair): the exponent, d = mu - zbar, d^2 r and its sum (4Q);
    T = Gw E and t += T (2); sd += T d and sv += (T d) d (4Q); P += E (1);
    A_q += (E r_q) d_q (3Q): 11Q + 3 flops and one exp. Per (point, m):
    the exponent (4Q), y . gyv (2D), W1 = (y . gyv) K, s1 += W1 (2),
    s1d += W1 d and s1v += (W1 d) d (4Q), dY += K gyv (2D), dz1 += (W1 d) b
    (2Q): 10Q + 4D + 2 flops and one exp. The O(N Q) per-point terms are
    left out (< 0.1 %). Bytes: mu, S, Y, Z, v, l, g2 and gY read once, dmu,
    dS, dY, dZ, dv and dl written once."""
    nbytes = _itemsize(dtype) * (2 * N * (2 * Q + D) + 2 * M * Q + M * M + M * D
                                 + 2 * Q + 2)
    pairs = N * M * (M + 1) // 2
    return Work(pairs * (11 * Q + 3) + N * M * (10 * Q + 4 * D + 2),
                pairs + N * M, nbytes)


def psi2_work(N, M, Q, D, dtype) -> Work:
    """B3, psi2 alone: M (M + 1) / 2 pairs per point, an exp and ~(3Q + 2)
    flops each. Bytes: mu, S, Z, v and l read, psi2 written once."""
    nbytes = _itemsize(dtype) * (2 * N * Q + M * Q + Q + 1 + M * M)
    pairs = N * M * (M + 1) // 2
    return Work(pairs * (3 * Q + 2), pairs, nbytes)


def psi2_bwd_work(N, M, Q, D, dtype) -> Work:
    """B4, psi2's reverse pass: B2's (point, pair) work without its
    (point, m) terms, 11Q + 3 flops a pair. Bytes: mu, S, Z, v, l and g2
    read; dmu, dS, dZ, dv and dl written once."""
    nbytes = _itemsize(dtype) * (4 * N * Q + 2 * M * Q + M * M + 2 * Q + 2)
    pairs = N * M * (M + 1) // 2
    return Work(pairs * (11 * Q + 3), pairs, nbytes)


def psi1_work(N, M, Q, D, dtype) -> Work:
    """B5, psi1: per (point, m) an exp and ~(3Q + 2) flops. Bytes: mu, S, Z,
    v and l read, psi1 (N, M) written once, which binds."""
    nbytes = _itemsize(dtype) * (2 * N * Q + M * Q + Q + 1 + N * M)
    return Work(N * M * (3 * Q + 2), N * M, nbytes)


def psi1_bwd_work(N, M, Q, D, dtype) -> Work:
    """B6, psi1's reverse pass (K_fu's at S = 0): per (point, m) an exp and
    the exponent (4Q), W1 = g v K (2), s1 += W1 (1), s1d += W1 d and
    s1v += (W1 d) d (4Q), dZ += (W1 d) b (2Q): 10Q + 3 flops. Bytes: mu, S,
    Z, v, l and g (N, M) read, dmu, dS, dZ, dv and dl written once."""
    nbytes = _itemsize(dtype) * (4 * N * Q + N * M + 2 * M * Q + 2 * Q + 2)
    return Work(N * M * (10 * Q + 3), N * M, nbytes)


def kfu_work(N, M, Q, D, dtype) -> Work:
    """B7, K_fu: per (point, m) an exp and ~(3Q + 1) flops. Bytes: X, Z, v
    and l read, K_fu (N, M) written once, which binds."""
    nbytes = _itemsize(dtype) * (N * Q + M * Q + Q + 1 + N * M)
    return Work(N * M * (3 * Q + 1), N * M, nbytes)


# library (csrc/<lib>.cu) -> its work count
KERNEL_WORK: Dict[str, Callable[..., Work]] = {
    "suffstats_fwd": suffstats_work, "suffstats_bwd": suffstats_bwd_work,
    "psi2_fwd": psi2_work, "psi2_bwd": psi2_bwd_work,
    "psi1_fwd": psi1_work, "psi1_bwd": psi1_bwd_work, "kfu_fwd": kfu_work,
}


def bound_ms(N, M, Q, D, dtype) -> tuple:
    """B1's bound: (ms, "bytes" or "operations", the term that binds)."""
    return bound(suffstats_work(N, M, Q, D, dtype), dtype)


def bwd_bound_ms(N, M, Q, D, dtype) -> tuple:
    """B2's bound."""
    return bound(suffstats_bwd_work(N, M, Q, D, dtype), dtype)


def psi2_bound_ms(N, M, Q, D, dtype) -> tuple:
    """B3's bound."""
    return bound(psi2_work(N, M, Q, D, dtype), dtype)


def psi2_bwd_bound_ms(N, M, Q, D, dtype) -> tuple:
    """B4's bound."""
    return bound(psi2_bwd_work(N, M, Q, D, dtype), dtype)


def psi1_bound_ms(N, M, Q, D, dtype) -> tuple:
    """B5's bound."""
    return bound(psi1_work(N, M, Q, D, dtype), dtype)


def psi1_bwd_bound_ms(N, M, Q, D, dtype) -> tuple:
    """B6's bound."""
    return bound(psi1_bwd_work(N, M, Q, D, dtype), dtype)


def kfu_bound_ms(N, M, Q, D, dtype) -> tuple:
    """B7's bound."""
    return bound(kfu_work(N, M, Q, D, dtype), dtype)
