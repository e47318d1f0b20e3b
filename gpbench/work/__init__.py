"""The yardstick: an NVIDIA H100's published peaks and the least work of
each part of a training step or state build, as plain functions of
(N, M, Q, D, dtype). A frozen copy of `repro_torch.launch.roofline`'s peaks
and `suffstats_work` / `suffstats_bwd_work` / `kfu_work`, and of the
epilogue, per-point and Adam terms that `repro_torch.launch.cost` reckons;
the benchmark's tests hold them equal to the program's at the cells'
shapes. Later changes to the program do not move them.

Least work: every input read once, every output written once, each
exponential evaluated once, whatever implements it. The exp rule: in
float32 an exp runs on the special-function units beside the FP32 pipes,
so the compute term is the larger of the two; float64 has no exp unit, so
each exp counts as one FP64 operation. Matrix products' multiply-adds
(`mm_flops`, two a multiply-add) run at the product rate of the dtype:
float64's tensor cores (FP64_TENSOR_PER_S), and for float32 the FP32 pipes,
since the program runs its float32 products in IEEE float32, never TF32;
the tensor cores and the FP64 pipes are separate units, so in float64 the
compute term is the larger of the two. The bound is the larger of the
compute term and the HBM bytes over the memory rate.

Parts by model. The Bayesian GP-LVM: B1 (`stats_fwd`), B2 (`stats_bwd`),
`epilogue`, `pointwise`, `adam`; `train_step` and `state_build`. Sparse GP
regression (`backend="pallas"`): B7 (`kfu_fwd`), B6 at S = 0 (`kfu_bwd`),
and the step, `sgpr_train_step`: the exact statistics (`exact_stats`) and
their reverse (`exact_stats_bwd`) counted from X, Y and the cotangents of
psi2 and psiY alone, since K_fu is an intermediate that a path need not
write, plus the epilogue, y . y and Adam.
"""
from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM5 data sheet, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
FP64_PER_S = 34e12
# exp on the special-function units: 16 a clock per SM x 132 SMs x 1.98 GHz
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# dense FP64 tensor-core rate (the data sheet's, without sparsity)
FP64_TENSOR_PER_S = 67e12

ITEMSIZE = {"float32": 4, "float64": 8}


class Work(NamedTuple):
    """Least work: floating-point operations besides the exponentials and
    the matrix products, exponentials, HBM bytes, and the matrix products'
    operations."""
    flops: float
    exps: float
    nbytes: float
    mm_flops: float = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.exps + other.exps,
                    self.nbytes + other.nbytes, self.mm_flops + other.mm_flops)


def bound_s(work: Work, dtype: str) -> float:
    """The least seconds `work` takes on the card: the larger of its
    operations over their peak (the exp rule) and its bytes over HBM's."""
    if ITEMSIZE[dtype] <= 4:
        ops = max((work.flops + work.mm_flops) / FP32_PER_S, work.exps / SFU_EXP_PER_S)
    else:
        ops = max((work.flops + work.exps) / FP64_PER_S, work.mm_flops / FP64_TENSOR_PER_S)
    return max(ops, work.nbytes / HBM_BYTES_PER_S)


def stats_fwd(N, M, Q, D, dtype) -> Work:
    """B1, the fused forward statistics. psi2 is symmetric, so M (M + 1) / 2
    pairs per point need an exp and ~(3Q + 2) flops; psiY needs M exps and
    ~(3Q + 2D) flops per point. Bytes: mu, S, Y, Z, l read, psi2 and psiY
    written once."""
    nbytes = ITEMSIZE[dtype] * (N * (2 * Q + D) + M * Q + Q + M * M + M * D)
    pairs = N * M * (M + 1) // 2
    return Work(pairs * (3 * Q + 2) + N * M * (3 * Q + 2 * D), pairs + N * M, nbytes)


def stats_bwd(N, M, Q, D, dtype) -> Work:
    """B2, the fused reverse pass, each exponential evaluated once: 11Q + 3
    flops and one exp per (point, pair), 10Q + 4D + 2 flops and one exp per
    (point, m). Bytes: mu, S, Y, Z, v, l, g2 and gY read once, dmu, dS, dY,
    dZ, dv and dl written once."""
    nbytes = ITEMSIZE[dtype] * (2 * N * (2 * Q + D) + 2 * M * Q + M * M + M * D
                                + 2 * Q + 2)
    pairs = N * M * (M + 1) // 2
    return Work(pairs * (11 * Q + 3) + N * M * (10 * Q + 4 * D + 2),
                pairs + N * M, nbytes)


def epilogue(M, Q, D, dtype) -> Work:
    """The O(M^3) epilogue of the bound, forward and reverse: two Cholesky
    factors, two M x M triangular solves and the bound's O(M^2 (Q + D))
    terms, ~8 M^3 flops, 2 M^2 exps (K_uu and the psi2 prefactor), ~24
    M x M matrices moved."""
    return Work(8 * M**3 + 6 * M * M * (3 * Q + 2 + D), 2 * M * M,
                ITEMSIZE[dtype] * (24 * M * M + 4 * M * D))


def pointwise(N, Q, D, dtype) -> Work:
    """A training step's per-point work outside the statistics: y . y, S =
    exp(q_logS), the KL and the two cotangents; ~11 elements moved per
    (point, q)."""
    return Work(11 * N * Q + 2 * N * D, N * Q, ITEMSIZE[dtype] * (11 * N * Q + N * D))


def param_count(N, M, Q) -> int:
    """q_mu, q_logS, Z, the kernel's variance and Q lengthscales, log_beta."""
    return 2 * N * Q + M * Q + Q + 2


def adam(n_elements, dtype) -> Work:
    """Adam over `n_elements` parameter elements: 8 elements moved and ~14
    flops each."""
    return Work(14 * n_elements, 0, 8 * ITEMSIZE[dtype] * n_elements)


def build_epilogue(M, Q, D, dtype) -> Work:
    """The refold a served state needs from the statistics (L, LA and
    K_uu^-1 mean_u), forward only: K_uu (M^2 exps, ~3Q + 2 flops an entry),
    two Cholesky factors (M^3 / 3 each), two triangular solves with D
    columns; ~8 M x M matrices moved."""
    return Work(2 * M**3 / 3 + 2 * M * M * D + M * M * (3 * Q + 4), M * M,
                ITEMSIZE[dtype] * (8 * M * M + 3 * M * D))


def build_pointwise(N, Q, D, dtype) -> Work:
    """A build's per-point work outside the statistics: S = exp(q_logS) and
    y . y (Y and q_logS read, S written)."""
    return Work(2 * N * D, N * Q, ITEMSIZE[dtype] * (2 * N * Q + N * D))


def train_step(N, M, Q, D, dtype) -> Work:
    """One full-batch Adam step of the GP-LVM on one card."""
    return (stats_fwd(N, M, Q, D, dtype) + stats_bwd(N, M, Q, D, dtype)
            + epilogue(M, Q, D, dtype) + pointwise(N, Q, D, dtype)
            + adam(param_count(N, M, Q), dtype))


def state_build(N, M, Q, D, dtype) -> Work:
    """One rebuild of the served state from all N points."""
    return (stats_fwd(N, M, Q, D, dtype) + build_epilogue(M, Q, D, dtype)
            + build_pointwise(N, Q, D, dtype))


def kfu_fwd(N, M, Q, D, dtype) -> Work:
    """B7, K_fu (N, M): per (point, m) an exp and ~(3Q + 1) flops. Bytes: X,
    Z, v and l read, K_fu written once, which binds."""
    return Work(N * M * (3 * Q + 1), N * M, ITEMSIZE[dtype] * (N * Q + M * Q + Q + 1 + N * M))


def kfu_bwd(N, M, Q, D, dtype) -> Work:
    """B6 at S = 0, K_fu's reverse pass: per (point, m) an exp and 10Q + 3
    flops (psi1's reverse count: the exponent, W = g v K, and the sums into
    dX, dZ, dv and dl). Bytes: X, Z, v, l and the cotangent (N, M) read
    once, dX, dZ, dv and dl written once; no S."""
    nbytes = ITEMSIZE[dtype] * (2 * N * Q + N * M + 2 * M * Q + 2 * Q + 2)
    return Work(N * M * (10 * Q + 3), N * M, nbytes)


def exact_stats(N, M, Q, D, dtype) -> Work:
    """psi2 = K_fu^T K_fu and psiY = K_fu^T Y from X and Y, K_fu's entries
    made where they are used: K_fu's exps and flops (as `kfu_fwd`), the
    products' multiply-adds, psi2's M (M + 1) / 2 pairs a point (it is
    symmetric) and psiY's M D. Bytes: X, Y, Z, v and l read, psi2 and psiY
    written once."""
    nbytes = ITEMSIZE[dtype] * (N * (Q + D) + M * Q + Q + 1 + M * M + M * D)
    return Work(N * M * (3 * Q + 1), N * M, nbytes, N * M * (M + 1) + 2 * N * M * D)


def exact_stats_bwd(N, M, Q, D, dtype) -> Work:
    """The reverse of `exact_stats` given the cotangents G2 and GY of psi2
    and psiY: K_fu's cotangent K_fu (G2 + G2^T) + Y GY^T (2 N M^2 + 2 N M D
    product operations), then K_fu's reverse (as `kfu_bwd`); X is data and
    gets no cotangent. Bytes: X, Y, Z, v, l, G2 and GY read, dZ, dv and dl
    written once."""
    nbytes = ITEMSIZE[dtype] * (N * (Q + D) + 2 * M * Q + 2 * Q + 2 + M * M + M * D)
    return Work(N * M * (10 * Q + 3), N * M, nbytes, 2 * N * M * M + 2 * N * M * D)


def sgpr_param_count(M, Q) -> int:
    """Z, the kernel's variance and Q lengthscales, log_beta."""
    return M * Q + Q + 2


def sgpr_train_step(N, M, Q, D, dtype) -> Work:
    """One full-batch Adam step of the sparse GP regression on one card:
    the exact statistics and their reverse, the epilogue, y . y (2 N D
    flops, Y read), and Adam."""
    yy = Work(2 * N * D, 0, ITEMSIZE[dtype] * N * D)
    return (exact_stats(N, M, Q, D, dtype) + exact_stats_bwd(N, M, Q, D, dtype)
            + epilogue(M, Q, D, dtype) + yy + adam(sgpr_param_count(M, Q), dtype))
