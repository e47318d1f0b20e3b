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
its own: an H100 SXM node holds 8 GPUs joined by NVLink 4 (900 GB/s a GPU,
both directions, so 450 GB/s each way); across nodes each GPU has 400 Gb/s
(50 GB/s). Ranks are numbered row-major over the mesh (as `launch.mesh.
make_mesh` numbers them) and fill nodes in order, so a group whose ranks
all lie in one node of 8 runs at the NVLink rate and any other group at
the rate between nodes. Each collective moves, through each rank's link,
what the reference's ring model says (`ring_traffic`): all-gather
out (P - 1) / P, reduce-scatter out (P - 1), all-reduce 2 bytes (P - 1) / P,
all-to-all bytes (P - 1) / P, a permute its bytes.

An LM step's compute term (`lm_roofline_terms`) splits its operations:
matrix products run on the tensor cores at the product's dtype (bf16 and
f16 at the dense BF16 peak; float32 at the FP32 SIMT rate, since the
port leaves TF32 off and `chip_smoke.py` asserts it; float64 on the FP64
tensor cores), every other operation at the SIMT rate of its dtype
(float64's FP64 rate; any other dtype's FP32 rate: PyTorch's elementwise
kernels compute half types in float32). The products and the rest run
one after another in an eager step, so their times add.

The work counts of the seven kernels (B1-B7) are plain functions of
(N, M, Q, D, dtype): the least each function must do — every input read
once, every output written once, each exponential evaluated once — which
`chip_smoke.py` holds every kernel's time against and `launch.cost` sums
over a training step.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, NamedTuple

import torch

__all__ = [
    "HBM_BYTES_PER_S", "FP32_PER_S", "FP64_PER_S", "SFU_EXP_PER_S",
    "TF32_TENSOR_PER_S", "BF16_TENSOR_PER_S", "NVLINK_BYTES_PER_S",
    "INTERNODE_BYTES_PER_S", "Work", "KERNEL_WORK", "bound", "roofline_terms",
    "ring_allreduce_bytes", "FP64_TENSOR_PER_S", "GPUS_PER_NODE", "matmul_rate",
    "simt_rate", "link_of", "LINK_BYTES_PER_S", "ring_traffic", "lm_roofline_terms",
    "count_params", "model_flops",
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
FP64_TENSOR_PER_S = 67e12
# documented assumptions: NVLink 4 within a node, one way; 400 Gb/s across
NVLINK_BYTES_PER_S = 450e9
INTERNODE_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8
LINK_BYTES_PER_S = {"nvlink": NVLINK_BYTES_PER_S, "network": INTERNODE_BYTES_PER_S}


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


# ---------------------------------------------------------------------------
# the LM side: a step's roofline terms from its counted operations
# (`launch.cost.lower`), and the reference's parameter and model-flop counts
# ---------------------------------------------------------------------------

def matmul_rate(dtype: torch.dtype) -> float:
    """Peak operations a second of a matrix product in `dtype` (module
    docstring)."""
    if dtype in (torch.bfloat16, torch.float16):
        return BF16_TENSOR_PER_S
    if dtype == torch.float64:
        return FP64_TENSOR_PER_S
    return FP32_PER_S


def simt_rate(dtype: torch.dtype) -> float:
    """Peak operations a second of any other operation in `dtype`."""
    return FP64_PER_S if dtype == torch.float64 else FP32_PER_S


def link_of(ranks: Iterable[int]) -> str:
    """"nvlink" for a group whose ranks all lie in one node of
    `GPUS_PER_NODE` (ranks fill nodes in order), else "network"."""
    return "nvlink" if len({r // GPUS_PER_NODE for r in ranks}) <= 1 else "network"


def ring_traffic(kind: str, nbytes: float, P: int) -> float:
    """Bytes a rank moves in one collective of `kind` whose result is
    `nbytes`, over a group of P ranks (the reference's ring model,
    `repro.launch.roofline`'s docstring)."""
    if P <= 1:
        return 0.0
    frac = (P - 1) / P
    if kind == "all-gather":
        return nbytes * frac
    if kind == "reduce-scatter":
        return nbytes * (P - 1)
    if kind == "all-reduce":
        return 2 * nbytes * frac
    if kind == "all-to-all":
        return nbytes * frac
    return float(nbytes)  # a permute or a broadcast: its bytes


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def lm_roofline_terms(matmul_flops: Dict, other_flops: Dict, nbytes: float,
                      traffic: Dict[str, float]) -> Dict:
    """The reference's roofline terms of an LM step (seconds; the keys of
    `repro.launch.roofline.roofline_terms`) on the H100: `matmul_flops` and
    `other_flops` map a dtype (or its name) to the operations done in it;
    `traffic` maps a link ("nvlink" or "network") to the ring bytes a rank
    moves over it. Adds "t_matmul_s" and "t_other_s", the compute term's
    two parts."""
    t_mm = sum(f / matmul_rate(_dtype(d)) for d, f in matmul_flops.items())
    t_other = sum(f / simt_rate(_dtype(d)) for d, f in other_flops.items())
    t_compute = t_mm + t_other
    t_memory = nbytes / HBM_BYTES_PER_S
    t_coll = sum(b / LINK_BYTES_PER_S[link] for link, b in traffic.items())
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    lower = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_lower_bound_s": lower,
        "compute_fraction_of_bound": t_compute / lower if lower > 0 else 0.0,
        "t_matmul_s": t_mm,
        "t_other_s": t_other,
    }


def count_params(tree) -> int:
    """Elements of every tensor in `tree` (a parameter tree, on any
    device: the meta device's stand-ins count the same)."""
    from repro_torch.parallel.sharding import leaves_with_path

    return int(sum(t.numel() for _, t in leaves_with_path(tree)))


def model_flops(cfg, params_tree, n_tokens: int) -> Dict[str, float]:
    """The reference's MODEL_FLOPS = 6 N D: N the non-embedding parameters
    (the embedding table and the unembedding left out; a MoE expert weight
    scaled by top-k over the expert count, the active share), D the tokens
    processed. Exact, from the parameter tree (paths "/"-joined as the
    reference joins its keys: "seg0/0/moe/w_gate")."""
    from repro_torch.parallel.sharding import leaves_with_path

    total = 0.0
    active = 0.0
    moe_scale = (cfg.num_experts_per_tok / cfg.num_experts) if cfg.num_experts else 1.0
    for p, leaf in leaves_with_path(params_tree):
        n = float(leaf.numel())
        if "embed/table" in p or "unembed" in p:
            continue  # embedding lookups are not matmul FLOPs
        total += n
        if re.search(r"moe/w_(gate|up|down)", p):
            active += n * moe_scale
        else:
            active += n
    return {
        "n_params_nonembed": total,
        "n_params_active": active,
        "model_flops": 6.0 * active * n_tokens,
    }
