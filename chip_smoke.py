#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, data-parallel,
persistence, tuning and analysis paths, the reference's GP-LVM dry run,
the dense LM (smollm-360m at full width), every other LM family at full
width, the LM over a device mesh and the LM dry run, on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result):

1. Device: a CUDA device is required (no CPU fallback); prints
   `nvidia-smi --query-gpu=name,power.limit` for the card.
2. Build: every kernel library (the fused forward and reverse
   psi-statistics kernels B1 and B2, and the single-statistic kernels B3
   psi2, B4 its reverse, B5 psi1, B6 its reverse, B7 K_fu) is compiled from
   `src/repro_torch/kernels/csrc` (one nvcc per source, all at once) into
   `build/`. PyTorch's float32 matrix products must not use TF32.
3. Kernels vs plain versions on the card, at the paper's shape
   (N = 1,000,003, M = 100, Q = 1, D = 3) and at N = 100,003, M = 256,
   Q = 4, D = 5, each with S > 0 (GP-LVM) and S = 0 (SGPR): the forward
   kernel against `suffstats_fused_plain`, the reverse kernel against
   `suffstats_vjp_plain` with random output cotangents. Float64 kernels
   within 1e-10 and float32 kernels within 1e-4 of the float64 plain
   version, relative to max|plain| per output; two kernel runs bitwise
   equal. The same for B3-B6 at both shapes with S > 0 (`psi2_plain`,
   `psi2_vjp_plain`, `psi1_plain`, `psi1_vjp_plain`, random output
   cotangents), and for B5 and B6 also at S = 0; B7 against `kfu_plain`
   and K_fu's reverse pass (B6 at S = 0, `kfu_bwd_cuda`) against
   `kfu_vjp_plain` at both shapes.
4. Serving at the paper's §4 scale (N = 1e6, M = 100, Q = 1, D = 3; data
   and parameters from a numpy seed): a GP-LVM state from q(X) and an SGPR
   state from (X, Y), built through `suff_stats(backend="fused")`, served
   by `GPServer(device="cuda")`: predict at B in {1, 16, 256, 300} (diag
   and full covariance), eight concurrent submits, update with 65,536 new
   points and downdate of the same. The float64 run is held to the same
   steps through the plain statistics path (backend="jnp") on the card;
   the float32 run to the float64 one. The kernel's launch count over each
   run must be > 0.
5. Training at the paper's shape, in float32 and float64: a
   `BayesianGPLVM` fitted to the GP-LVM data's Y and a
   `SparseGPRegression` fitted to the SGPR data's (X, Y), each from its
   own init, 10 Adam steps through backend="fused". Losses finite and the
   last below the first; each step launches the forward and the reverse
   kernel once; each float32 fit makes at least 80 % of the float64 fit's
   descent, judged by the float64 loss. The float64 GP-LVM's reverse kernel
   is held against the plain reverse pass (bwd_backend="jnp", on the card)
   and both against an extended-precision reverse pass on the loss's own
   cotangents, at the facade's init and on a well-conditioned grid; on the
   grid its gradients and 3-step trajectory are held to the plain one's,
   from the init they are traced. Each fitted model is then registered
   with a `GPServer`, served at B = 1 and 256 and touched up with `refit`
   (loss non-increasing).
6. The GP-LVM through backend="pallas" (this slice's main path): a
   `BayesianGPLVM(backend="pallas")` fitted from its own init at the
   paper's shape, 10 Adam steps in float32 and float64. Losses finite and
   the last below the first; each step launches B5, B3, B6 and B4 once and
   the fused kernels never; the float32 fit makes at least 80 % of the
   float64 fit's descent. Each fitted model is registered with a
   `GPServer`, served at B = 1 and 256 and refitted. In float64, at the
   same parameters, the pallas loss and gradients against
   backend="fused": held on the well-conditioned grid (loss within 1e-10,
   each gradient leaf within 1e-8, every leaf float64), printed from the
   init.
7. The SGPR through backend="pallas": a `SparseGPRegression(
   backend="pallas")` fitted from its own init to the SGPR data at the
   paper's shape, 10 Adam steps in float32 and float64. Losses finite and
   the last below the first; each step launches B7 and B6 once and B1-B5
   never; the float32 fit makes at least 80 % of the float64 fit's
   descent; each fitted model is served and refitted. In float64 on the
   grid, the loss within 1e-10 of backend="fused" and each gradient leaf
   within 1e-8 (printed, not held, from the init).
8. The data-parallel path (`mesh=`) on the one card: two spawned ranks,
   both on cuda:0, in a gloo group (NCCL refuses two ranks on one card).
   Each evaluates `sgpr_loss_dist` through "pallas" at the paper's shape
   in float64 on the grid, held to the single-process loss (1e-10) and
   gradients (1e-8, the same bits on both ranks); then 3 Adam steps of the
   `mesh=` facade, after which the global parameters are bitwise equal on
   both ranks. Then one rank in an NCCL group fits one step. Every child
   is joined with a timeout; a child's failure fails the run.
9. Float32 repeatability: each facade x backend fitted at the paper's
   shape in float32 from its own init, twice in this process from one init
   and once in a fresh spawned process; inits, fitted parameters and
   logged losses must be bitwise equal (where they are not, a fresh process
   fits them again under torch.use_deterministic_algorithms(True) with
   CUBLAS_WORKSPACE_CONFIG set, to name the op).
10. Every kernel at Q = 20 (N = 20,000, M = 64) against its plain version,
   both dtypes, two launches bitwise equal; then bfloat16 and float16
   inputs through ops.suffstats, psi1, psi2 and kfu, forward and reverse,
   through the kernels in float32, against the float32 plain versions.
11. The kernel family in float64 at the paper's shape: a `BayesianGPLVM`
   with `Product(RBF, RBF)` through backend="fused" and then "pallas", 5
   Adam steps each from the grid's parameters split over the two parts;
   each step launches B1 and B2 (B5, B3, B6 and B4) once and no other
   kernel; on the grid the loss is held within 1e-10 and every gradient
   leaf within 1e-8 of a single RBF at the equivalent hyperparameters
   (printed after the fit). Then `Sum(RBF, Linear)` in a `BayesianGPLVM`
   and `Matern32` in a `SparseGPRegression` through "jnp", 3 steps each
   from their own init (finite losses, the last below the first, no
   kernel launched); every fitted model served at B = 1 and 256 and
   refitted.
12. The temporal backend: `regression(Matern32(1), backend="temporal")`
   fitted on the temporal quickstart's series at N = 1e6 (float64
   timestamps), 10 Adam steps on the parallel path (finite, the last
   below the first), its peak device memory held under 256 float64
   (d, d) matrices a point; at N = 4,096 the parallel filter and smoother
   against the sequential ones (1e-10) and the lml against
   `exact_gp_log_marginal` (1e-8 relative); the fitted model registered
   with a `GPServer` and forecast at B = 1 and 64; a state over the first
   4,096 points streamed 10 chunks of 2,500 points through `update`,
   held to a one-shot sequential filter over the concatenated series
   (1e-10). None of B1-B7 is launched. Prints the step time, the update
   time a point and the forecast p50.
13. Persistence at the paper's shape, in float64 and float32: five states
   (the SGPR's through "fused" (B1) and "pallas" (B7), the GP-LVM's
   through "pallas" (B5, B3), a Product(RBF, RBF) GP-LVM's through
   "fused", the temporal quickstart's) registered in a
   `GPServer(store=, budget_bytes=<two states' bytes>)` and served round
   robin: every answer after a lazy reload bitwise equal to the answer
   before the eviction, peak resident bytes within the budget, evictions
   and lazy reloads > 0; a 65,536-point `update` on an evicted SGPR state
   bitwise equal to the same update on a server that never evicted;
   `save_all()`, then `GPServer.load(store)` in a fresh spawned process,
   cold and within the budget, answering bitwise as the first process
   did. Prints the times of save, load_meta, load, a lazy reload and
   save_all. Its state builds and update count towards B1, B3, B5 and
   B7's launches.
14. The autotuner, on (every other phase runs with REPRO_TORCH_TUNE=0
   over a fresh cache file, so they launch the untuned geometry), its
   cache in a temporary file: `tune.best_blocks` for all seven kernels in
   both dtypes at M = 100, Q = 1 (each candidate wave count's time and
   split counts, the winner, the measuring N and the cold resolution's
   time), each kernel at every candidate held against its plain version
   (phase 3's tolerances, two launches bitwise equal), `tune.best_chunk`
   for "fused" and "pallas"; a second spawned process on the same cache
   resolves the same winners with zero timing runs; a float32
   `SparseGPRegression(backend="pallas", chunk="auto")` fit of 3 steps
   from the cache. The tuner's launches count towards no main path.
15. The analysis passes on the card (their launches count towards no main
   path): the kernel audit of all seven kernels in both dtypes at both
   kernel shapes and the dry run's, on the card's occupancy queries, each
   block's shared memory against the device's opt-in limit, every N-split
   and tile covering its axis once, half inputs through the float32
   entries; every compiled instance's registers, spills, stack and static
   shared memory from the ptxas report. `assert_no_scaling(worse_than=
   "N*M")` on the GP-LVM loss and its gradients through "fused" and
   "pallas" on CUDA tensors at N = 65,536 and 131,072 (M = 100, Q = 1), and
   through "fused" at M = 128, Q = 1 and M = 256, Q = 4, where B2's
   per-point sums over all of N once violated it (fault C6). The serving (4) and persistence (13) phases run under the port's
   `lockdep.watch()`: zero violations or the phase fails.
16. The reference's GP-LVM dry run (`repro_torch.launch.gp_dryrun`) at
   N = 16,777,216, M = 128, Q = 1, D = 3, one rank, float32, "fused": 5
   Adam steps, each one B1 and one B2 launch and no other kernel; losses
   finite; the peak device memory under the state's bytes plus B2's
   per-point sums (one chunk's) plus 16 elements a point; the dry run's
   loss within 1e-5 of `BayesianGPLVM(backend="fused")`'s at the same
   parameters on a 65,536-point prefix. Prints the record (step ms, peak
   memory, flops, exps and bytes by part, roofline terms, share of bound).
17. Times, with the card's name and power limit: each kernel and its plain
   version at the paper's shape (median of CUDA-event timings; a kernel's
   as one launch an event pair, its `ms`, and over 10 launches back to
   back, divided by 10, its `rate_ms`), the
   kernels' bounds, the exponentials B1-B4's launch geometry evaluates per
   datapoint at both kernel shapes against the M (M + 1) / 2 pairs (and M
   psi1 columns) the statistics need, and B5-B7's runs, tiles, shared
   memory and grids (`[slots]` lines), the SGPR state
   build through "pallas" and "fused",
   predict p50 at B = 1 and B = 256, and the median training-step time
   after the first step for every model and dtype (the two-rank step is
   printed by phase 8).

18. The dense LM at smollm-360m's full width (`[lm]` lines; 361,821,120
   bf16 parameters from seed 0, no weights fetched): served through
   `launch.serve` at B = 4, a 512-token prompt and 64 greedy tokens
   (finite logits, padded ids below -1e29, two runs' tokens equal; prefill
   ms, decode tok/s, peak GiB); in float32, the
   decode after a 127-token prefill against the 128-token forward (the
   reference's 1e-3 max(scale, 1)) and, at B = 2, S = 256 with TF32 off,
   the loss and every gradient leaf against the same model in float64
   (LM_F64_TOL); trained through `launch.train.setup` and `TrainLoop` at
   B = 8, S = 2,048 for 5 steps on one repeated `TokenStream` batch (first
   loss within 0.1 of `expected_first_loss`, the last below the first;
   step ms, tokens/s, peak GiB), a fresh loop resumed from the checkpoint
   at step 5 with its data position and bitwise-equal parameters and
   moments, its steps 6-8 held to the uninterrupted run's (LM_RESUME_TOL);
   the GP head (`core.gp_head`) fitted 50 Adam steps to
   256 mean-pooled final features (Q = 960, M = 256): its loss falls and
   its variance is larger 20 away from the data. The LM launches none of
   B1-B7.

19. The remaining LM families at full width (`[lm-families]` lines; bf16
   parameters from seed 0, no weights fetched; d_model, heads, d_ff,
   experts, vocabulary and windows as configured, only depth and batch
   cut, each cut printed): recurrentgemma-2b (RG-LRU + windowed MQA),
   rwkv6-7b (RWKV-6), moonshot-v1-16b-a3b (64 experts, top-6),
   arctic-480b (128 experts, top-2, dense residual), whisper-small
   (encoder-decoder, 1,500 stub frames) and internvl2-2b (a 256-patch
   stub prefix). Each is served through `launch.serve.generate` twice
   (finite logits, padded ids below -1e29, both runs' greedy tokens
   equal; prefill ms, decode tok/s, peak GiB), held in float32 at 2 layers
   (recurrentgemma 3, its first period; arctic 1) decode-after-prefill
   against the full forward (the reference's 1e-3 max(scale, 1), MoE at
   capacity factor 8), and, but for arctic, trained 3 steps through
   `launch.steps.make_train_step` on one repeated `TokenStream` batch
   (finite losses, the last below the first; step ms, positions/s, peak
   GiB). For rwkv6-7b and recurrentgemma-2b the mixer's parallel form
   (RWKV-6's chunks, RG-LRU's associative scan) is held to its step
   recurrence over 128 tokens in float32 at the CPU tests' 2e-4 / 3e-4.
   Sizes and cuts are `LM_FAMILIES` / `LM_FAMILY_CUTS`. No B1-B7 launch.

20. The LM sharded over a device mesh (`[mesh]` lines): eight spawned gloo
   ranks sharing the card (NCCL refuses a second rank on one card; gloo's
   functional all-gather for CUDA tensors goes through the host,
   `parallel.collectives`), the (2, 2) and (1, 4) meshes over ranks 0-3,
   (4, 2) over all eight. smollm-360m at full width and depth in bf16 on
   (data 2, model 2): each rank's share of the parameter bytes, one train
   step at 8 x 512 through `launch.steps.make_train_step(...).jitted()`
   (its loss within 1e-2 of the single process's) and `launch.serve.
   generate` at 2 x 512 + 8; the step's first moment (the clipped
   gradients) and new parameters and the prefill logits held per leaf at
   the geometric mean of two single-process readings, bf16's noise
   against float32 and a control (the step on half the batch; the update
   lost; the prompt one token short), which must lie 4x apart
   (MESH_SEPARATION);
   the same widths in float32 at 8 of 32 layers, the step through the same
   entry point, held at the reference's EP bounds: the loss (1e-2), every
   first-moment leaf and every parameter after the step (1e-3 of the
   leaf's max), the prefill and 8 teacher-forced decode steps' logits
   (1e-2). One moonshot-v1-16b-a3b MoE layer at full width (float32,
   capacity factor 8) on (1, 4) through `moe_apply`: at 4 x 256 tokens the
   all-to-all path, at 4 x 1 the all-reduce path, each held to
   `moe_apply_dense` on one process (loss 1e-2, gradients 1e-3). The
   elastic round trip at smollm's widths, 4 of 32 layers: saved from
   (2, 2), restored with `runtime.elastic.reshard_for_mesh` on (4, 2),
   saved there and restored on (2, 2), every leaf bitwise. Times are
   gloo-bound and no speed figure. No B1-B7 launch.

21. The LM dry run (`[lm-dryrun]` lines; `launch.dryrun`). On one rank,
   smollm-360m at full width in bf16, its train step at 8 x 2,048, prefill
   at 4 x 512 and decode at B = 4 over 576 slots: `StepBundle.lower()`
   (meta tensors, traced on the host's CPU) predicts the peak, which must
   lie within 10 % of `max_memory_allocated` over the real step on the
   card (reset just before it, after one warm-up call; the arguments'
   blocks counted, nothing else resident), and counts the matrix-product
   flops, which must equal `FlopCounterMode`'s on the real step; the
   step's time (median of 3) is printed beside the roofline bound.
   Meanwhile, on the host's CPU, the dry run's CLI in five child processes
   started together (the fake process group shares no process with the
   gloo phases): smollm-360m's train_4k, prefill_32k and decode_32k on
   the pod mesh, moonshot-v1-16b-a3b's
   train_4k on the multipod mesh and recurrentgemma-2b's long_500k on the
   pod mesh, each record status ok, its GiB a chip, dominant term, bound
   and useful share printed (predictions for an H100 cluster, not
   measurements). No B1-B7 launch.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import datetime
import inspect
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.manager import flatten_with_keys  # noqa: E402
from repro_torch.core import distributed, inference  # noqa: E402
from repro_torch.gp import (BayesianGPLVM, ExactBatch, ExpectedBatch,  # noqa: E402
                            SparseGPRegression, get, suff_stats)
from repro_torch.optim import AdamConfig, adam_init, adam_update  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import kfu as kf  # noqa: E402
from repro_torch.kernels import psi1 as p1  # noqa: E402
from repro_torch.kernels import psi2 as p2  # noqa: E402
from repro_torch.kernels import suffstats as ss  # noqa: E402
from repro_torch.optim.adam import flatten, tree_map, unflatten  # noqa: E402
from repro_torch.serve import GPServer, StateStore, build_state  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.analysis import kernel_audit, lockdep, trace_check  # noqa: E402
from repro_torch.launch import gp_dryrun, roofline  # noqa: E402
from repro_torch.launch.roofline import (bound_ms, bwd_bound_ms, kfu_bound_ms,  # noqa: E402
                                         psi1_bound_ms, psi1_bwd_bound_ms,
                                         psi2_bound_ms, psi2_bwd_bound_ms)
from repro_torch.tune import autotune, search  # noqa: E402
from repro_torch.configs import ShapeCell, get_config, get_smoke_config  # noqa: E402
from repro_torch.core import gp_head  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import model_zoo, transformer  # noqa: E402
from repro_torch.runtime import TrainLoop, reshard_for_mesh  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch import mesh as lm_mesh  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.launch.mesh import LocalMesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import collectives, sharding  # noqa: E402

SEED = 0
PAPER = (1_000_000, 100, 1, 3)  # N, M, Q, D: paper §4 (Q=1, M=100, D=3, 1e6 points)
KERNEL_SHAPES = ((1_000_003, 100, 1, 3), (100_003, 256, 4, 5))
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}  # kernel vs float64 plain
PRED_TOL_F64 = 1e-8  # float64 kernel path vs float64 plain path
ROUNDTRIP_TOL = {torch.float64: 1e-6, torch.float32: 1e-2}  # downdate(update(s, b), b) vs s
# float32 kernel path vs float64 kernel path: float32 factors with 100x the
# jitter and an eps floor of ~1e-5 of diag(beta Psi2), a slightly different
# posterior; means are held relative to max|mean|, variances (a difference
# of O(v) terms) relative to the prior variance v
PRED_TOL_F32 = 1e-1
VAR_TOL_F32 = 1e-2
# a coalesced submit vs the same rows predicted alone: another matmul shape,
# so roundoff only (a mixed-up row would be off by O(1))
SUBMIT_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
UPDATE_N = 65_536
BATCHES = (1, 16, 256, 300)
TRAIN_STEPS = 10
COMPARE_STEPS = 3
# float64 GP-LVM steps through the reverse kernel vs through the plain
# reverse pass, from well-conditioned parameters: the same forward,
# gradients equal to ~1e-12, but Adam computes each update in float32, so a
# parameter can land one float32 ulp apart and carry that on; losses and
# parameters (relative to max|leaf|) within 1e-5
TRAJ_TOL = 1e-5
# the reverse kernel and the plain reverse pass on the loss's own
# cotangents, each against an extended-precision reverse pass on the first
# EXT_POINTS points: the two float64 passes differ only in summation order,
# so the kernel's error stays within EXT_RATIO times the plain pass's (or
# below EXT_FLOOR); a wrong term would put it far above both
EXT_POINTS = 2048
EXT_RATIO = 4.0
EXT_FLOOR = 1e-13
# float32 training against float64 training from the same init: the
# float64 loss at the float32 fit's final parameters must have come down by
# at least this share of the float64 fit's own descent. A float32 fit is a
# noisier model (100x the jitter, float32 statistics and gradients), so this
# is a floor on its usefulness, not a roundoff bound.
F32_DESCENT_SHARE = 0.8
TIMED_STEPS = 6  # the first is dropped
# backend="pallas" against backend="fused" at the same float64 parameters on
# the grid: the same model through other kernels and other summation
# orders, so the loss to TOL and each gradient leaf to this
BACKEND_GRAD_TOL = 1e-8

ROUTE = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/suffstats_fwd.cu",
         "replaces": "src/repro/kernels/suffstats.py:299", "library_ms": None}
ROUTE_BWD = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/suffstats_bwd.cu",
             "replaces": "src/repro/kernels/suffstats.py:463", "library_ms": None}
BWD_OUTPUTS = ("dmu", "dS", "dY", "dZ", "dvariance", "dlengthscale")
SINGLE_BWD_OUTPUTS = ("dmu", "dS", "dZ", "dvariance", "dlengthscale")
CSRC = "src/repro_torch/kernels/csrc"
# the single-statistic kernels (B3-B6): the library, the TPU kernel each
# replaces, and its launch counter (module, attribute)
SINGLE_ROUTES = {
    "psi2_fwd": {"route": "cuda", "source": f"{CSRC}/psi2_fwd.cu",
                 "replaces": "src/repro/kernels/psi2.py:105", "library_ms": None},
    "psi2_bwd": {"route": "cuda", "source": f"{CSRC}/psi2_bwd.cu",
                 "replaces": "src/repro/kernels/suffstats.py:714", "library_ms": None},
    "psi1_fwd": {"route": "cuda", "source": f"{CSRC}/psi1_fwd.cu",
                 "replaces": "src/repro/kernels/psi1.py:75", "library_ms": None},
    "psi1_bwd": {"route": "cuda", "source": f"{CSRC}/psi1_bwd.cu",
                 "replaces": "src/repro/kernels/suffstats.py:590", "library_ms": None},
    "kfu_fwd": {"route": "cuda", "source": f"{CSRC}/kfu_fwd.cu",
                "replaces": "src/repro/kernels/kfu.py:74", "library_ms": None},
}
KFU_BWD_OUTPUTS = ("dX", "dZ", "dvariance", "dlengthscale")
COUNTERS = {"suffstats_fwd": (ss, "LAUNCHES"), "suffstats_bwd": (ss, "BWD_LAUNCHES"),
            "psi2_fwd": (p2, "LAUNCHES"), "psi2_bwd": (ss, "PSI2_BWD_LAUNCHES"),
            "psi1_fwd": (p1, "LAUNCHES"), "psi1_bwd": (ss, "PSI1_BWD_LAUNCHES"),
            "kfu_fwd": (kf, "LAUNCHES")}
# the data-parallel phase: ranks, Adam steps, and how long a child may take
DP_WORLD = 2
DP_STEPS = 3
DP_TIMEOUT_S = 300


def counts() -> dict:
    """Every kernel's launch counter."""
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def set_counts(values: dict) -> None:
    for name, (module, attr) in COUNTERS.items():
        setattr(module, attr, values[name])


def zero_counts() -> None:
    set_counts({name: 0 for name in COUNTERS})


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in float64."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases 1-2: device and build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    """Build every library (each instance's registers and spills print in
    the analysis phase, from nvcc's -Xptxas -v report)."""
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, (secs, _) in _build.BUILD_LOG.items():
        log(f"[build] {name}: nvcc {secs:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(N, M, Q, D, pos_S, seed=SEED):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-3.0, 3.0, (N, Q))
    S = rng.uniform(0.001, 0.05, (N, Q)) if pos_S else np.zeros((N, Q))
    Y = rng.normal(size=(N, D))
    Z = rng.uniform(-3.0, 3.0, (M, Q))
    return [torch.as_tensor(a, device="cuda") for a in
            (mu, S, Y, Z, np.float64(1.3), rng.uniform(0.3, 1.2, Q))]


def phase_kernels() -> dict:
    """Kernel vs plain on every shape; returns the max abs error per dtype
    at the paper's shape."""
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    for N, M, Q, D in KERNEL_SHAPES:
        for pos_S in (True, False):
            x64 = kernel_inputs(N, M, Q, D, pos_S)
            want = ss.suffstats_fused_plain(*x64)
            for dt, tol in TOL.items():
                x = [a.to(dt) for a in x64]
                got = ss.suffstats_cuda(*x)
                again = ss.suffstats_cuda(*x)
                torch.cuda.synchronize()
                for name, g, a, w in zip(("psi2", "psiY"), got, again, want):
                    r = rel_err(g, w)
                    log(f"[kernel] N={N} M={M} Q={Q} D={D} S{'>' if pos_S else '='}0 "
                        f"{str(dt)[6:]} {name}: rel err {r:.3e} (tol {tol:g})")
                    check(bool(torch.isfinite(g).all()), f"{name} not finite")
                    check(r <= tol, f"{name} {dt} rel err {r:.3e} > {tol:g}")
                    check(torch.equal(g, a), f"{name} {dt}: two runs differ")
                    if (N, M, Q, D) == KERNEL_SHAPES[0]:
                        errs[dt] = max(errs[dt], float((g.double() - w).abs().max()))
    return errs


def bwd_cotangents(M, D, seed=SEED + 1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, device="cuda") for a in
            (rng.normal(size=(M, M)), rng.normal(size=(M, D)))]


def phase_bwd_kernels() -> dict:
    """Reverse kernel vs plain reverse pass on every shape; returns the max
    abs error per dtype at the paper's shape."""
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    for N, M, Q, D in KERNEL_SHAPES:
        for pos_S in (True, False):
            x64 = kernel_inputs(N, M, Q, D, pos_S) + bwd_cotangents(M, D)
            want = ss.suffstats_vjp_plain(*x64)
            for dt, tol in TOL.items():
                x = [a.to(dt) for a in x64]
                got = ss.suffstats_bwd_cuda(*x)
                again = ss.suffstats_bwd_cuda(*x)
                torch.cuda.synchronize()
                for name, g, a, w in zip(BWD_OUTPUTS, got, again, want):
                    r = rel_err(g, w)
                    log(f"[kernel] bwd N={N} M={M} Q={Q} D={D} S{'>' if pos_S else '='}0 "
                        f"{str(dt)[6:]} {name}: rel err {r:.3e} (tol {tol:g})")
                    check(g.shape == w.shape and g.dtype == dt, f"{name} shape/dtype")
                    check(bool(torch.isfinite(g).all()), f"{name} not finite")
                    check(r <= tol, f"bwd {name} {dt} rel err {r:.3e} > {tol:g}")
                    check(torch.equal(g, a), f"bwd {name} {dt}: two runs differ")
                    if (N, M, Q, D) == KERNEL_SHAPES[0]:
                        errs[dt] = max(errs[dt], float((g.double() - w).abs().max()))
    return errs


def random_g(N: int, M: int, seed: int = SEED + 2) -> torch.Tensor:
    """A float64 (N, M) output cotangent of psi1, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(N, M, generator=gen, device="cuda", dtype=torch.float64)


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def phase_single_kernels() -> dict:
    """The single-statistic kernels B3-B7, each against its plain version
    on every shape: S > 0 for B3-B6, S = 0 also for psi1 and its reverse;
    B7 (K_fu) and its reverse pass (B6 at S = 0). Returns the max abs error
    per (kernel, dtype) at the paper's shape."""
    errs = {}
    for N, M, Q, D in KERNEL_SHAPES:
        for pos_S in (True, False):
            mu, S, _, Z, v, l = kernel_inputs(N, M, Q, D, pos_S)
            x = (mu, S, Z, v, l)
            cases = {"psi1_fwd": (p1.psi1_cuda, p1.psi1_plain, x, ("psi1",)),
                     "psi1_bwd": (ss.psi1_bwd_cuda, ss.psi1_vjp_plain,
                                  x + (random_g(N, M),), SINGLE_BWD_OUTPUTS)}
            if pos_S:
                cases["psi2_fwd"] = (p2.psi2_cuda, p2.psi2_plain, x, ("psi2",))
                cases["psi2_bwd"] = (ss.psi2_bwd_cuda, ss.psi2_vjp_plain,
                                     x + (bwd_cotangents(M, D)[0],), SINGLE_BWD_OUTPUTS)
            else:
                xk = (mu, Z, v, l)
                cases["kfu_fwd"] = (kf.kfu_cuda, kf.kfu_plain, xk, ("kfu",))
                cases["kfu_bwd"] = (ss.kfu_bwd_cuda, ss.kfu_vjp_plain,
                                    xk + (random_g(N, M),), KFU_BWD_OUTPUTS)
            for name, (kernel, plain, args, outputs) in cases.items():
                want = _as_tuple(plain(*args))
                for dt, tol in TOL.items():
                    xs = [a.to(dt) for a in args]
                    got, again = _as_tuple(kernel(*xs)), _as_tuple(kernel(*xs))
                    torch.cuda.synchronize()
                    for out, g, a, w in zip(outputs, got, again, want):
                        r = rel_err(g, w)
                        log(f"[kernel] {name} N={N} M={M} Q={Q} S{'>' if pos_S else '='}0 "
                            f"{str(dt)[6:]} {out}: rel err {r:.3e} (tol {tol:g})")
                        check(g.shape == w.shape and g.dtype == dt, f"{name} {out} shape/dtype")
                        check(bool(torch.isfinite(g).all()), f"{name} {out} not finite")
                        check(r <= tol, f"{name} {out} {dt} rel err {r:.3e} > {tol:g}")
                        check(torch.equal(g, a), f"{name} {out} {dt}: two runs differ")
                        if (N, M, Q, D) == KERNEL_SHAPES[0]:
                            errs[name, dt] = max(errs.get((name, dt), 0.0),
                                                 float((g.double() - w).abs().max()))
                del want
    return errs


# ---------------------------------------------------------------------------
# phase 4: serving at full size
# ---------------------------------------------------------------------------

def serving_data(N: int, M: int, seed: int = SEED) -> dict:
    """Paper §4-shaped data (Q = 1, D = 3) and random parameters: a GP-LVM
    q(X) with its Y, an SGPR (X, Y), 65,536 new points, 300 test inputs.
    Inducing points sit on a grid at about one lengthscale apart."""
    rng = np.random.default_rng(seed)

    def f(x):
        return np.hstack([np.sin(2.0 * x), np.cos(3.0 * x), x * np.sin(x)])

    mu = rng.uniform(-3.0, 3.0, (N, 1))
    X = rng.uniform(-3.0, 3.0, (N, 1))
    X_new = rng.uniform(-3.0, 3.0, (UPDATE_N, 1))
    return {
        "params": {"kern": {"log_variance": np.log(1.0),
                            "log_lengthscale": np.log([0.08])},
                   "Z": np.linspace(-3.0, 3.0, M)[:, None],
                   "log_beta": np.log(100.0)},
        "mu": mu, "S": rng.uniform(0.0001, 0.001, (N, 1)),
        "Y_lvm": f(mu) + 0.1 * rng.normal(size=(N, 3)),
        "X": X, "Y": f(X) + 0.1 * rng.normal(size=(N, 3)),
        "X_new": X_new, "Y_new": f(X_new) + 0.1 * rng.normal(size=(UPDATE_N, 3)),
        "Xt": rng.uniform(-3.2, 3.2, (300, 1)),
    }


def _submit_concurrently(srv, name, Xt, n=8, rows=16):
    futs = [None] * n

    def client(i):
        futs[i] = srv.submit(name, Xt[rows * i: rows * (i + 1)])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        check(not t.is_alive(), "a submitting thread hung")
    return [f.result(timeout=120) for f in futs]


def predict_p50_ms(srv, name, Xt, B, reps=50) -> float:
    for _ in range(5):
        srv.predict(name, Xt[:B])
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        mean, var = srv.predict(name, Xt[:B])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serve_run(data: dict, *, device: str, dtype: torch.dtype, backend: str,
              timed: bool = False) -> dict:
    """Build both states through `backend`, register them, answer every
    request kind, update then downdate. Returns the answers (float64, on
    the device) keyed by (model, what); with `timed` (CUDA only) also the
    build and update times (host clock to a synchronize) and predict p50s."""
    def t(a):
        return torch.as_tensor(a, device=device, dtype=dtype)

    kernel = get("rbf")(1)
    params = convert.params_from_numpy(data["params"], device=device, dtype=dtype)
    prior_var = float(np.exp(data["params"]["kern"]["log_variance"]))
    Z = params["Z"]
    batches = {"gplvm": ExpectedBatch(t(data["mu"]), t(data["S"]), t(data["Y_lvm"]), Z),
               "sgpr": ExactBatch(t(data["X"]), t(data["Y"]), Z)}
    out = {}
    Xt = t(data["Xt"])
    with GPServer(device=device) as srv:
        for name, batch in batches.items():
            t0 = time.perf_counter()
            stats = suff_stats(kernel, params["kern"], batch, backend=backend)
            srv.register(name, kernel=kernel, state=build_state(kernel, params, stats))
            if timed:
                torch.cuda.synchronize()
                out[name, "build_ms"] = (time.perf_counter() - t0) * 1e3
        for name in batches:
            for B in BATCHES:
                mean, var = srv.predict(name, Xt[:B])
                check(mean.shape == (B, 3) and var.shape == (B,), f"{name} B={B} shape")
                out[name, B, "diag"] = (mean.double(), var.double())
                if B <= srv.buckets[-1]:
                    mean, cov = srv.predict(name, Xt[:B], diag=False)
                    check(cov.shape == (B, B), f"{name} B={B} cov shape")
                    out[name, B, "full"] = (mean.double(), cov.double())
                else:
                    try:
                        srv.predict(name, Xt[:B], diag=False)
                        check(False, "an oversized full-covariance request was served")
                    except ValueError:
                        pass
            answers = _submit_concurrently(srv, name, Xt)
            for i, (mean, var) in enumerate(answers):
                want_mean, want_var = srv.predict(name, Xt[16 * i: 16 * (i + 1)])
                check(rel_err(mean, want_mean) <= SUBMIT_TOL[dtype]
                      and float((var - want_var).abs().max()) / prior_var <= SUBMIT_TOL[dtype],
                      f"{name}: a coalesced submit differs from its own predict")
            if timed:
                for B in (1, 256):
                    out[name, B, "p50_ms"] = predict_p50_ms(srv, name, Xt, B)
            before = srv.predict(name, Xt[:256])
            t0 = time.perf_counter()
            srv.update(name, data["X_new"], data["Y_new"], backend=backend)
            if timed:
                torch.cuda.synchronize()
                out[name, "update_ms"] = (time.perf_counter() - t0) * 1e3
            check(float(srv.state(name).stats.n) == data["mu"].shape[0] + UPDATE_N,
                  f"{name}: update did not add {UPDATE_N} points")
            out[name, "updated"] = tuple(a.double() for a in srv.predict(name, Xt[:256]))
            srv.downdate(name, data["X_new"], data["Y_new"], backend=backend)
            restored = srv.predict(name, Xt[:256])
            for r, b in zip(restored, before):
                err = rel_err(r, b)
                log(f"[serve] {str(dtype)[6:]} {backend} {name}: downdate round trip "
                    f"rel err {err:.3e} (tol {ROUNDTRIP_TOL[dtype]:g})")
                check(err <= ROUNDTRIP_TOL[dtype], f"{name}: downdate round trip {err:.3e}")
    for key, val in out.items():
        if isinstance(val, tuple):
            check(all(bool(torch.isfinite(v).all()) for v in val), f"{key} not finite")
    return out


def compare_runs(got: dict, want: dict, tol: float, what: str,
                 var_tol: float | None = None, prior_var: float = 1.0) -> None:
    """Worst relative error over every answer of two runs. With `var_tol`,
    variances and covariances are measured against the prior variance."""
    worst = worst_var = 0.0
    for key, val in want.items():
        if isinstance(val, tuple):
            g_mean, g_var = got[key]
            worst = max(worst, rel_err(g_mean, val[0]))
            if var_tol is None:
                worst = max(worst, rel_err(g_var, val[1]))
            else:
                worst_var = max(worst_var, float((g_var - val[1]).abs().max()) / prior_var)
    log(f"[serve] {what}: worst rel err {worst:.3e} (tol {tol:g})"
        + ("" if var_tol is None else
           f", worst variance err / prior variance {worst_var:.3e} (tol {var_tol:g})"))
    check(worst <= tol, f"{what}: rel err {worst:.3e} > {tol:g}")
    check(var_tol is None or worst_var <= var_tol,
          f"{what}: variance err {worst_var:.3e} > {var_tol}")


def _log_times(run: dict, what: str) -> None:
    for name in ("gplvm", "sgpr"):
        log(f"[time] {what} {name}: state build {run[name, 'build_ms']:.1f} ms "
            f"(N={PAPER[0]}), update {run[name, 'update_ms']:.1f} ms "
            f"({UPDATE_N / run[name, 'update_ms'] * 1e3:.3g} points/s incl. host "
            f"transfer + refold)")


def phase_serving(data: dict) -> dict:
    """Returns the kernel's launches and predict p50s per dtype."""
    result = {}
    runs = {}
    for dtype in (torch.float64, torch.float32):
        zero_counts()
        t0 = time.perf_counter()
        runs[dtype] = serve_run(data, device="cuda", dtype=dtype, backend="fused",
                                timed=True)
        torch.cuda.synchronize()
        launches = ss.LAUNCHES
        check(sum(counts().values()) == launches,
              f"{dtype} serving path launched another kernel than B1: {counts()}")
        log(f"[serve] {str(dtype)[6:]} kernel path: {launches} kernel launches, "
            f"{time.perf_counter() - t0:.1f} s")
        check(launches > 0, f"{dtype} serving path never launched the kernel")
        _log_times(runs[dtype], f"{str(dtype)[6:]} kernel path")
        result[dtype] = {"launches": launches,
                         "p50": {B: runs[dtype]["gplvm", B, "p50_ms"] for B in (1, 256)}}
    zero_counts()
    plain = serve_run(data, device="cuda", dtype=torch.float64, backend="jnp", timed=True)
    check(sum(counts().values()) == 0, f"the plain path launched a kernel: {counts()}")
    _log_times(plain, "float64 plain path")
    compare_runs(runs[torch.float64], plain, PRED_TOL_F64, "float64 kernel vs plain path")
    compare_runs(runs[torch.float32], runs[torch.float64], PRED_TOL_F32,
                 "float32 vs float64 kernel path", var_tol=VAR_TOL_F32,
                 prior_var=float(np.exp(data["params"]["kern"]["log_variance"])))
    return result


# ---------------------------------------------------------------------------
# phase 5: training at full size, then serving the fitted models
# ---------------------------------------------------------------------------

def _as(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(a, device="cuda", dtype=dtype)


def fit_models(data: dict, dtype: torch.dtype) -> dict:
    """The training path as a user drives it: both facades fitted from
    their own init, TRAIN_STEPS Adam steps through backend="fused", every
    loss logged."""
    lvm = BayesianGPLVM(M=PAPER[1], Q=1, backend="fused", device="cuda").fit(
        _as(data["Y_lvm"], dtype), steps=TRAIN_STEPS, log_every=1)
    sgpr = SparseGPRegression(M=PAPER[1], backend="fused", device="cuda").fit(
        _as(data["X"], dtype), _as(data["Y"], dtype), steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    return {"gplvm": lvm, "sgpr": sgpr}


def serve_fitted(models: dict, dtype: torch.dtype) -> None:
    """Register each fitted facade, predict at B = 1 and 256 (the served
    state against the facade's own posterior), refit the noise."""
    Xt = torch.linspace(-2.5, 2.5, 256, device="cuda", dtype=dtype)[:, None]
    tol = SUBMIT_TOL[dtype]
    with GPServer(device="cuda") as srv:
        for key, model in models.items():
            srv.register(key, model)
            for B in (1, 256):
                mean, var = srv.predict(key, Xt[:B])
                want_mean, want_var = model.predict(Xt[:B])
                check(mean.shape == (B, 3) and var.shape == (B,), f"{key} B={B} shape")
                check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                      f"{key} B={B}: served answer not finite")
                err = max(rel_err(mean, want_mean), rel_err(var, want_var))
                check(err <= tol, f"{key} B={B}: served {err:.3e} vs the facade's predict")
            history = srv.refit(key, steps=20)
            log(f"[serve] {str(dtype)[6:]} fitted {key}: refit loss {history[0]:.6f} -> "
                f"{history[-1]:.6f}")
            check(len(history) == 2 and all(np.isfinite(history)),
                  f"{key}: refit history {history}")
            check(history[-1] <= history[0], f"{key}: refit raised the loss {history}")
            mean, _ = srv.predict(key, Xt)
            check(bool(torch.isfinite(mean).all()), f"{key}: refitted answer not finite")


def _named(tree: dict) -> dict:
    """path -> leaf of a parameter tree ("kern/log_variance", "Z", ...)."""
    return dict(zip(*flatten(tree)))


def _leaves(params: dict) -> dict:
    return {"log_variance": params["kern"]["log_variance"],
            "log_lengthscale": params["kern"]["log_lengthscale"],
            **{k: params[k] for k in ("Z", "log_beta", "q_mu", "q_logS")}}


def reverse_pass_extended(mu, S, Y, Z, variance, lengthscale, g2, gY, chunk=128,
                          g=None, absolute=False):
    """(dmu, dS, dY, dZ, dvariance, dlengthscale) in numpy's long double
    (x87 80-bit on x86-64 Linux: 11 more bits than float64), point by point
    from equations (8)-(20) of docs/derivations/suffstats_vjp.md with the
    direct (mu - zbar) form: the reference that shows how far a float64
    reverse pass can be trusted where the cotangents cancel. With `g`, the
    psi1 op's (N, M) cotangent, in place of Y and gY: the psi1 and psi2
    ops' reverse passes summed (W1 = g psi1, eq. (8) specialized), dY
    empty. With `absolute`, every term of every sum by its absolute value:
    eps * that is how far a correct float64 evaluation of the same terms
    may land from the reference (the float64 floor)."""
    ld = np.longdouble
    check(np.finfo(ld).eps < 1e-18, "numpy long double is not extended precision here")
    mu, S, Y, Z, v, ls, g2, gY, g = (
        None if t is None else np.asarray(t.detach().cpu().double().numpy(), dtype=ld)
        for t in (mu, S, Y, Z, variance, lengthscale, g2, gY, g))
    l2 = ls * ls
    zdiff = Z[:, None, :] - Z[None, :, :]  # (M, M, Q)
    zbar = ld(0.5) * (Z[:, None, :] + Z[None, :, :])
    G2p = g2 * v * v * np.exp(-(zdiff * zdiff / (4 * l2)).sum(-1))  # eq. (9)
    A = np.abs if absolute else (lambda x: x)
    neg = 1 if absolute else -1
    out = {k: [] for k in ("dmu", "dS", "dY")}
    dZ, dv, dl = np.zeros(Z.shape, ld), ld(0), np.zeros(ls.shape, ld)
    for i in range(0, mu.shape[0], chunk):
        m_, s_ = mu[i:i + chunk], S[i:i + chunk]
        b, r = 1 / (l2 + s_), 1 / (l2 + 2 * s_)
        # psi1 branch, eq. (8), (10)-(14)
        d1 = m_[:, None, :] - Z[None]  # (c, M, Q)
        K = np.exp(-0.5 * np.log1p(s_ / l2).sum(-1)[:, None]
                   - 0.5 * (d1 * d1 * b[:, None, :]).sum(-1))
        if g is None:
            gyv = A(v * gY)
            W1 = A(A(Y[i:i + chunk]) @ gyv.T) * K
            out["dY"].append(K @ gyv)
        else:
            W1 = A(g[i:i + chunk] * v) * K
        a1 = A(d1)
        s1, s1d, s1v = W1.sum(1), (W1[..., None] * a1).sum(1), (W1[..., None] * d1 * d1).sum(1)
        dZ += (W1[..., None] * b[:, None, :] * a1).sum(0)
        # psi2 branch, eq. (9), (15)-(20): T = G2p E over every (a, b)
        d2 = m_[:, None, None, :] - zbar[None]  # (c, M, M, Q)
        E = np.exp(-0.5 * np.log1p(2 * s_ / l2).sum(-1)[:, None, None]
                   - (d2 * d2 * r[:, None, None, :]).sum(-1))
        T = A(G2p[None] * E)
        a2 = A(d2)
        t, sd, sv = T.sum((1, 2)), (T[..., None] * a2).sum((1, 2)), (T[..., None] * d2 * d2).sum((1, 2))
        out["dmu"].append(neg * b * s1d + neg * 2 * r * sd)
        out["dS"].append(neg * 0.5 * b * s1[:, None] + 0.5 * b * b * s1v + neg * r * t[:, None]
                         + 2 * r * r * sv)
        dv += (s1 + 2 * t).sum()
        dl += ((s_ * b / ls) * s1[:, None] + ls * b * b * s1v + (2 / ls) * s_ * r * t[:, None]
               + 2 * ls * r * r * sv).sum(0)
        dl += (T.sum(0)[..., None] * zdiff * zdiff).sum((0, 1)) / (2 * ls ** 3)
        # d/dz_a through zbar_ab and zterm_ab, for both orders of the pair
        Ts = T + T.transpose(0, 2, 1)
        dZ += (Ts[..., None] * (r[:, None, None, :] * a2 + neg * A(zdiff[None]) / (2 * l2))
               ).sum((0, 2))
    return (np.concatenate(out["dmu"]), np.concatenate(out["dS"]),
            np.concatenate(out["dY"]) if out["dY"] else None, dZ, dv / v, dl)


def check_extended(args: tuple, n: int, what: str) -> list:
    """The reverse kernel and the plain reverse pass on the first n points
    of `args` (the loss's own cotangents), each against the extended-
    precision reference, relative to max|reference| per output. Returns
    the outputs where the kernel's error exceeds EXT_RATIO times the plain
    pass's and EXT_FLOOR."""
    sub = tuple(a[:n] for a in args[:3]) + tuple(args[3:])
    with torch.no_grad():
        kernel, plain = ss.suffstats_bwd_cuda(*sub), ss.suffstats_vjp_plain(*sub)
    return _vs_extended(BWD_OUTPUTS, kernel, plain, reverse_pass_extended(*sub), n, what)


def check_extended_single(args1: tuple, args2: tuple, n: int, what: str) -> list:
    """The psi1 and psi2 reverse kernels (B6, B4), each with its plain
    reverse pass, on the first n points of the cotangents the pallas path's
    loss sends them (g for psi1, g2 for psi2), each against its own
    branch's extended-precision reference: as `check_extended`, except that
    an error below the float64 floor (eps * the sum of the terms' absolute
    values, the noise any correct float64 evaluation carries, which the
    loss's cancelling g2 makes large at the init) also passes."""
    mu, S, Z, v, l, g = args1
    sub, g, g2 = (mu[:n], S[:n], Z, v, l), g[:n], args2[5]
    failed = []
    for name, kernel, plain, g_psi1, g_psi2, cot in (
            ("B6", ss.psi1_bwd_cuda, ss.psi1_vjp_plain, g, torch.zeros_like(g2), g),
            ("B4", ss.psi2_bwd_cuda, ss.psi2_vjp_plain, torch.zeros_like(g), g2, g2)):
        with torch.no_grad():
            k, p = kernel(*sub, cot), plain(*sub, cot)
        ref, floor = (
            [r for r in reverse_pass_extended(*sub[:2], None, *sub[2:], g_psi2, None,
                                              g=g_psi1, absolute=a) if r is not None]
            for a in (False, True))
        eps = float(np.finfo(np.float64).eps)
        failed += _vs_extended(SINGLE_BWD_OUTPUTS, k, p, ref, n, f"{what}, {name}",
                               floors=[eps * f for f in floor])
        # the same plain pass on the host's CPU: other exp and summation
        # code, so where the floor is high it lands elsewhere (printed only)
        with torch.no_grad():
            host = plain(*(t.cpu() for t in sub), cot.cpu())
        log(f"[train] {what}, {name}, first {n} points: plain pass on the CPU vs extended "
            f"precision: " + ", ".join(f"{o} {ext_err(h, w):.3e}"
                                       for o, h, w in zip(SINGLE_BWD_OUTPUTS, host, ref)))
    return failed


def ext_err(x: torch.Tensor, ref) -> float:
    """max |x - ref| / max |ref|, in long double."""
    w = np.asarray(ref, dtype=np.longdouble).reshape(tuple(x.shape))
    got = np.asarray(x.detach().cpu().numpy(), dtype=np.longdouble)
    return float(np.abs(got - w).max() / np.abs(w).max())


def _vs_extended(names, kernel, plain, ref, n: int, what: str, floors=None) -> list:
    """Each output of the kernel and of the plain pass against the
    extended-precision reference, relative to max|reference|; the outputs
    where the kernel's error exceeds EXT_RATIO times the plain pass's,
    EXT_FLOOR and, where `floors` are given, max(floor) / max|reference|."""
    failed = []
    for i, (name, k, p, w) in enumerate(zip(names, kernel, plain, ref)):
        ek, ep = ext_err(k, w), ext_err(p, w)
        fl = 0.0 if floors is None else float(np.max(floors[i]) / np.abs(w).max())
        shown = ("" if floors is None else
                 f", float64 floor {fl:.3e}; reference "
                 + (" ".join(f"{float(x):.6g}" for x in np.ravel(w)) if np.size(w) <= 4
                    else f"max|.| {float(np.abs(w).max()):.4e}"))
        log(f"[train] {what}, first {n} points: {name} vs extended precision: kernel "
            f"{ek:.3e}, plain {ep:.3e}" + shown)
        if ek > max(EXT_RATIO * ep, EXT_FLOOR, fl):
            failed.append(f"{name} kernel {ek:.3e} vs plain {ep:.3e} from extended precision")
    return failed


def _grads_and_cotangents(model, params, Y, kernels=("suffstats_bwd_cuda",)) -> tuple:
    """value_and_grad of the model's loss, and the arguments each named
    reverse kernel of `ops` received (its inputs plus the output
    cotangents: g2, gY for the fused op; g or g2 for psi1 or psi2), in the
    order of `kernels`."""
    seen = {name: [] for name in kernels}
    real = {name: getattr(ops, name) for name in kernels}

    def spy(name):
        def call(*args, **kw):
            seen[name].append(args)
            return real[name](*args, **kw)
        return call

    for name in kernels:
        setattr(ops, name, spy(name))
    try:
        loss, grads = inference.value_and_grad(model._loss, params, (Y,))
    finally:
        for name in kernels:
            setattr(ops, name, real[name])
    check(all(len(v) == 1 for v in seen.values()),
          f"one launch of each reverse kernel expected, saw "
          f"{ {k: len(v) for k, v in seen.items()} }")
    return loss, grads, *(seen[name][0] for name in kernels)


def compare_grads(models: dict, p0: dict, Y, what: str, *, hold: bool) -> None:
    """The float64 GP-LVM's gradients at p0 through the reverse kernel and
    through the plain reverse pass, and the two passes on the cotangents
    the loss really sends them: on the first EXT_POINTS points against the
    extended-precision reference (always held), on every point against
    each other, and per parameter leaf (held to TOL, f32 leaves to 1e-6,
    where `hold`)."""
    _, g_kernel, args = _grads_and_cotangents(models["auto"], p0, Y)
    _, g_plain = inference.value_and_grad(models["jnp"]._loss, p0, (Y,))
    failed = check_extended(args, EXT_POINTS, what)
    with torch.no_grad():
        got, want = ss.suffstats_bwd_cuda(*args), ss.suffstats_vjp_plain(*args)
    held = f"tol {TOL[torch.float64]:g}" if hold else "not held"
    for name, g, w in zip(BWD_OUTPUTS, got, want):
        err = rel_err(g, w)
        log(f"[train] {what}: reverse kernel output {name} at the loss's cotangents vs "
            f"plain rel err {err:.3e} ({held})")
        if hold and err > TOL[torch.float64]:
            failed.append(f"kernel output {name} {err:.3e}")
    # how much the Z gradient cancels: the op's part against the total
    dz_op = float(want[3].abs().max())
    dz = float(g_plain["Z"].abs().max())
    log(f"[train] {what}: max|dZ| through the op {dz_op:.4e}, of the loss {dz:.4e} "
        f"(cancellation x{dz_op / dz:.3g})")
    for name, g in _leaves(g_kernel).items():
        # float32 leaves get the float64 gradient rounded to float32
        tol = TOL[torch.float64] if g.dtype == torch.float64 else 1e-6
        err = rel_err(g, _leaves(g_plain)[name])
        log(f"[train] {what}: gradient {name} ({str(g.dtype)[6:]}), reverse kernel vs "
            f"plain rel err {err:.3e} ({f'tol {tol:g}' if hold else 'not held'})")
        if hold and err > tol:
            failed.append(f"gradient {name} {err:.3e} > {tol:g}")
    check(not failed, f"{what}: " + "; ".join(failed))


def trace_trajectories(models: dict, p0: dict, Y, steps: int, what: str) -> None:
    """The two reverse paths' Adam steps side by side from p0, as
    `fit_adam` takes them: per step the loss gap and, per leaf, the
    gradient gap and where the parameters part."""
    lr = inspect.signature(BayesianGPLVM.fit).parameters["lr"].default
    config = AdamConfig(lr=lr, clip_norm=None, weight_decay=0.0)
    params = {bwd: p0 for bwd in models}
    state = {bwd: adam_init(p0, config) for bwd in models}
    for step in range(steps):
        loss, grads = {}, {}
        for bwd, model in models.items():
            loss[bwd], grads[bwd] = inference.value_and_grad(model._loss, params[bwd], (Y,))
            params[bwd], state[bwd], _ = adam_update(grads[bwd], state[bwd],
                                                     params[bwd], config)
        gap = abs(float(loss["auto"]) - float(loss["jnp"])) / abs(float(loss["jnp"]))
        log(f"[train] {what} step {step}: loss rel gap {gap:.3e}")
        for name, a in _leaves(params["auto"]).items():
            b = _leaves(params["jnp"])[name]
            ga, gb = _leaves(grads["auto"])[name], _leaves(grads["jnp"])[name]
            diff = (a.double() - b.double()).abs().flatten()
            i = int(diff.argmax())
            log(f"[train]   {name} ({str(a.dtype)[6:]}): gradient rel gap "
                f"{rel_err(ga, gb):.3e}; after the step {int((diff > 0).sum())} of "
                f"{diff.numel()} entries differ, most {float(diff[i]):.3e} at {i} "
                f"(max|leaf| {float(a.abs().max()):.4g}; its gradients "
                f"{float(ga.flatten()[i]):.6e} / {float(gb.flatten()[i]):.6e})")


def grid_params(Y) -> dict:
    """The GP-LVM's own init on Y with its inducing points moved onto a
    grid over the latent means, 0.75 lengthscales apart: float64 is exact
    there to ~1e-12."""
    M = PAPER[1]
    p0 = BayesianGPLVM(M=M, Q=1, device="cuda").init_params(Y)
    lo, hi = float(p0["q_mu"].min()), float(p0["q_mu"].max())
    p0["Z"] = torch.linspace(lo, hi, M, device="cuda", dtype=torch.float64)[:, None]
    p0["kern"]["log_lengthscale"].fill_(float(np.log((hi - lo) / (M - 1) / 0.75)))
    return p0


def compare_bwd_paths(data: dict) -> None:
    """The float64 GP-LVM through the reverse kernel against the same
    model through the plain reverse pass, at two parameter sets:

    * the facade's own init (Z drawn from q(X): 100 points within ~3.4
      lengthscales). Its cotangents g2 are large and cancel, so no float64
      reverse pass is exact there: both passes are held against an
      extended-precision one (EXT_RATIO); their gradients and COMPARE_STEPS
      Adam steps side by side are traced, not held (Adam's first steps are
      ~lr sign(g), so where a gradient entry is below that floor the two
      runs part by O(lr));
    * inducing points on a grid over the latent means, 0.75 lengthscales
      apart: the same extended-precision check, the gradients held to TOL,
      then COMPARE_STEPS steps of the facade's `fit`, losses and
      parameters held within TRAJ_TOL."""
    Y = _as(data["Y_lvm"], torch.float64)
    M = PAPER[1]
    models = {bwd: BayesianGPLVM(M=M, Q=1, backend="fused", bwd_backend=bwd,
                                 device="cuda") for bwd in ("auto", "jnp")}
    p_init = BayesianGPLVM(M=M, Q=1, device="cuda").init_params(Y)
    trace_trajectories(models, p_init, Y, COMPARE_STEPS, "float64 gplvm from its init")
    compare_grads(models, p_init, Y, "float64 gplvm at its init", hold=False)

    p0 = grid_params(Y)
    compare_grads(models, p0, Y, "float64 gplvm on the grid", hold=True)
    for bwd, model in models.items():
        before = ss.BWD_LAUNCHES
        model.fit(Y, steps=COMPARE_STEPS, log_every=1, params=p0)
        torch.cuda.synchronize()
        check(ss.BWD_LAUNCHES - before == (COMPARE_STEPS if bwd == "auto" else 0),
              f"bwd_backend={bwd}: reverse kernel launches")
    kernel, plain = models["auto"], models["jnp"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(kernel.history, plain.history))
    log(f"[train] float64 gplvm, {COMPARE_STEPS} steps, reverse kernel vs plain reverse "
        f"pass: loss rel err {loss_err:.3e} (tol {TRAJ_TOL:g})")
    check(loss_err <= TRAJ_TOL, f"trajectory losses differ by {loss_err:.3e}")
    for name, a in _leaves(kernel.params).items():
        err = rel_err(a, _leaves(plain.params)[name])
        log(f"[train]   parameter {name}: rel err {err:.3e} (tol {TRAJ_TOL:g})")
        check(err <= TRAJ_TOL, f"trajectory parameter {name} differs by {err:.3e}")


def phase_training(data: dict) -> dict:
    """Returns the fitted models and both kernels' launches per dtype."""
    result = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        zero_counts()
        t0 = time.perf_counter()
        models = fit_models(data, dtype)
        fwd, bwd = ss.LAUNCHES, ss.BWD_LAUNCHES
        check(sum(counts().values()) == fwd + bwd,
              f"{name}: the fused path launched another kernel than B1 and B2: {counts()}")
        log(f"[train] {name}: 2 models x {TRAIN_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s; {fwd} forward and {bwd} reverse "
            f"kernel launches")
        check(fwd == bwd == 2 * TRAIN_STEPS,
              f"{name}: expected one forward and one reverse launch per step")
        for key, model in models.items():
            h = model.history
            log(f"[train] {name} {key}: loss {h[0]:.6f} -> {h[-1]:.6f} over {len(h)} steps")
            check(len(h) == TRAIN_STEPS and all(np.isfinite(h)), f"{name} {key}: losses {h}")
            check(h[-1] < h[0], f"{name} {key}: the loss did not decrease")
        serve_fitted(models, dtype)
        check(ss.LAUNCHES == fwd + len(models) and ss.BWD_LAUNCHES == bwd,
              f"{name}: serving a fitted model should add one forward launch each")
        result[dtype] = {"models": models, "launches": {"fwd": fwd, "bwd": bwd}}
    compare_dtypes({dt: r["models"] for dt, r in result.items()})
    compare_bwd_paths(data)
    return result


@torch.no_grad()
def compare_dtypes(models: dict) -> None:
    """Each float32 fit against the float64 fit of the same data from the
    same init: both trajectories logged, and the float64 loss at the
    float32 fit's final parameters held to F32_DESCENT_SHARE of the
    float64 fit's descent."""
    failed = []
    for key in models[torch.float32]:
        m32, m64 = models[torch.float32][key], models[torch.float64][key]
        for dtype, m in ((torch.float32, m32), (torch.float64, m64)):
            log(f"[train] {str(dtype)[6:]} {key} losses: "
                + " ".join(f"{h:.6f}" for h in m.history))
        # each float32 leaf in the dtype of the float64 model's leaf
        p = {k: ({kk: vv.to(m64.params[k][kk].dtype) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(m64.params[k].dtype))
             for k, v in m32.params.items()}
        at_f32 = float(m64._loss(p, *m64._data))
        end64 = float(m64._loss(m64.params, *m64._data))
        start64 = m64.history[0]
        share = (start64 - at_f32) / (start64 - end64)
        log(f"[train] {key}: float64 loss from {start64:.6f} to {end64:.6f} after "
            f"{TRAIN_STEPS} float64 steps, to {at_f32:.6f} at the float32 fit's "
            f"parameters ({100 * share:.1f} % of the float64 descent; at least "
            f"{100 * F32_DESCENT_SHARE:.0f} % held)")
        if not share >= F32_DESCENT_SHARE:
            failed.append(f"{key} {100 * share:.1f} %")
    check(not failed, "float32 fits short of the float64 descent: " + ", ".join(failed))


# ---------------------------------------------------------------------------
# phase 6: the GP-LVM through backend="pallas" (kernels B3-B6)
# ---------------------------------------------------------------------------

PALLAS_KERNELS = ("psi1_fwd", "psi2_fwd", "psi1_bwd", "psi2_bwd")


def phase_pallas(data: dict) -> dict:
    """This slice's main path as a user drives it: a BayesianGPLVM through
    backend="pallas" fitted from its own init, TRAIN_STEPS Adam steps per
    dtype, then registered and served. Every counter is set to 0 just
    before each dtype's fit and read just after the fit and after serving.
    Returns the fitted models and the main path's launches per dtype."""
    result = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        zero_counts()
        t0 = time.perf_counter()
        model = BayesianGPLVM(M=PAPER[1], Q=1, backend="pallas", device="cuda").fit(
            _as(data["Y_lvm"], dtype), steps=TRAIN_STEPS, log_every=1)
        torch.cuda.synchronize()
        fit = counts()
        log(f"[pallas] {name}: {TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s; "
            f"launches {fit}")
        check(all(fit[k] == TRAIN_STEPS for k in PALLAS_KERNELS),
              f"{name}: expected one launch of each of B3-B6 per step, got {fit}")
        check(fit["suffstats_fwd"] == fit["suffstats_bwd"] == fit["kfu_fwd"] == 0,
              f"{name}: the pallas path launched the fused kernels or B7")
        h = model.history
        log(f"[pallas] {name} gplvm: loss {h[0]:.6f} -> {h[-1]:.6f} over {len(h)} steps")
        check(len(h) == TRAIN_STEPS and all(np.isfinite(h)), f"{name} pallas: losses {h}")
        check(h[-1] < h[0], f"{name} pallas: the loss did not decrease")
        serve_fitted({"gplvm_pallas": model}, dtype)
        torch.cuda.synchronize()
        served = counts()
        want = {k: fit[k] + (1 if k in ("psi1_fwd", "psi2_fwd") else 0) for k in fit}
        check(served == want, f"{name}: serving the fitted model should add one "
              f"psi1 and one psi2 launch, got {served} after {fit}")
        result[dtype] = {"model": model, "launches": served}
    compare_dtypes({dt: {"gplvm_pallas": r["model"]} for dt, r in result.items()})
    compare_backends(data)
    return result


def compare_backends(data: dict) -> None:
    """The float64 GP-LVM through backend="pallas" against the same model
    through backend="fused", loss and gradients at the same parameters:
    from the facade's own init (printed, not held: the loss's cotangents
    cancel there, PERF.md §6) and on the grid with every leaf in
    float64 (loss within TOL, each gradient leaf within BACKEND_GRAD_TOL).
    At both, the cotangents each path's reverse kernels receive are
    compared, and B6 + B4 are held against the extended-precision reverse
    pass on the pallas path's own cotangents (EXT_RATIO, as B2 is)."""
    Y = _as(data["Y_lvm"], torch.float64)
    models = {b: BayesianGPLVM(M=PAPER[1], Q=1, backend=b, device="cuda")
              for b in ("pallas", "fused")}
    p_init = models["fused"].init_params(Y)
    p_grid = tree_map(lambda t: t.double(), grid_params(Y))
    failed = []
    for what, params, hold in (("from its init", p_init, False),
                               ("on the grid", p_grid, True)):
        *pallas, a1, a2 = _grads_and_cotangents(models["pallas"], params, Y,
                                                ("psi1_bwd_cuda", "psi2_bwd_cuda"))
        *fused, af = _grads_and_cotangents(models["fused"], params, Y)
        res = {"pallas": pallas, "fused": fused}
        # the cotangents each path's loss hands its reverse kernels (psi2 is
        # bitwise the same from B1 and B3; psiY comes from other sums)
        log(f"[pallas] float64 gplvm {what}: g2 pallas vs fused rel err "
            f"{rel_err(a2[5], af[6]):.3e}; psi1 cotangent vs Y gY^T rel err "
            f"{rel_err(a1[5], af[2] @ af[7].T):.3e}")
        failed += check_extended_single(a1, a2, EXT_POINTS, f"float64 gplvm pallas {what}")
        with torch.no_grad():
            dz_op = ss.psi1_bwd_cuda(*a1)[2] + ss.psi2_bwd_cuda(*a2)[2]
            dz_fused = ss.suffstats_bwd_cuda(*af)[3]
        log(f"[pallas] float64 gplvm {what}: the ops' dZ, pallas vs fused rel err "
            f"{rel_err(dz_op, dz_fused):.3e} (max|dZ| {float(dz_fused.abs().max()):.4e}, "
            f"of the loss {float(res['fused'][1]['Z'].abs().max()):.4e})")
        loss_err = abs(float(res["pallas"][0]) - float(res["fused"][0])) / abs(float(res["fused"][0]))
        held = f"tol {TOL[torch.float64]:g}" if hold else "not held"
        log(f"[pallas] float64 gplvm {what}: loss pallas {float(res['pallas'][0]):.12f}, "
            f"fused {float(res['fused'][0]):.12f}, rel err {loss_err:.3e} ({held})")
        if hold and loss_err > TOL[torch.float64]:
            failed.append(f"loss {what} {loss_err:.3e}")
        for name, g in _leaves(res["pallas"][1]).items():
            err = rel_err(g, _leaves(res["fused"][1])[name])
            log(f"[pallas]   gradient {name} ({str(g.dtype)[6:]}): rel err {err:.3e} "
                f"({f'tol {BACKEND_GRAD_TOL:g}' if hold else 'not held'})")
            if hold and err > BACKEND_GRAD_TOL:
                failed.append(f"gradient {name} {what} {err:.3e}")
    check(not failed, "backend='pallas' vs 'fused': " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phase 7: the SGPR through backend="pallas" (kernel B7, B6 at S = 0)
# ---------------------------------------------------------------------------

SGPR_PALLAS_KERNELS = ("kfu_fwd", "psi1_bwd")


def phase_sgpr_pallas(data: dict) -> dict:
    """The SGPR's pallas path as a user drives it: a SparseGPRegression
    through backend="pallas" fitted from its own init, TRAIN_STEPS Adam
    steps per dtype, then registered and served. Every counter is set to 0
    just before each dtype's fit and read just after the fit and after
    serving. Returns the fitted models and the main path's launches per
    dtype."""
    result = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        zero_counts()
        t0 = time.perf_counter()
        model = SparseGPRegression(M=PAPER[1], backend="pallas", device="cuda").fit(
            _as(data["X"], dtype), _as(data["Y"], dtype), steps=TRAIN_STEPS, log_every=1)
        torch.cuda.synchronize()
        fit = counts()
        log(f"[sgpr-pallas] {name}: {TRAIN_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s; launches {fit}")
        check(all(fit[k] == (TRAIN_STEPS if k in SGPR_PALLAS_KERNELS else 0) for k in fit),
              f"{name}: expected one launch of B7 and of B6 per step and no other, "
              f"got {fit}")
        h = model.history
        log(f"[sgpr-pallas] {name} sgpr: loss {h[0]:.6f} -> {h[-1]:.6f} over {len(h)} steps")
        check(len(h) == TRAIN_STEPS and all(np.isfinite(h)), f"{name} sgpr pallas: losses {h}")
        check(h[-1] < h[0], f"{name} sgpr pallas: the loss did not decrease")
        serve_fitted({"sgpr_pallas": model}, dtype)
        torch.cuda.synchronize()
        served = counts()
        want = {k: fit[k] + (k == "kfu_fwd") for k in fit}
        check(served == want, f"{name}: serving the fitted model should add one B7 "
              f"launch, got {served} after {fit}")
        result[dtype] = {"model": model, "launches": served}
    compare_dtypes({dt: {"sgpr_pallas": r["model"]} for dt, r in result.items()})
    compare_sgpr_backends(data)
    return result


def compare_sgpr_backends(data: dict) -> None:
    """The float64 SGPR through backend="pallas" against the same model
    through backend="fused", loss and gradients at the same parameters:
    from the facade's own init (printed, not held) and on the data's grid
    of inducing points, 0.76 lengthscales apart, with every leaf in float64
    (loss within TOL, each gradient leaf within BACKEND_GRAD_TOL). Also
    prints whether the cotangent of K_fu reaches the op contiguous (else
    the op copies (N, M) once per step)."""
    X, Y = _as(data["X"], torch.float64), _as(data["Y"], torch.float64)
    models = {b: SparseGPRegression(M=PAPER[1], backend=b, device="cuda")
              for b in ("pallas", "fused")}
    p_init = tree_map(lambda t: t.double(), models["fused"].init_params(X, Y))
    p_grid = convert.params_from_numpy(data["params"], device="cuda", dtype=torch.float64)
    layouts = []
    real = ops._backward

    def spy(ctx, cotangents, plain, kernel):
        layouts.append((tuple(cotangents[0].shape), cotangents[0].is_contiguous()))
        return real(ctx, cotangents, plain, kernel)

    failed = []
    for what, params, hold in (("from its init", p_init, False),
                               ("on the grid", p_grid, True)):
        res = {}
        for backend, model in models.items():
            ops._backward = spy
            try:
                res[backend] = inference.value_and_grad(model._loss, params, (X, Y))
            finally:
                ops._backward = real
        loss_err = abs(float(res["pallas"][0]) - float(res["fused"][0])) / abs(float(res["fused"][0]))
        held = f"tol {TOL[torch.float64]:g}" if hold else "not held"
        log(f"[sgpr-pallas] float64 sgpr {what}: loss pallas {float(res['pallas'][0]):.12f}, "
            f"fused {float(res['fused'][0]):.12f}, rel err {loss_err:.3e} ({held})")
        if hold and loss_err > TOL[torch.float64]:
            failed.append(f"loss {what} {loss_err:.3e}")
        for name, g in _named(res["pallas"][1]).items():
            err = rel_err(g, _named(res["fused"][1])[name])
            log(f"[sgpr-pallas]   gradient {name} ({str(g.dtype)[6:]}): rel err {err:.3e} "
                f"({f'tol {BACKEND_GRAD_TOL:g}' if hold else 'not held'})")
            if hold and err > BACKEND_GRAD_TOL:
                failed.append(f"gradient {name} {what} {err:.3e}")
    log(f"[sgpr-pallas] the ops' output cotangents (shape, contiguous): {sorted(set(layouts))}")
    check(not failed, "sgpr backend='pallas' vs 'fused': " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phase 8: the data-parallel path (mesh=) on the one card
# ---------------------------------------------------------------------------

def _grid_problem() -> tuple:
    """The SGPR data (X, Y) in float64 on the card and the grid parameters,
    rebuilt from the seed (in each rank as in the parent)."""
    data = serving_data(PAPER[0], PAPER[1])
    params = convert.params_from_numpy(data["params"], device="cuda", dtype=torch.float64)
    return _as(data["X"], torch.float64), _as(data["Y"], torch.float64), params


def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu(), tree)


def _dp_rank(rank: int, world: int, backend: str, store: str, out: str,
             steps: int) -> None:
    """One rank of the data-parallel phase (a spawned child, on cuda:0):
    with W > 1 the loss and its gradients at the grid parameters; then
    `steps` Adam steps of the `mesh=` facade from them and the median
    step time; every result saved to `out`."""
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = distributed.make_gp_mesh()
        X, Y, params = _grid_problem()
        res = {}
        if world > 1:
            local = (distributed.shard(X, mesh), distributed.shard(Y, mesh))
            loss, grads = inference.value_and_grad(
                distributed.sgpr_loss_dist(mesh, backend="pallas"),
                distributed.shard_gp_params(params, mesh), local)
            res["loss"], res["grads"] = float(loss), _cpu(grads)
        zero_counts()
        model = SparseGPRegression(M=PAPER[1], backend="pallas", mesh=mesh, device="cuda")
        model.fit(X, Y, steps=steps, log_every=1, params=params)
        torch.cuda.synchronize()
        res["launches"] = counts()
        res["history"] = model.history
        res["params"] = _cpu(model.params)
        res["step_ms"] = step_ms(model)
        torch.save(res, Path(out) / f"{backend}_r{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, backend: str, steps: int, tmp: Path) -> list:
    """Spawn `world` ranks of `_dp_rank`, join them with a timeout, fail on a
    hang or a failed child; returns each rank's results."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, world, backend,
                                                str(tmp / f"store_{backend}"), str(tmp), steps))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [proc for proc in procs if proc.is_alive()]
        for proc in hung:
            proc.kill()
            proc.join(30)
    check(not hung, f"{backend} W={world}: {len(hung)} ranks still running after "
          f"{DP_TIMEOUT_S} s")
    check(all(proc.exitcode == 0 for proc in procs),
          f"{backend} W={world}: rank exit codes {[proc.exitcode for proc in procs]}")
    return [torch.load(tmp / f"{backend}_r{r}.pt") for r in range(world)]


def phase_data_parallel() -> dict:
    """Two gloo ranks against the single process, at the grid parameters in
    float64; then one NCCL rank. Returns the step times."""
    X, Y, params = _grid_problem()
    single = SparseGPRegression(M=PAPER[1], backend="pallas", device="cuda")
    want, want_g = inference.value_and_grad(single._loss, params, (X, Y))
    want, want_g = float(want), _named(_cpu(want_g))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        ranks = run_ranks(DP_WORLD, "gloo", DP_STEPS, tmp)
        nccl = run_ranks(1, "nccl", 1, tmp)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed = []
    for r, res in enumerate(ranks):
        err = abs(res["loss"] - want) / abs(want)
        log(f"[dp] gloo W={DP_WORLD} rank {r}: loss {res['loss']:.12f} vs single process "
            f"{want:.12f}, rel err {err:.3e} (tol {TOL[torch.float64]:g})")
        if err > TOL[torch.float64]:
            failed.append(f"rank {r} loss {err:.3e}")
        for name, g in _named(res["grads"]).items():
            err = rel_err(g, want_g[name])
            log(f"[dp]   rank {r} gradient {name}: rel err {err:.3e} "
                f"(tol {BACKEND_GRAD_TOL:g})")
            if err > BACKEND_GRAD_TOL:
                failed.append(f"rank {r} gradient {name} {err:.3e}")
            if not torch.equal(g, _named(ranks[0]["grads"])[name]):
                failed.append(f"rank {r} gradient {name} differs from rank 0's")
        launches = res["launches"]
        log(f"[dp] gloo W={DP_WORLD} rank {r}: {DP_STEPS} facade steps, losses "
            + " ".join(f"{h:.9f}" for h in res["history"]) + f"; launches {launches}")
        if any(launches[k] != (DP_STEPS if k in SGPR_PALLAS_KERNELS else 0)
               for k in launches):
            failed.append(f"rank {r} launches {launches}")
        if not all(np.isfinite(res["history"])):
            failed.append(f"rank {r} losses {res['history']}")
        for path, a, b in zip(*flatten(res["params"]), flatten(ranks[0]["params"])[1]):
            if not torch.equal(a, b):
                failed.append(f"rank {r} parameter {path} differs from rank 0's after "
                              f"{DP_STEPS} steps")
    log(f"[dp] gloo W={DP_WORLD}: global parameters after {DP_STEPS} Adam steps bitwise "
        f"equal on every rank: {not any('parameter' in f for f in failed)}")
    log(f"[dp] nccl W=1: 1 facade step, loss {nccl['history'][0]:.12f}; launches "
        f"{nccl['launches']}")
    if not (len(nccl["history"]) == 1 and np.isfinite(nccl["history"][0])):
        failed.append(f"nccl losses {nccl['history']}")
    check(not failed, "data-parallel path: " + "; ".join(failed))
    return {"gloo": [res["step_ms"] for res in ranks], "nccl": nccl["step_ms"]}


# ---------------------------------------------------------------------------
# phase 9: float32 fits repeat bit for bit
# ---------------------------------------------------------------------------

REPEAT_MODELS = ("gplvm", "sgpr")
REPEAT_BACKENDS = ("fused", "pallas")


def _facade(key: str, backend: str):
    if key == "gplvm":
        return BayesianGPLVM(M=PAPER[1], Q=1, backend=backend, device="cuda")
    return SparseGPRegression(M=PAPER[1], backend=backend, device="cuda")


def _repeat_args(data: dict, key: str) -> tuple:
    dt = torch.float32
    if key == "gplvm":
        return (_as(data["Y_lvm"], dt),)
    return _as(data["X"], dt), _as(data["Y"], dt)


def _fit_from(key: str, backend: str, args: tuple, init: dict):
    model = _facade(key, backend).fit(*args, steps=TRAIN_STEPS, log_every=1,
                                      params=tree_map(torch.clone, init))
    torch.cuda.synchronize()
    return model


def _repeat_child(out: str, deterministic: bool) -> None:
    """A fresh process's side of phase 9 (a spawned child on cuda:0): the
    data again from the seed, then each facade x backend's init and one
    float32 fit from it, saved to `out`. `deterministic`: with
    CUBLAS_WORKSPACE_CONFIG set before any CUDA work (it shrinks cuBLAS's
    workspace, so only such a child sets it) and under
    torch.use_deterministic_algorithms(True), two fits each instead, and
    the leaves in which they differ or the error that names an op with no
    deterministic variant."""
    if deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
    torch.cuda.set_device(0)
    data = serving_data(PAPER[0], PAPER[1])
    res = {}
    for key in REPEAT_MODELS:
        args = _repeat_args(data, key)
        for backend in REPEAT_BACKENDS:
            init = _facade(key, backend).init_params(*args)
            if deterministic:
                try:
                    fits = [_fit_from(key, backend, args, init) for _ in range(2)]
                    res[key, backend] = _differing(fits[0].params, fits[1].params) or "none"
                except RuntimeError as e:
                    res[key, backend] = str(e)
            else:
                fit = _fit_from(key, backend, args, init)
                res[key, backend] = {"init": _cpu(init), "params": _cpu(fit.params),
                                     "history": fit.history}
    torch.save(res, out)


def _repeat_in_child(deterministic: bool) -> dict:
    """`_repeat_child`'s results from a spawned process, joined with a timeout."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "child.pt")
        proc = multiprocessing.get_context("spawn").Process(target=_repeat_child,
                                                            args=(path, deterministic))
        proc.start()
        proc.join(DP_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join(30)
        check(proc.exitcode == 0, f"the repeatability child exited with {proc.exitcode}")
        return torch.load(path)


def _differing(a: dict, b: dict) -> list:
    """Names of the leaves of two parameter trees that are not bitwise
    equal (compared on the CPU)."""
    na, nb = _named(_cpu(a)), _named(_cpu(b))
    return [k for k in na if not torch.equal(na[k], nb[k])]


def phase_repeatability(data: dict) -> dict:
    """Float32 fits of each facade x backend at the paper's shape, from
    their own init: two in this process from one init, and one in a fresh
    spawned process from its own (its data rebuilt from the seed). Every
    fitted parameter and every logged loss must be bitwise equal, and so
    must the two processes' inits. Where they are not, a fresh process fits
    each twice again under torch.use_deterministic_algorithms(True), which
    names an op that has no deterministic variant. Returns (model, backend)
    -> the leaves that differ."""
    child = _repeat_in_child(deterministic=False)
    failed, out = [], {}
    for key in REPEAT_MODELS:
        args = _repeat_args(data, key)
        for backend in REPEAT_BACKENDS:
            what = f"float32 {key} {backend}"
            init = _facade(key, backend).init_params(*args)
            fits = [_fit_from(key, backend, args, init) for _ in range(2)]
            theirs = child[key, backend]
            diff = {"init, this process vs a fresh one": _differing(init, theirs["init"]),
                    "two fits from one init": _differing(fits[0].params, fits[1].params),
                    "fit, this process vs a fresh one": _differing(fits[0].params,
                                                                   theirs["params"])}
            same_losses = fits[0].history == fits[1].history == theirs["history"]
            for name, leaves in diff.items():
                log(f"[repeat] {what}: {name}: leaves that differ: {leaves or 'none'}")
            log(f"[repeat] {what}: the {TRAIN_STEPS} logged losses of the three fits "
                f"{'are bitwise equal' if same_losses else 'differ'}")
            if any(diff.values()) or not same_losses:
                failed.append((key, backend))
            out[key, backend] = diff
    if failed:
        again = _repeat_in_child(deterministic=True)
        for key, backend in failed:
            log(f"[repeat] float32 {key} {backend}, a fresh process under "
                f"use_deterministic_algorithms: {again[key, backend]}")
    check(not failed, "float32 fits are not bitwise repeatable: "
          + ", ".join(f"{k} {b}" for k, b in failed))
    return out


# ---------------------------------------------------------------------------
# phase 10: every kernel above Q = 16, and half precision through the ops
# ---------------------------------------------------------------------------

LARGE_Q = (20_000, 64, 20, 3)  # N, M, Q, D
HALF_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}  # one rounding to the half type


def large_q_inputs(N, M, Q, D, seed=SEED):
    """kernel_inputs with lengthscales grown by sqrt(Q): a 20-term exponent
    keeps the statistics well above underflow."""
    x = kernel_inputs(N, M, Q, D, True, seed)
    x[5] = x[5] * float(np.sqrt(Q))
    return x


def phase_large_q() -> dict:
    """All seven kernels at Q = 20 (the run-time-Q instances; B1-B4's wide
    pair and point passes, B6's chunked moments) against their plain
    versions in float64 on the card, both dtypes, two launches bitwise
    equal, then timed. Returns the max relative error per (kernel, dtype)."""
    N, M, Q, D = LARGE_Q
    mu, S, Y, Z, v, l = large_q_inputs(N, M, Q, D)
    g2, gY = bwd_cotangents(M, D)
    g = random_g(N, M)
    cases = {"suffstats_fwd": (ss.suffstats_cuda, ss.suffstats_fused_plain, (mu, S, Y, Z, v, l)),
             "suffstats_bwd": (ss.suffstats_bwd_cuda, ss.suffstats_vjp_plain,
                               (mu, S, Y, Z, v, l, g2, gY)),
             "psi2_fwd": (p2.psi2_cuda, p2.psi2_plain, (mu, S, Z, v, l)),
             "psi2_bwd": (ss.psi2_bwd_cuda, ss.psi2_vjp_plain, (mu, S, Z, v, l, g2)),
             "psi1_fwd": (p1.psi1_cuda, p1.psi1_plain, (mu, S, Z, v, l)),
             "psi1_bwd": (ss.psi1_bwd_cuda, ss.psi1_vjp_plain, (mu, S, Z, v, l, g)),
             "kfu_fwd": (kf.kfu_cuda, kf.kfu_plain, (mu, Z, v, l))}
    saved, errs = counts(), {}
    for name, (kernel, plain, args) in cases.items():
        want = _as_tuple(plain(*args))
        for dt, tol in TOL.items():
            xs = [a.to(dt) for a in args]
            got, again = _as_tuple(kernel(*xs)), _as_tuple(kernel(*xs))
            torch.cuda.synchronize()
            r = max(rel_err(a, w) for a, w in zip(got, want))
            errs[name, dt] = r
            ms = cuda_ms(lambda: kernel(*xs), reps=5, inner=KERNEL_INNER)
            log(f"[large-q] {name} N={N} M={M} Q={Q} D={D} {str(dt)[6:]}: max rel err "
                f"{r:.3e} (tol {tol:g}); {ms:.3f} ms (median of 5 x {KERNEL_INNER} launches)")
            check(all(bool(torch.isfinite(a).all()) for a in got), f"Q={Q} {name} not finite")
            check(r <= tol, f"Q={Q} {name} {dt}: rel err {r:.3e} > {tol:g}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"Q={Q} {name} {dt}: two runs differ")
    set_counts(saved)  # checks, not a main path
    return errs


def phase_half() -> None:
    """bfloat16 and float16 inputs through ops.suffstats, psi1, psi2 and
    kfu on the card: forward and reverse through the kernels in float32,
    outputs and cotangents in the half type, each within one rounding of
    the float32 plain version on the same half-rounded inputs."""
    N, M, Q, D = 20_003, 100, 1, 3  # float16's range holds psi2's sum over N
    x64 = kernel_inputs(N, M, Q, D, True)
    cot = {"g": random_g(N, M), "g2": bwd_cotangents(M, D)[0], "gY": bwd_cotangents(M, D)[1]}
    opset = {"suffstats": (ops.suffstats, ss.suffstats_fused_plain, ss.suffstats_vjp_plain,
                           (0, 1, 2, 3, 4, 5), ("g2", "gY")),
             "psi1": (ops.psi1, p1.psi1_plain, ss.psi1_vjp_plain, (0, 1, 3, 4, 5), ("g",)),
             "psi2": (ops.psi2, p2.psi2_plain, ss.psi2_vjp_plain, (0, 1, 3, 4, 5), ("g2",)),
             "kfu": (ops.kfu, kf.kfu_plain, ss.kfu_vjp_plain, (0, 3, 4, 5), ("g",))}
    saved = counts()
    for half, tol in HALF_TOL.items():
        for name, (op, plain, plain_vjp, idx, cots) in opset.items():
            args = [x64[i].to(half) for i in idx]
            gs = [cot[c].to(half) for c in cots]
            leaves = [a.clone().requires_grad_(True) for a in args]
            before = counts()
            out = _as_tuple(op(*leaves))
            grads = torch.autograd.grad(sum((o * g).sum() for o, g in zip(out, gs)), leaves)
            torch.cuda.synchronize()
            launched = sum(counts().values()) - sum(before.values())
            want = _as_tuple(plain(*(a.float() for a in args)))
            want_g = plain_vjp(*(a.float() for a in args), *(g.float() for g in gs))
            r = max(rel_err(o, w.to(half)) for o, w in zip((*out, *grads), (*want, *want_g)))
            log(f"[half] ops.{name} {str(half)[6:]} N={N} M={M}: {launched} kernel launches, "
                f"outputs and cotangents in {str(half)[6:]}, max rel err {r:.3e} vs the "
                f"float32 plain version cast back (tol {tol:g})")
            check(launched == 2, f"{name} {half}: expected a forward and a reverse launch")
            check(all(t.dtype == half for t in (*out, *grads)), f"{name} {half}: dtypes")
            check(r <= tol, f"{name} {half}: rel err {r:.3e} > {tol:g}")
    set_counts(saved)


# ---------------------------------------------------------------------------
# phase 11: the kernel family (Product, Sum, Matern) at the paper's shape
# ---------------------------------------------------------------------------

FAMILY_STEPS = 5  # Adam steps of each Product-of-RBFs fit
FAMILY_JNP_STEPS = 3  # of the Sum GP-LVM and the Matern SGPR
PRODUCT_KERNELS = {"fused": ("suffstats_fwd", "suffstats_bwd"),
                   "pallas": ("psi1_fwd", "psi2_fwd", "psi1_bwd", "psi2_bwd")}
FAMILY_GRAD_TOL = 1e-8  # each gradient leaf vs the single RBF's


def product_params(p_rbf: dict) -> dict:
    """Product(RBF, RBF) parameters equal to the single RBF's `p_rbf`: part
    0 takes 0.6 of the log-variance and 1.5 lengthscales, part 1 the rest
    (1 / l1^2 = 1 / l^2 - 1 / l0^2)."""
    log_var, log_ls = p_rbf["kern"]["log_variance"], p_rbf["kern"]["log_lengthscale"]
    log_l0 = log_ls + np.log(1.5)
    log_l1 = -0.5 * torch.log(torch.exp(-2.0 * log_ls) - torch.exp(-2.0 * log_l0))
    return {**p_rbf, "kern": {
        "k0": {"log_variance": 0.6 * log_var, "log_lengthscale": log_l0},
        "k1": {"log_variance": 0.4 * log_var, "log_lengthscale": log_l1}}}


def hold_product_to_rbf(product, rbf, params: dict, Y, what: str, *,
                        hold: bool = True) -> None:
    """The Product-of-RBFs GP-LVM's loss and gradients at `params` against
    the single RBF's at the equivalent hyperparameters: the loss within
    TOL, every shared leaf's gradient and each part's kernel gradient (the
    RBF's through the chain rule of the delegation) within FAMILY_GRAD_TOL
    where `hold`. The statistics are the RBF's bit for bit; Kuu is not (a
    product of two exponentials against one), so away from the grid the
    epilogue's conditioning shows in the Z gradient, and there the errors
    are printed only."""
    kern_rbf, eq = product.kernel._equivalent_rbf(params["kern"])
    p_rbf = {**params, "kern": {k: v.detach() for k, v in eq.items()}}
    loss_p, g_p = inference.value_and_grad(product._loss, params, (Y,))
    loss_r, g_r = inference.value_and_grad(rbf._loss, p_rbf, (Y,))
    errs = {"loss": abs(float(loss_p) - float(loss_r)) / abs(float(loss_r))}
    for k in ("Z", "log_beta", "q_mu", "q_logS"):
        errs[k] = rel_err(g_p[k], g_r[k])
    parts = params["kern"]
    inv_l2 = sum(torch.exp(-2.0 * parts[s]["log_lengthscale"]) for s in parts)
    for s in parts:
        errs[f"{s}/log_variance"] = rel_err(g_p["kern"][s]["log_variance"],
                                            g_r["kern"]["log_variance"])
        share = torch.exp(-2.0 * parts[s]["log_lengthscale"]) / inv_l2
        errs[f"{s}/log_lengthscale"] = rel_err(g_p["kern"][s]["log_lengthscale"],
                                               g_r["kern"]["log_lengthscale"] * share)
    log(f"[family] {what}: vs a single RBF at the equivalent hyperparameters "
        f"({'held' if hold else 'not held'}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not hold:
        return
    bad = {k: v for k, v in errs.items()
           if v > (TOL[torch.float64] if k == "loss" else FAMILY_GRAD_TOL)}
    check(not bad, f"{what}: Product of RBFs vs the single RBF {bad}")


def phase_kernel_family(data: dict) -> dict:
    """The rest of the kernel family as a user drives it, in float64 at the
    paper's shape: a BayesianGPLVM with a Product of two RBFs through
    backend="fused" and then "pallas" (FAMILY_STEPS Adam steps each, from
    the grid parameters split over the parts; every counter set to 0 just
    before each fit and read just after: one launch of each of the
    backend's kernels a step), held to the single RBF on the grid (and
    printed after the fit); a BayesianGPLVM with Sum(RBF, Linear) and a SparseGPRegression
    with Matern32 through "jnp" (FAMILY_JNP_STEPS steps from their own
    init, no kernel launched); then every fitted model served at B = 1 and
    256 and refitted. Returns the Product fits' launches by kernel."""
    f64 = torch.float64
    Y = _as(data["Y_lvm"], f64)
    p_grid = tree_map(lambda t: t.double(), grid_params(Y))
    product_kernel = get("product")(get("rbf")(1), get("rbf")(1))
    launches = {name: 0 for name in COUNTERS}
    fitted = {}
    for backend, kernels in PRODUCT_KERNELS.items():
        rbf = BayesianGPLVM(M=PAPER[1], backend=backend, device="cuda")
        rbf.kernel = get("rbf")(1)
        product = BayesianGPLVM(kernel=product_kernel, M=PAPER[1], backend=backend,
                                device="cuda")
        p0 = product_params(p_grid)
        hold_product_to_rbf(product, rbf, p0, Y, f"{backend} on the grid")
        zero_counts()
        t0 = time.perf_counter()
        product.fit(Y, steps=FAMILY_STEPS, log_every=1, params=p0)
        torch.cuda.synchronize()
        fit = counts()
        log(f"[family] product of RBFs, {backend}: {FAMILY_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s; launches {fit}")
        check(all(fit[k] == (FAMILY_STEPS if k in kernels else 0) for k in fit),
              f"product {backend}: expected one launch of each of {kernels} a step "
              f"and no other kernel, got {fit}")
        for k, v in fit.items():
            launches[k] += v
        h = product.history
        log(f"[family] product {backend}: loss {h[0]:.9f} -> {h[-1]:.9f} over {len(h)} steps")
        check(len(h) == FAMILY_STEPS and all(np.isfinite(h)) and h[-1] < h[0],
              f"product {backend}: losses {h}")
        hold_product_to_rbf(product, rbf, product.params, Y, f"{backend} after the fit",
                            hold=False)
        # the step against the single RBF's at the equivalent hyperparameters,
        # in turns: product, RBF, RBF, product
        eq = product.kernel._equivalent_rbf(product.params["kern"])[1]
        rbf.params = {**product.params, "kern": {k: v.detach() for k, v in eq.items()}}
        rbf._data = product._data
        ms = [step_ms(m) for m in (product, rbf, rbf, product)]
        log(f"[time] training step float64 gplvm {backend} (N={PAPER[0]}, M={PAPER[1]}): "
            f"Product(RBF, RBF) {ms[0]:.3f}, {ms[3]:.3f} ms; the single RBF {ms[1]:.3f}, "
            f"{ms[2]:.3f} ms (median of {TIMED_STEPS - 1} after the first, in turns)")
        fitted[f"gplvm_product_{backend}"] = product
    zero_counts()
    lvm = BayesianGPLVM(kernel=get("sum")(get("rbf")(1), get("linear")(1)),
                        M=PAPER[1], device="cuda")
    p_sum = tree_map(lambda t: t.double(), lvm.init_params(Y))
    t0 = time.perf_counter()
    lvm.fit(Y, steps=FAMILY_JNP_STEPS, log_every=1, params=p_sum)
    torch.cuda.synchronize()
    log(f"[family] gplvm Sum(RBF, Linear) jnp: {FAMILY_JNP_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s; loss {lvm.history[0]:.6f} -> {lvm.history[-1]:.6f}")
    X, Ys = _as(data["X"], f64), _as(data["Y"], f64)
    sgpr = SparseGPRegression(kernel=get("matern32")(1), M=PAPER[1], device="cuda")
    p_m = tree_map(lambda t: t.double(), sgpr.init_params(X, Ys))
    t0 = time.perf_counter()
    sgpr.fit(X, Ys, steps=FAMILY_JNP_STEPS, log_every=1, params=p_m)
    torch.cuda.synchronize()
    log(f"[family] sgpr Matern32 jnp: {FAMILY_JNP_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s; loss {sgpr.history[0]:.6f} -> {sgpr.history[-1]:.6f}")
    for key, model in (("gplvm Sum", lvm), ("sgpr Matern32", sgpr)):
        h = model.history
        check(len(h) == FAMILY_JNP_STEPS and all(np.isfinite(h)) and h[-1] < h[0],
              f"{key}: losses {h}")
    check(all(v == 0 for v in counts().values()),
          f"the Sum and Matern fits launched a kernel: {counts()}")
    fitted.update({"gplvm_sum": lvm, "sgpr_matern32": sgpr})
    serve_fitted(fitted, f64)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the temporal backend (Matern-3/2, float64 timestamps)
# ---------------------------------------------------------------------------

TEMPORAL_N = 1_000_000
TEMPORAL_STEPS = 10
TEMPORAL_CHECK_N = 4096  # parallel vs sequential, and vs the dense lml
STREAM_CHUNKS, STREAM_CHUNK = 10, 2500
TEMPORAL_TOL = 1e-10  # parallel vs sequential filter and smoother; streamed vs one-shot
TEMPORAL_LML_TOL = 1e-8  # vs exact_gp_log_marginal, relative
# peak device memory of the fit, bounded by O(N d^2): this many float64
# (d, d) matrices a point (the autograd graph saves ~41 at d = 2)
TEMPORAL_MEM_MATRICES = 256
FORECAST_BATCHES = (1, 64)


def temporal_series(n: int, seed: int = SEED):
    """examples/torch_temporal_quickstart.py's series: gaps uniform in
    [0.5e-3, 1.5e-3], f = sin(2 pi 0.8 t), Y = f + N(0, 0.1^2), float64."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5e-3, 1.5e-3, n))[:, None]
    f = np.sin(2.0 * np.pi * 0.8 * t[:, 0])
    return t, (f + 0.1 * rng.standard_normal(n))[:, None]


def _abs_err(a, b) -> float:
    return float((a - b).abs().max())


def temporal_checks(model, t, Y) -> None:
    """At the fitted parameters on the first TEMPORAL_CHECK_N points: the
    parallel filter and smoother against the sequential ones, and the lml
    against the dense O(N^3) marginal."""
    from repro_torch.core.svgp import exact_gp_log_marginal
    from repro_torch.temporal import rts_smoother

    n = TEMPORAL_CHECK_N
    params = tree_map(lambda p: p.detach().double(), model.params)
    tc, Yc = t[:n, 0], Y[:n]
    with torch.no_grad():
        out = {}
        for parallel in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, A, Q, res = model._filter(params, tc, Yc, parallel=parallel)
            sm = rts_smoother(A, Q, res.means, res.covs, parallel=parallel)
            torch.cuda.synchronize()
            out[parallel] = (res, sm, (time.perf_counter() - t0) * 1e3)
        (par, spar, ms_p), (seq, sseq, ms_s) = out[True], out[False]
        errs = {"means": _abs_err(par.means, seq.means), "covs": _abs_err(par.covs, seq.covs),
                "smoothed means": _abs_err(spar[0], sseq[0]),
                "smoothed covs": _abs_err(spar[1], sseq[1]),
                "lml": abs(float(par.lml) - float(seq.lml)) / abs(float(seq.lml))}
        Kff = model.kernel.K(params["kern"], tc[:, None])
        dense = exact_gp_log_marginal(Kff, Yc, torch.exp(params["log_beta"]), jitter=0.0)
        lml_err = abs(float(par.lml) - float(dense)) / abs(float(dense))
    log(f"[temporal] N={n}: parallel vs sequential " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()) + f"; lml {float(par.lml):.9f} vs dense "
        f"{float(dense):.9f}, rel err {lml_err:.2e}")
    log(f"[time] temporal filter + smoother at N={n}: parallel {ms_p:.1f} ms, sequential "
        f"{ms_s:.1f} ms ({ms_s / n * 1e3:.1f} us a point)")
    check(all(v <= TEMPORAL_TOL for v in errs.values()),
          f"parallel vs sequential filter/smoother: {errs}")
    check(lml_err <= TEMPORAL_LML_TOL, f"lml vs the dense marginal {lml_err:.3e}")


def phase_temporal() -> dict:
    """The temporal backend as a user drives it: regression(backend=
    "temporal") with Matern-3/2 fitted on the temporal quickstart's series
    at N = 1e6 (TEMPORAL_STEPS Adam steps on the parallel path, float32
    hyperparameters, float64 timestamps; peak memory held to an O(N d^2)
    bound), the checks at TEMPORAL_CHECK_N, then serving: the fitted
    model's state registered with a GPServer and forecast at B = 1 and 64,
    and a state over the first TEMPORAL_CHECK_N points (sequential export)
    streamed the next STREAM_CHUNKS x STREAM_CHUNK points through
    `update`, held to a one-shot sequential filter over the concatenated
    series. No kernel of B1-B7 is launched. Returns the times."""
    from repro_torch.gp import regression
    from repro_torch.temporal import TemporalGPRegression, forecast

    n_all = TEMPORAL_N + STREAM_CHUNKS * STREAM_CHUNK
    t_np, Y_np = temporal_series(n_all)
    t, Y = (torch.as_tensor(a, device="cuda") for a in (t_np, Y_np))
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = regression(get("matern32")(1), backend="temporal", device="cuda")
    t0 = time.perf_counter()
    model.fit(t[:TEMPORAL_N], Y[:TEMPORAL_N], steps=TEMPORAL_STEPS, lr=5e-2, log_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    d = 2
    bound = TEMPORAL_MEM_MATRICES * TEMPORAL_N * d * d * 8
    h = model.history
    log(f"[temporal] fit N={TEMPORAL_N}: {TEMPORAL_STEPS} steps in {fit_s:.1f} s; loss "
        f"{h[0]:.6f} -> {h[-1]:.6f}; peak device memory {peak / 2**30:.3f} GiB "
        f"({peak / TEMPORAL_N:.0f} bytes a point) vs the bound {TEMPORAL_MEM_MATRICES} "
        f"float64 (d, d) matrices a point = {bound / 2**30:.3f} GiB")
    check(len(h) == TEMPORAL_STEPS and all(np.isfinite(h)) and h[-1] < h[0],
          f"temporal fit: losses {h}")
    check(peak <= bound, f"temporal fit peak memory {peak} > {bound}")
    times = {"fit_s": fit_s, "peak_bytes": peak, "step_ms": step_ms(model)}
    # the scan's first level: N/2 batched (d, d) solves and products
    rng = np.random.default_rng(SEED + 3)
    A2, B2 = (torch.as_tensor(rng.normal(size=(TEMPORAL_N // 2, d, d)) + 3.0 * np.eye(d),
                              device="cuda") for _ in range(2))
    solve_ms = cuda_ms(lambda: torch.linalg.solve(A2, B2), reps=5)
    matmul_ms = cuda_ms(lambda: A2 @ B2, reps=5)
    log(f"[time] temporal scan level ({TEMPORAL_N // 2} float64 ({d}, {d}) matrices): "
        f"torch.linalg.solve {solve_ms:.3f} ms, a batched product {matmul_ms:.3f} ms "
        f"(bytes bound of the product {3 * A2.numel() * 8 / roofline.HBM_BYTES_PER_S * 1e3:.3f} ms)")
    times.update(solve_ms=solve_ms, matmul_ms=matmul_ms)
    temporal_checks(model, t, Y)
    params = tree_map(lambda p: p.detach(), model.params)
    with GPServer(device="cuda") as srv:
        srv.register("temporal", model)
        state = srv.state("temporal")
        Xf = float(state.t_last) + torch.linspace(1e-3, 0.2, 64, device="cuda",
                                                  dtype=torch.float64)[:, None]
        want = forecast(model.kernel, state, Xf)
        for B in FORECAST_BATCHES:
            mean, var = srv.predict("temporal", Xf[:B])
            check(mean.shape == (B, 1) and var.shape == (B,), f"forecast B={B} shape")
            check(bool(torch.isfinite(mean).all() and (var > 0).all()),
                  f"forecast B={B}: not finite or not positive")
            check(_abs_err(mean, want[0][:B]) <= 1e-14, f"forecast B={B} vs forecast()")
            times[f"p50_{B}"] = predict_p50_ms(srv, "temporal", Xf, B)
        n0 = TEMPORAL_CHECK_N
        first = TemporalGPRegression(model.kernel, parallel=False, device="cuda")
        first.fit(t[:n0], Y[:n0], steps=0, params=params)
        srv.register("stream", first)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STREAM_CHUNKS):
            lo = TEMPORAL_N + i * STREAM_CHUNK
            srv.update("stream", t[lo:lo + STREAM_CHUNK], Y[lo:lo + STREAM_CHUNK])
        torch.cuda.synchronize()
        streamed = STREAM_CHUNKS * STREAM_CHUNK
        times["update_us"] = (time.perf_counter() - t0) / streamed * 1e6
        state = srv.state("stream")
    t_cat = torch.cat([t[:n0], t[TEMPORAL_N:]])
    Y_cat = torch.cat([Y[:n0], Y[TEMPORAL_N:]])
    with torch.no_grad():
        one_shot = first._filter(params, t_cat[:, 0], Y_cat, parallel=False)[3]
    errs = (_abs_err(state.m, one_shot.means[-1]), _abs_err(state.P, one_shot.covs[-1]))
    log(f"[temporal] streamed {streamed} points in {STREAM_CHUNKS} updates after "
        f"{n0}: vs a one-shot sequential filter over the {n0 + streamed} points m "
        f"{errs[0]:.2e}, P {errs[1]:.2e}; n {int(state.n)}")
    check(max(errs) <= TEMPORAL_TOL and int(state.n) == n0 + streamed,
          f"streamed state vs one-shot: {errs}, n {int(state.n)}")
    check(all(v == 0 for v in counts().values()),
          f"the temporal path launched a kernel: {counts()}")
    log(f"[time] temporal step (N={TEMPORAL_N}, Matern32, parallel): "
        f"{times['step_ms']:.3f} ms (median of {TIMED_STEPS - 1} after the first); "
        f"update {times['update_us']:.1f} us a point (sequential filter, "
        f"{STREAM_CHUNKS} chunks of {STREAM_CHUNK}); forecast p50 B=1 "
        f"{times['p50_1']:.3f} ms, B=64 {times['p50_64']:.3f} ms")
    return times


# ---------------------------------------------------------------------------
# phase 13: persistence — the budgeted GPServer, its store and a restart
# ---------------------------------------------------------------------------

PERSIST_CHILD_TIMEOUT_S = 300
PERSIST_KERNELS = ("suffstats_fwd", "kfu_fwd", "psi1_fwd", "psi2_fwd")  # B1, B7, B5, B3


def persistence_states(data: dict, dtype: torch.dtype, temporal) -> dict:
    """name -> (kernel, state) at the paper's shape in `dtype`: the SGPR's
    state through "fused" (B1) and "pallas" (B7), the GP-LVM's through
    "pallas" (B5, B3), a Product(RBF, RBF) GP-LVM's through "fused" (B1 at
    the equivalent RBF) and the temporal quickstart's state `temporal`."""
    def t(a):
        return torch.as_tensor(a, device="cuda", dtype=dtype)

    kernel = get("rbf")(1)
    params = convert.params_from_numpy(data["params"], device="cuda", dtype=dtype)
    exact = ExactBatch(t(data["X"]), t(data["Y"]), params["Z"])
    expected = ExpectedBatch(t(data["mu"]), t(data["S"]), t(data["Y_lvm"]), params["Z"])
    states = {}
    for name, batch, backend in (("sgpr-fused", exact, "fused"),
                                 ("sgpr-pallas", exact, "pallas"),
                                 ("gplvm-pallas", expected, "pallas")):
        stats = suff_stats(kernel, params["kern"], batch, backend=backend)
        states[name] = (kernel, build_state(kernel, params, stats))
    product = get("product")(get("rbf")(1), get("rbf")(1))
    p_prod = product_params(params)
    stats = suff_stats(product, p_prod["kern"], expected, backend="fused")
    states["product-fused"] = (product, build_state(product, p_prod, stats))
    states["temporal"] = temporal
    return states


def _persist_inputs(data: dict, states: dict, dtype: torch.dtype) -> dict:
    """Each model's request: 256 test inputs, or 64 timestamps past the
    temporal state's origin."""
    Xt = torch.as_tensor(data["Xt"][:256], device="cuda", dtype=dtype)
    t_last = float(states["temporal"][1].t_last)
    Xf = t_last + torch.linspace(1e-3, 0.2, 64, device="cuda", dtype=torch.float64)[:, None]
    return {name: Xf if name == "temporal" else Xt for name in states}


def _same_bits(a, b) -> bool:
    la, lb = ([t for _, t in flatten_with_keys(x)] for x in (a, b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _persist_child(store: str, inputs: str, out: str, budget: int) -> None:
    """A fresh process's side of the restart (a spawned child on cuda:0):
    `GPServer.load` of the store within `budget`, then every model's
    request; saves the answers and the server's metrics to `out`."""
    torch.cuda.set_device(0)
    requests = torch.load(inputs)
    srv = GPServer.load(store, budget_bytes=budget, device="cuda")
    cold = srv.metrics()
    answers = {name: tuple(a.cpu() for a in srv.predict(name, X.to("cuda")))
               for name, X in requests.items()}
    torch.save({"cold": cold, "answers": answers, "metrics": srv.metrics(),
                "models": srv.models()}, out)
    srv.close()


def _persist_in_child(store: Path, requests: dict, budget: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        inputs, out = str(Path(tmp) / "inputs.pt"), str(Path(tmp) / "out.pt")
        torch.save({k: v.cpu() for k, v in requests.items()}, inputs)
        proc = multiprocessing.get_context("spawn").Process(
            target=_persist_child, args=(str(store), inputs, out, budget))
        proc.start()
        proc.join(PERSIST_CHILD_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join(30)
        check(proc.exitcode == 0, f"the restart child exited with {proc.exitcode}")
        return torch.load(out)


def _ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def persistence_run(data: dict, dtype: torch.dtype, temporal, tmp: Path) -> dict:
    """One dtype of phase 13; returns the launches and the times."""
    name_dt = str(dtype)[6:]
    zero_counts()
    states = persistence_states(data, dtype, temporal)
    requests = _persist_inputs(data, states, dtype)
    sizes = sorted(s.nbytes for _, s in states.values())
    budget = sizes[-1] + sizes[-2]  # two states' bytes
    store = StateStore(tmp / f"store-{name_dt}")
    times = {}
    with GPServer(store=store, budget_bytes=budget, device="cuda") as srv:
        before = {}
        for name, (kernel, state) in states.items():
            srv.register(name, kernel=kernel, state=state)
            before[name] = srv.predict(name, requests[name])
        for lap in range(2):  # every access evicts the LRU state and reloads its own
            for name in states:
                got = srv.predict(name, requests[name])
                check(all(torch.equal(g, w) for g, w in zip(got, before[name])),
                      f"{name_dt} {name}: the answer after a lazy reload differs "
                      f"from the one before the eviction (lap {lap + 1})")
        m = srv.metrics()
        log(f"[persist] {name_dt}: {len(states)} models, budget {budget} bytes "
            f"(two states); metrics {m}")
        check(m["peak_resident_bytes"] <= budget and m["resident_bytes"] <= budget,
              f"{name_dt}: resident bytes over the budget {m}")
        check(m["evictions"] > 0 and m["lazy_loads"] > 0, f"{name_dt}: no eviction {m}")
        # update an evicted SGPR state: it reloads, then folds through B1
        check(srv._entry("sgpr-fused").state is None, "sgpr-fused is resident")
        loads = m["lazy_loads"]
        with GPServer(device="cuda") as plain:  # a server that never evicted
            plain.register("sgpr-fused", kernel=states["sgpr-fused"][0],
                           state=states["sgpr-fused"][1])
            plain.update("sgpr-fused", data["X_new"], data["Y_new"], backend="fused")
            want = plain.predict("sgpr-fused", requests["sgpr-fused"])
            want_state = plain.state("sgpr-fused")
        _, times["update_ms"] = _ms(lambda: srv.update(
            "sgpr-fused", data["X_new"], data["Y_new"], backend="fused"))
        check(srv.metrics()["lazy_loads"] == loads + 1, "update did not reload the state")
        check(_same_bits(srv.state("sgpr-fused"), want_state),
              f"{name_dt}: update on an evicted state differs from one never evicted")
        got = srv.predict("sgpr-fused", requests["sgpr-fused"])
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name_dt}: predictions after the update differ from a never-evicted server")
        log(f"[persist] {name_dt}: update of {UPDATE_N} points on the evicted sgpr-fused "
            f"state (reload + B1 + refold) bitwise equal to a server that never evicted")
        # times of the store's operations
        kernel, state = states["sgpr-pallas"]
        _, times["save_ms"] = _ms(lambda: store.save("timing", kernel, state))
        _, times["load_meta_ms"] = _ms(lambda: store.load_meta("timing"))
        _, times["load_ms"] = _ms(lambda: store.load("timing", device="cuda"))
        store.delete("timing")
        cold = next(n for n in states if srv._entry(n).state is None)
        _, times["lazy_reload_ms"] = _ms(lambda: srv.predict(cold, requests[cold]))
        saved, times["save_all_ms"] = _ms(srv.save_all)
        log(f"[persist] {name_dt}: save_all wrote {saved}")
        check(srv.save_all() == (), "a second save_all wrote again")
        after = {name: tuple(a.cpu() for a in srv.predict(name, requests[name]))
                 for name in states}
    torch.cuda.synchronize()
    launches = counts()
    # restart: a fresh process loads the store cold, within the budget
    (child, restart_ms) = _ms(lambda: _persist_in_child(store.dir, requests, budget))
    check(child["models"] == tuple(sorted(states)), f"restart models {child['models']}")
    check(child["cold"]["resident_bytes"] == 0 and child["cold"]["registered"] == len(states),
          f"the restarted server did not start cold: {child['cold']}")
    check(child["metrics"]["peak_resident_bytes"] <= budget,
          f"the restarted server went over its budget: {child['metrics']}")
    for name in states:
        check(all(torch.equal(g, w) for g, w in zip(child["answers"][name], after[name])),
              f"{name_dt} {name}: the restarted process's answer differs")
    log(f"[persist] {name_dt}: restart in a fresh process: cold, peak "
        f"{child['metrics']['peak_resident_bytes']} <= {budget} bytes, every answer "
        f"bitwise equal to the first process's ({restart_ms / 1e3:.1f} s with the "
        f"process's start)")
    log(f"[time] persistence {name_dt} (M={PAPER[1]}, state {sizes[-1]} bytes): save "
        f"{times['save_ms']:.3f} ms, load_meta {times['load_meta_ms']:.3f} ms, load "
        f"{times['load_ms']:.3f} ms, lazy reload + predict {times['lazy_reload_ms']:.3f} ms, "
        f"update on an evicted state {times['update_ms']:.3f} ms, save_all "
        f"{times['save_all_ms']:.3f} ms ({len(saved)} states)")
    check(all(launches[k] > 0 for k in PERSIST_KERNELS),
          f"{name_dt}: the persistence path skipped a kernel: {launches}")
    return {"launches": launches, "times": times}


def phase_persistence(data: dict) -> dict:
    """GPServer(store=, budget_bytes=) at the paper's shape in both dtypes:
    five states (SGPR fused and pallas, GP-LVM pallas, Product(RBF, RBF)
    GP-LVM fused, the temporal quickstart's) registered under a budget of
    two states; each answer after a lazy reload bitwise equal to the one
    before the eviction; an update of 65,536 points on an evicted SGPR
    state bitwise equal to the same update on a server that never evicted;
    save_all, then GPServer.load in a fresh process, cold and within the
    budget, answering bitwise as the first process did. Every counter is
    set to 0 before each dtype's state builds and read after its server
    closes. Returns the launches and times per dtype."""
    from repro_torch.gp import regression

    t_np, Y_np = temporal_series(PAPER[0])
    model = regression(get("matern32")(1), backend="temporal", device="cuda")
    model.fit(torch.as_tensor(t_np, device="cuda"), torch.as_tensor(Y_np, device="cuda"),
              steps=0)
    temporal = (model.kernel, model.export_state())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.float64, torch.float32):
            out[dtype] = persistence_run(data, dtype, temporal, Path(tmp))
    return out


# ---------------------------------------------------------------------------
# phase 14: the autotuner on the card
# ---------------------------------------------------------------------------

TUNE_CHUNK_BACKENDS = ("fused", "pallas")
AUTO_STEPS = 3


def _tune_child(cache_file: str, out: str) -> None:
    """A second process on the same cache file (a spawned child on
    cuda:0): tuning on, every key of phase 14 resolved again."""
    os.environ[autotune.TUNE_ENV] = "1"
    os.environ[tune.CACHE_ENV] = cache_file
    torch.cuda.set_device(0)
    M, Q = PAPER[1], PAPER[2]
    won = {}
    for dtype in (torch.float32, torch.float64):
        for name in search.KERNELS:
            won[str(dtype), name] = tune.best_blocks(name, dtype=dtype, m=M, q=Q,
                                                     device="cuda")
        for backend in TUNE_CHUNK_BACKENDS:
            won[str(dtype), backend] = tune.best_chunk(n=PAPER[0], m=M, q=Q, d=PAPER[3],
                                                       dtype=dtype, backend=backend,
                                                       device="cuda")
    torch.save({"runs": tune.timing_runs(), "winners": won}, out)


def _tune_in_child(cache_file: Path) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "out.pt")
        proc = multiprocessing.get_context("spawn").Process(
            target=_tune_child, args=(str(cache_file), out))
        proc.start()
        proc.join(PERSIST_CHILD_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join(30)
        check(proc.exitcode == 0, f"the warm-cache child exited with {proc.exitcode}")
        return torch.load(out)


def tune_kernel(name: str, dtype: torch.dtype, card) -> int:
    """Resolve one kernel's wave count cold, print every candidate's time,
    and hold the kernel at every candidate against its plain version."""
    M, Q = PAPER[1], PAPER[2]
    runs = tune.timing_runs()
    win, cold_ms = _ms(lambda: tune.best_blocks(name, dtype=dtype, m=M, q=Q, device="cuda"))
    entry = tune.lookup(tune.make_key("blocks", name, dtype, M, Q, device="cuda"))
    prob = search.Problem(entry["N"], M, Q, PAPER[3])
    cands = search.candidate_blocks(name, problem=prob, dtype=dtype, card=card)
    check(win in cands and tune.timing_runs() - runs == len(cands),
          f"{name}: winner {win} of {cands}, {tune.timing_runs() - runs} timing runs")
    args64 = autotune.kernel_inputs(name, prob, torch.float64, "cuda")
    want = _as_tuple(search.KERNELS[name].plain(*args64))
    args = tuple(a.to(dtype) for a in args64)
    errs = []
    for w in cands:
        got = _as_tuple(autotune.run_kernel(name, args, w))
        again = _as_tuple(autotune.run_kernel(name, args, w))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name} at {w} waves: two launches differ")
        errs.append(max(rel_err(g, p) for g, p in zip(got, want)))
    splits = {w: search.launch_plan(name, w, prob, dtype, card).counts for w in cands}
    log(f"[tune] {name} {str(dtype)[6:]} M={M} Q={Q}, measured at N={prob.N}: "
        + ", ".join(f"{w} waves (splits {splits[w]}) {entry['timings_s'][str(w)] * 1e3:.4f} ms"
                    f" err {e:.2e}" for w, e in zip(cands, errs))
        + f"; winner {win} waves; cold resolution {cold_ms:.1f} ms")
    check(max(errs) <= TOL[dtype], f"{name} {dtype} vs plain at its candidates: {errs}")
    return win


def phase_autotune(data: dict) -> dict:
    """The tuner as the card runs it, tuning on and its cache in a
    temporary file: best_blocks for all seven kernels in both dtypes at
    M = 100, Q = 1 (every candidate's time, the winner, each candidate held
    against the plain version with phase 3's tolerances, two launches
    bitwise equal), best_chunk for "fused" and "pallas"; a second process
    on the same cache resolves the same winners with zero timing runs; then
    a SparseGPRegression(backend="pallas", chunk="auto") fit of AUTO_STEPS
    steps, resolved from the cache. The tuner's launches are no main
    path's: the counters are saved before and restored after. Tuning is
    off again afterwards."""
    saved = counts()
    card = search.Card(torch.cuda.current_device())
    M, Q, D = PAPER[1], PAPER[2], PAPER[3]
    winners = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache_file = Path(tmp) / "tune.json"
        old_cache = os.environ[tune.CACHE_ENV]
        os.environ[tune.CACHE_ENV] = str(cache_file)
        autotune._ENABLED_OVERRIDE = True
        tune.clear_memo()
        try:
            for dtype in (torch.float32, torch.float64):
                for name in search.KERNELS:
                    winners[str(dtype), name] = tune_kernel(name, dtype, card)
                for backend in TUNE_CHUNK_BACKENDS:
                    c, cold_ms = _ms(lambda: tune.best_chunk(
                        n=PAPER[0], m=M, q=Q, d=D, dtype=dtype, backend=backend,
                        device="cuda"))
                    entry = tune.lookup(tune.make_key(
                        "chunk", "streaming_suff_stats", dtype, M, Q,
                        extra=f"backend={backend}", device="cuda"))
                    log(f"[tune] chunk {backend} {str(dtype)[6:]} M={M} Q={Q}, measured at "
                        f"N={entry['N']}: " + ", ".join(
                            f"{k} {v * 1e3:.3f} ms"
                            for k, v in sorted(entry["timings_s"].items(), key=lambda i: int(i[0])))
                        + f"; winner {c}; cold resolution {cold_ms:.1f} ms")
                    winners[str(dtype), backend] = c
            child = _tune_in_child(cache_file)
            log(f"[tune] a second process on the same cache: {child['runs']} timing runs, "
                f"winners {'the same' if child['winners'] == winners else child['winners']}")
            check(child["runs"] == 0 and child["winners"] == winners,
                  "the warm-cache process timed or resolved differently")
            zero_counts()
            runs = tune.timing_runs()
            X, Y = _as(data["X"], torch.float32), _as(data["Y"], torch.float32)
            model = SparseGPRegression(M=M, backend="pallas", chunk="auto",
                                       device="cuda").fit(X, Y, steps=AUTO_STEPS,
                                                          log_every=1)
            torch.cuda.synchronize()
            fit = counts()
            h = model.history
            log(f"[tune] float32 sgpr pallas chunk=\"auto\" (chunk "
                f"{winners[str(torch.float32), 'pallas']}): loss {h[0]:.6f} -> {h[-1]:.6f} "
                f"over {len(h)} steps; launches {fit}; timing runs {tune.timing_runs() - runs}")
            check(len(h) == AUTO_STEPS and all(np.isfinite(h)) and h[-1] < h[0],
                  f"chunk='auto' fit: losses {h}")
            check(tune.timing_runs() == runs, "the chunk='auto' fit timed again")
            check(fit["kfu_fwd"] > 0 and fit["psi1_bwd"] > 0,
                  f"the chunk='auto' fit skipped B7 or B6: {fit}")
        finally:
            autotune._ENABLED_OVERRIDE = None
            os.environ[tune.CACHE_ENV] = old_cache
            tune.clear_memo()
    set_counts(saved)  # the tuner's launches are not a main path's
    return winners


# ---------------------------------------------------------------------------
# phase 15: the analysis passes on the card
# ---------------------------------------------------------------------------

ANALYSIS_N = 65_536  # the trace check's smaller N (the larger is twice it)
ANALYSIS_CHUNK = 4096  # backend="pallas" streams its chunks
# the kernel audit's problems: both kernel shapes and the dry run's
AUDIT_SHAPES = KERNEL_SHAPES + ((16_777_216, 128, 1, 3),)
# (M, Q, D) of the dry run and of the second kernel shape, where B2's
# per-(pair block, point) sums over all of N came within 4x of an (N, M)
# buffer (fault C6, repaired: one chunk's sums, about N (1 + 3Q)): the
# trace check holds there too
SCALING_C6 = ((128, 1, 3), (256, 4, 5))


def watched(fn):
    """`fn` run under the port's `lockdep.watch()`: every lock the serving
    tier creates meanwhile is checked against the declared hierarchy and
    every observed order; the phase fails on any violation."""
    def run(*args):
        with lockdep.watch(raise_on_violation=False) as rec:
            result = fn(*args)
        log(f"[analysis] lockdep over {fn.__name__}: {rec.acquisitions} acquisitions, "
            f"{len(rec.edges)} order edges "
            f"({', '.join(f'{a} -> {b}' for a, b in sorted(rec.edges))}), "
            f"{len(rec.violations)} violations")
        check(not rec.violations, f"lockdep in {fn.__name__}: "
              + "; ".join(str(v) for v in rec.violations))
        return result
    return run


def smem_optin() -> tuple:
    """(bytes, where from) of the dynamic shared memory a block may opt in
    to on cuda:0."""
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    if optin:
        return int(optin), "the device's shared_memory_per_block_optin"
    return ss.SMEM_LIMIT, "suffstats.SMEM_LIMIT (the device does not report its opt-in limit)"


def audit_on_card() -> None:
    """The kernel audit on the card's occupancy queries at every audit
    shape, against the device's opt-in limit; every instance's ptxas
    resources printed once."""
    budget, source = smem_optin()
    log(f"[analysis] shared-memory budget a block: {budget} bytes ({source})")
    card = search.Card(0)
    for N, M, Q, D in AUDIT_SHAPES:
        audits = kernel_audit.audit_kernels(kernel_audit.Problem(N, M, Q, D),
                                            smem_budget_bytes=budget, card=card)
        for a in audits:
            grids = " ".join(f"{p.name}{list(p.grid)}x{p.block}" for p in a.passes)
            log(f"[analysis] audit {a.name} {a.dtype} N={N} M={M} Q={Q} D={D}: {grids}, "
                f"{a.smem_bytes} bytes of shared memory a block, scratch "
                f"{a.scratch_bytes} bytes, compute {a.compute}"
                + ("" if not a.findings else " FINDINGS " + "; ".join(
                    f.describe() for f in a.findings)))
            check(a.fits and not a.findings, f"kernel audit: {a.name} {a.dtype} "
                  f"N={N} M={M} Q={Q}: {[f.describe() for f in a.findings]}")
    for lib in _build.SOURCES:
        rows = kernel_audit.ptxas_resources(lib)
        check(bool(rows), f"no ptxas report for {lib}")
        for r in rows:
            log(f"[analysis] ptxas {lib} {r['instance']}: {r['registers']} registers, "
                f"{r['spill_stores']} / {r['spill_loads']} bytes spill stores / loads, "
                f"{r['stack_frame']} bytes stack frame (local), {r['lmem']} bytes lmem, "
                f"{r['smem_static']} bytes static shared memory")


def _gplvm_case(N: int, M: int, Q: int, D: int, backend: str, chunk):
    rng = np.random.default_rng(SEED)
    Y = torch.as_tensor(rng.normal(size=(N, D)), dtype=torch.float32, device="cuda")
    model = BayesianGPLVM(M=M, Q=Q, backend=backend, chunk=chunk, device="cuda")
    return model._loss, (model.init_params(Y), Y), {"N": N, "M": M, "Q": Q, "D": D}


def c6_scratch_shape(N: int, M: int, Q: int) -> tuple:
    """The shape of B2's per-point sums on this card in float32: one
    chunk's (pair blocks, 1 + 3Q, chunk), `suffstats.bwd_scratch`."""
    geo, sms = ss.card_geometry("suffstats_bwd", torch.empty(1, Q, device="cuda"))
    P2 = ss.bwd_pair_split(N, M, geo, sms).count
    return ss.bwd_scratch(N, M, Q, geo, P2)[0]


def scaling_on_card() -> None:
    """`assert_no_scaling(worse_than="N*M")` on the GP-LVM loss and its
    gradients through "fused" (B1, B2) and "pallas" (B5, B3, B6, B4 over
    chunks) on CUDA tensors at N and 2N, at the paper's M and Q; then the
    fused path at the dry run's M and at M = 256, Q = 4 (SCALING_C6), where
    B2's per-point sums over all of N once violated (fault C6)."""
    M, Q, D = PAPER[1:]
    cases = [(M, Q, D, "fused", None), (M, Q, D, "pallas", ANALYSIS_CHUNK)]
    cases += [(m, q, d, "fused", None) for m, q, d in SCALING_C6]
    for m, q, d, backend, chunk in cases:
        loss, args, sizes = _gplvm_case(ANALYSIS_N, m, q, d, backend, chunk)
        try:
            rep = trace_check.assert_no_scaling(loss, *args, axis="N", worse_than="N*M",
                                                sizes=sizes, backward=True)
        except trace_check.ScalingViolation as e:
            raise SmokeFailure(f"trace check, GP-LVM {backend} M={m} Q={q} on the card: "
                               f"{e}") from e
        log(f"[analysis] trace GP-LVM {backend} loss and gradients, cuda, N={ANALYSIS_N} "
            f"and {2 * ANALYSIS_N}, M={m}, Q={q}: {len(rep.entries)} call sites, worst "
            f"{rep.worst.describe()}; below O(N*M) with margin 4"
            + (f"; B2's point sums {c6_scratch_shape(ANALYSIS_N, m, q)} at N={ANALYSIS_N}"
               if backend == "fused" else ""))


def phase_analysis() -> None:
    """The kernel audit and the trace check on the card; their launches
    count towards no main path."""
    saved = counts()
    audit_on_card()
    scaling_on_card()
    set_counts(saved)


# ---------------------------------------------------------------------------
# phase 16: the GP-LVM dry run at the reference's production scale
# ---------------------------------------------------------------------------

DRYRUN = (16_777_216, 128, 1, 3)  # N, M, Q, D of src/repro/launch/gp_dryrun.py
DRYRUN_PREFIX = 65_536
DRYRUN_TOL = 1e-5  # float32 loss vs the facade's, relative
# the prefix's loss and each gradient leaf through "fused" (B1, B2) against
# "jnp" (the plain versions) on the same inputs, relative (a leaf's to its
# largest entry): float32's gradients carry the cancellations of the
# collapsed bound (the lengthscale's 1.0e-3 apart at most on an H100 80GB
# HBM3 at 700 W; 5x that is held), float64 holds mesh='s tolerances
DRYRUN_PLAIN_TOL = {torch.float64: (1e-10, 1e-8), torch.float32: (1e-5, 5e-3)}
# elements a point the step may hold beyond the state and B2's per-point
# sums (one chunk's, counted in full): the cotangents dmu, dS, dY
# (2Q + D), S = exp(q_logS), the KL's and Adam's per-leaf temporaries,
# which never all live at once (7.23 a point at the peak on an H100 80GB
# HBM3 at 700 W, PR 20's smoke20a.log): 8
DRYRUN_POINT_SLACK = 8
# the dry run's peak, whatever the bound above says (1.390 GiB read with
# the per-point scratch of one chunk, 3.379 GiB before it)
DRYRUN_PEAK_MAX = int(1.6 * 2**30)
DRYRUN_TIMEOUT_S = 600


def dryrun_kernel_ms(N: int, M: int, Q: int, D: int) -> tuple:
    """(B1 ms, B2 ms) at the dry run's shape: one launch an event pair,
    median of 5 after 2, on the dry run's own draw (random cotangents)."""
    params, Y = gp_dryrun.make_problem(N, M, Q, D, dtype=torch.float32,
                                       device=torch.device("cuda", 0))
    kern = params["kern"]
    x = (params["q_mu"], torch.exp(params["q_logS"]), Y, params["Z"],
         torch.exp(kern["log_variance"]), torch.exp(kern["log_lengthscale"]))
    g = [t.float() for t in bwd_cotangents(M, D)]
    return (cuda_ms(lambda: ss.suffstats_cuda(*x), reps=5),
            cuda_ms(lambda: ss.suffstats_bwd_cuda(*x, *g), reps=5))


def dryrun_prefix(N: int, M: int, Q: int, D: int, dtype: torch.dtype) -> tuple:
    """(params, Y): the dry run's own draw cut to its first N points."""
    params, Y = gp_dryrun.make_problem(DRYRUN[0], M, Q, D, dtype=dtype,
                                       device=torch.device("cuda", 0))
    pre = {**params, "q_mu": params["q_mu"][:N].clone(),
           "q_logS": params["q_logS"][:N].clone()}
    return pre, Y[:N].clone()


def _as_dtype(tree, dtype: torch.dtype):
    return {k: _as_dtype(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def dryrun_prefix_checks(params: dict, Y, M: int, D: int) -> None:
    """On the dry run's draw cut to DRYRUN_PREFIX points, at its M: B1 and
    B2 against their float64 plain versions on the same inputs; the dry
    run's loss and every gradient leaf through "fused" against "jnp" (the
    plain versions) on the same inputs, in float32 and float64; the dry
    run's float32 loss against `BayesianGPLVM(backend="fused")`'s."""
    kern = params["kern"]
    x64 = [t.double() for t in (params["q_mu"], torch.exp(params["q_logS"]), Y,
                                params["Z"], torch.exp(kern["log_variance"]),
                                torch.exp(kern["log_lengthscale"]))]
    g64 = bwd_cotangents(M, D)
    tol = TOL[torch.float32]
    for what, kernel, plain, names, args in (
            ("B1", ss.suffstats_cuda, ss.suffstats_fused_plain, ("psi2", "psiY"), x64),
            ("B2", ss.suffstats_bwd_cuda, ss.suffstats_vjp_plain, BWD_OUTPUTS, x64 + g64)):
        want = _as_tuple(plain(*args))
        got = _as_tuple(kernel(*[a.float() for a in args]))
        for name, g, w in zip(names, got, want):
            r = rel_err(g, w)
            log(f"[dryrun] prefix {what} {name} float32 vs float64 plain: rel err {r:.3e} "
                f"(tol {tol:g})")
            check(bool(torch.isfinite(g).all()) and r <= tol,
                  f"dry-run prefix {what} {name}: rel err {r:.3e}")
    with gp_dryrun.process_group(0, 1, torch.device("cuda", 0)):
        mesh = distributed.make_gp_mesh()
        for dtype, (loss_tol, grad_tol) in DRYRUN_PLAIN_TOL.items():
            p, y = _as_dtype(params, dtype), Y.to(dtype)
            res = {be: inference.value_and_grad(gp_dryrun.loss_fn(mesh, be), p, (y,))
                   for be in ("fused", "jnp")}
            (lf, gf), (lj, gj) = res["fused"], res["jnp"]
            r = rel_err(lf, lj)
            errs = {path: rel_err(a, b) for path, a, b in
                    zip(flatten(gf)[0], flatten(gf)[1], flatten(gj)[1])}
            log(f"[dryrun] prefix {str(dtype)[6:]} fused vs jnp: loss {float(lf)!r} vs "
                f"{float(lj)!r}, rel err {r:.3e} (tol {loss_tol:g}); gradients "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {grad_tol:g})")
            check(np.isfinite(float(lf)) and r <= loss_tol,
                  f"dry-run prefix {dtype} loss: fused vs jnp rel err {r:.3e}")
            bad = {k: v for k, v in errs.items() if not v <= grad_tol}
            check(not bad, f"dry-run prefix {dtype} gradients fused vs jnp: {bad}")
        with torch.no_grad():
            got = float(gp_dryrun.loss_fn(mesh, "fused")(params, Y))
    with torch.no_grad():
        want_loss = float(BayesianGPLVM(M=M, Q=params["Z"].shape[1], backend="fused",
                                        device="cuda")._loss(params, Y))
    err = abs(got - want_loss) / abs(want_loss)
    log(f"[dryrun] prefix N={DRYRUN_PREFIX}: dry-run loss {got!r}, BayesianGPLVM(fused) "
        f"{want_loss!r}, rel err {err:.3g} (tol {DRYRUN_TOL})")
    check(np.isfinite(got) and err <= DRYRUN_TOL,
          f"dry-run loss {got} vs facade {want_loss} on the prefix")


def phase_dryrun() -> dict:
    """`python -m repro_torch.launch.gp_dryrun` at the reference's shape,
    W = 1, float32, "fused", in a process of its own, as a user runs it: the
    losses finite and falling at every step, each step one B1 and one B2
    launch and no other kernel, the peak device memory under the state plus
    B2's per-point sums (one chunk's) plus DRYRUN_POINT_SLACK elements a
    point, and under DRYRUN_PEAK_MAX; B1 and B2 timed alone at that
    shape; on the draw's first DRYRUN_PREFIX points, `dryrun_prefix_checks`.
    Returns the record and the child's launches (this process's launches
    count towards no main path)."""
    N, M, Q, D = DRYRUN
    saved = counts()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "record.json"
        env = {**os.environ, "PYTHONPATH": str(root / "src")}
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.gp_dryrun", "--n", str(N),
             "--m", str(M), "--q", str(Q), "--d", str(D), "--backend", "fused",
             "--out", str(out)],
            cwd=root, env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        for line in proc.stdout.splitlines():
            log(f"[dryrun] {line}")
        check(proc.returncode == 0, f"gp_dryrun exited {proc.returncode}: {proc.stderr[-3000:]}")
        rec = json.loads(out.read_text())
    log(f"[dryrun] record {json.dumps({k: v for k, v in rec.items() if k != 'parts'})}")
    for part in rec["parts"]:
        log(f"[dryrun] part {part['part']}: {part['flops']:.4g} flops, {part['exps']:.4g} "
            f"exps, {part['bytes']:.4g} bytes, bound {part['bound_ms']:.4f} ms")
    losses = rec["losses"]
    check(all(np.isfinite(losses)), f"dry run losses {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"dry run losses do not fall at every step: {losses}")
    launches = rec["launches"]
    want = {k: gp_dryrun.STEPS if k in ("suffstats_fwd", "suffstats_bwd") else 0
            for k in COUNTERS}
    check(launches == want, f"dry run launches {launches}, want {want}")
    point_sums = math.prod(c6_scratch_shape(N, M, Q)) * 4
    bound = rec["memory"]["state_bytes"] + point_sums + DRYRUN_POINT_SLACK * N * 4
    peak = rec["memory"]["peak_bytes"]
    log(f"[dryrun] peak {peak} bytes ({peak / 2**30:.3f} GiB): state "
        f"{rec['memory']['state_bytes']} + B2's point sums {point_sums} + "
        f"{DRYRUN_POINT_SLACK} elements a point = bound {bound} bytes (at most "
        f"{DRYRUN_PEAK_MAX} bytes)")
    check(peak <= bound, f"dry run peak {peak} bytes above its bound {bound}")
    check(peak <= DRYRUN_PEAK_MAX, f"dry run peak {peak} bytes above {DRYRUN_PEAK_MAX}")
    b1, b2 = dryrun_kernel_ms(N, M, Q, D)
    log(f"[dryrun] B1 {b1:.3f} ms, B2 {b2:.3f} ms one launch each at N={N} M={M}; the "
        f"rest of the {rec['step_ms']:.3f} ms step {rec['step_ms'] - b1 - b2:.3f} ms")
    dryrun_prefix_checks(*dryrun_prefix(DRYRUN_PREFIX, M, Q, D, torch.float32), M, D)
    set_counts(saved)
    return {"record": rec, "launches": launches}


# ---------------------------------------------------------------------------
# phase 17: times and the bounds
# ---------------------------------------------------------------------------

def step_ms(model) -> float:
    """Median wall time of one training step after the first (loss, its
    gradients through both kernels, the Adam update), from the fitted
    parameters: host clock to a synchronize."""
    config = AdamConfig(lr=1e-2, clip_norm=None, weight_decay=0.0)
    params = model.params
    state = adam_init(params, config)
    times = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = inference.value_and_grad(model._loss, params, model._data)
        params, state, _ = adam_update(grads, state, params, config)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def cuda_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median over `reps` CUDA-event pairs, each around `inner` calls back to
    back, of the time a call; after warm-up. With inner > 1 the wrapper's
    host work overlaps the previous call's device work, as in a training
    step, and the time is the kernel's rate."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def exp_slots(lib: str, N: int, M: int, Q: int, D: int, dtype) -> str:
    """The exponentials a datapoint costs in the launch geometry of `lib`
    (B1-B4) on this card at this shape, from the wrappers' own pair and
    split helpers, beside the M (M + 1) / 2 psi2 pairs (and M psi1 columns)
    the statistics need. The psi1 side: B1's psiY blocks evaluate whole
    32-row tiles per 8-column d tile; B2's point pass evaluates M (dZ's
    psi1 part included)."""
    geo, sms = ss.card_geometry(lib, torch.empty(1, Q, device="cuda", dtype=dtype))
    if lib in ("suffstats_bwd", "psi2_bwd"):  # the reverse passes split each chunk
        P = ss.bwd_pair_split(N, M, geo, sms).count
        chunks = ss.chunk_bounds(N, ss.point_chunk(N, M, geo.pairs_per_block))
    else:
        P, chunks = ss.psi2_splits(N, M, geo, sms), [(0, N)]
    rows = sum(ss.evaluated_rows(hi - lo, P, geo.run, geo.group) for lo, hi in chunks)
    psi2 = ss.evaluated_slots(M, geo.pairs_per_block) * rows / N
    psi1 = {"suffstats_fwd": -(-M // ss.Y_TILE_M) * ss.Y_TILE_M * -(-D // ss.Y_TILE_D),
            "suffstats_bwd": M}.get(lib, 0)
    blocks = ss.pair_blocks(M, geo.pairs_per_block)
    return (f"[slots] {lib} {str(dtype)[6:]} N={N} M={M} Q={Q} D={D}: {psi2:.1f} psi2 "
            f"exponentials a point for the {ss.pair_count(M)} pairs it needs "
            f"({100 * (psi2 / ss.pair_count(M) - 1):.2f} % more)"
            + (f", psi1 {psi1} for the {M} it needs" if psi1 else "")
            + f"; grid {blocks} pair blocks x {P} N-splits"
            + (f" in each of {len(chunks)} chunks" if len(chunks) > 1 else "")
            + f", {geo.blocks_per_sm} resident "
            f"a multiprocessor x {sms}")


KERNEL_INNER = 10  # back-to-back launches the event pair of a kernel's rate times


def _time_kernel(out: dict, key, what: str, kernel, plain, bound: tuple,
                 reps: int) -> None:
    """`ms`: one launch an event pair, the wrapper's host work included;
    `rate_ms`: a launch's share of KERNEL_INNER back to back, where that
    host work overlaps the previous launch's device work."""
    t = cuda_ms(kernel, reps=reps)
    rate = cuda_ms(kernel, reps=reps, inner=KERNEL_INNER)
    p = cuda_ms(plain, reps=3, warmup=1)
    out[key] = {"ms": t, "rate_ms": rate, "plain_ms": p, "bound_ms": bound[0],
                "bound_by": bound[1]}
    log(f"[time] {what}: kernel {t:.3f} ms one launch, {rate:.3f} ms a launch of "
        f"{KERNEL_INNER} back to back, plain {p:.3f} ms, bound {bound[0]:.3f} ms "
        f"({bound[2]}; kernel at {100 * bound[0] / t:.1f} % of it one launch, "
        f"{100 * bound[0] / rate:.1f} % back to back)")


def state_build_ms(data: dict, dtype: torch.dtype, backend: str, reps: int = 5) -> float:
    """Median wall time of building the SGPR's served state from (X, Y)
    (one statistics pass through `backend` and the O(M^3) refold), after
    one untimed build: host clock to a synchronize."""
    kernel = get("rbf")(1)
    params = convert.params_from_numpy(data["params"], device="cuda", dtype=dtype)
    X, Y = _as(data["X"], dtype), _as(data["Y"], dtype)
    times = []
    with torch.no_grad():
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = suff_stats(kernel, params["kern"], ExactBatch(X, Y, params["Z"]),
                               backend=backend)
            build_state(kernel, params, stats)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def cross_slots(lib: str, N: int, M: int, Q: int, D: int, dtype) -> str:
    """The launch geometry of B5 / B7 (common.cuh: cross_kernel) or B6
    (psi1_bwd.cu) on this card at this shape: run, tile, shared memory,
    resident blocks, grid; each evaluates M exponentials a point, once."""
    t = torch.empty(1, Q, device="cuda", dtype=dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    head = f"[slots] {lib} {str(dtype)[6:]} N={N} M={M} Q={Q} D={D}: "
    if lib == "psi1_bwd":
        plan = ss.psi1_bwd_plan(M, Q, t.element_size())
        bps = ss.psi1_bwd_occupancy(dtype, M, Q, plan, 0)
        P = ss.psi1_bwd_splits(N, plan.run, bps * sms)
        return (head + f"runs of {plan.run} points x {plan.cols} columns "
                f"({-(-M // plan.cols)} tile(s)), {ss.PSI1_BWD_STAGES} stages "
                f"({ss.PSI1_BWD_STAGES - 1} runs in flight), {plan.lanes} lanes a point, "
                f"{'fast' if plan.fast else 'general'} path, {plan.smem} bytes of shared "
                f"memory a block, {bps} resident a multiprocessor x {sms}, grid {P} blocks; "
                f"{M} exponentials a point for the {M} it needs")
    cols = p1.cross_cols(M, Q)
    bps = p1.cross_occupancy(lib, dtype, Q, cols, 0)
    P = p1.cross_splits(N, M, Q, bps * sms)
    return (head + f"runs of {p1.cross_run(Q)} points x {cols} columns, "
            f"{p1.cross_smem(Q, cols, t.element_size(), lib == 'psi1_fwd')} bytes of shared "
            f"memory a block, {bps} resident a multiprocessor x {sms}, grid {P} splits x "
            f"{-(-M // cols)} tile(s); {M} exponentials a point for the {M} it needs")


def log_slots(lib: str, dtype) -> None:
    """`exp_slots` of a psi2 kernel (`cross_slots` of B5-B7) at the paper's
    shape (beside its [time] line) and at the second kernel shape."""
    slots = cross_slots if lib in ("psi1_fwd", "psi1_bwd", "kfu_fwd") else exp_slots
    log(slots(lib, *PAPER, dtype))
    N, M, Q, D = KERNEL_SHAPES[1]
    log(slots(lib, N, M, Q, D, dtype))


def phase_times(trained: dict, pallas: dict, sgpr: dict, data: dict) -> dict:
    """Kernel, plain-version, state-build and training-step times; none of
    these launches counts towards a main path."""
    N, M, Q, D = PAPER
    x64 = kernel_inputs(N, M, Q, D, True)
    g64 = bwd_cotangents(M, D)
    gn64 = random_g(N, M)
    saved = counts()
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        shape = f"{name} N={N} M={M} Q={Q} D={D}"
        x = [a.to(dtype) for a in x64]
        g = [a.to(dtype) for a in g64]
        gn = gn64.to(dtype)
        xs = (x[0], x[1], *x[3:])  # (mu, S, Z, v, l)
        _time_kernel(out, (dtype, "fwd"), f"suffstats_fwd {shape}",
                     lambda: ss.suffstats_cuda(*x), lambda: ss.suffstats_fused_plain(*x),
                     bound_ms(N, M, Q, D, dtype), reps=20)
        log_slots("suffstats_fwd", dtype)
        _time_kernel(out, (dtype, "bwd"), f"suffstats_bwd {shape}",
                     lambda: ss.suffstats_bwd_cuda(*x, *g),
                     lambda: ss.suffstats_vjp_plain(*x, *g),
                     bwd_bound_ms(N, M, Q, D, dtype), reps=10)
        log_slots("suffstats_bwd", dtype)
        _time_kernel(out, (dtype, "psi2_fwd"), f"psi2_fwd {shape}",
                     lambda: p2.psi2_cuda(*xs), lambda: p2.psi2_plain(*xs),
                     psi2_bound_ms(N, M, Q, D, dtype), reps=20)
        log_slots("psi2_fwd", dtype)
        _time_kernel(out, (dtype, "psi2_bwd"), f"psi2_bwd {shape}",
                     lambda: ss.psi2_bwd_cuda(*xs, g[0]),
                     lambda: ss.psi2_vjp_plain(*xs, g[0]),
                     psi2_bwd_bound_ms(N, M, Q, D, dtype), reps=10)
        log_slots("psi2_bwd", dtype)
        _time_kernel(out, (dtype, "psi1_fwd"), f"psi1_fwd {shape}",
                     lambda: p1.psi1_cuda(*xs), lambda: p1.psi1_plain(*xs),
                     psi1_bound_ms(N, M, Q, D, dtype), reps=20)
        log_slots("psi1_fwd", dtype)
        _time_kernel(out, (dtype, "psi1_bwd"), f"psi1_bwd {shape}",
                     lambda: ss.psi1_bwd_cuda(*xs, gn), lambda: ss.psi1_vjp_plain(*xs, gn),
                     psi1_bwd_bound_ms(N, M, Q, D, dtype), reps=20)
        log_slots("psi1_bwd", dtype)
        xk = (x[0], *x[3:])  # (X, Z, v, l)
        _time_kernel(out, (dtype, "kfu_fwd"), f"kfu_fwd {shape}",
                     lambda: kf.kfu_cuda(*xk), lambda: kf.kfu_plain(*xk),
                     kfu_bound_ms(N, M, Q, D, dtype), reps=20)
        log_slots("kfu_fwd", dtype)
        builds = [(b, state_build_ms(data, dtype, b))
                  for b in ("pallas", "fused", "fused", "pallas")]
        log(f"[time] sgpr state build {name} (N={N}, M={M}), in turns: "
            + ", ".join(f"{b} {t:.3f} ms" for b, t in builds)
            + " (each the median of 5 after the first)")
        models = {**trained[dtype]["models"], "gplvm pallas": pallas[dtype]["model"],
                  "sgpr pallas": sgpr[dtype]["model"]}
        for key, model in models.items():
            log(f"[time] training step {name} {key} (N={N}, M={M}): "
                f"{step_ms(model):.3f} ms median of {TIMED_STEPS - 1} after the first")
    set_counts(saved)  # timing launches are not a main path's
    return out


# ---------------------------------------------------------------------------
# phase 18: the dense LM side at smollm-360m's full width
# ---------------------------------------------------------------------------

LM_ARCH = "smollm-360m"
# serve: batch, prompt, new tokens; numerics: batch, sequence (float32 vs
# float64) and the prompt of decode-vs-forward; train: batch, sequence,
# steps before and after the resume; the head: sequences pooled, their
# length, inducing points, Adam steps
LM_SERVE = (4, 512, 64)
LM_NUMERICS = (2, 256, 128)
LM_TRAIN = (8, 2048, 5, 8)
LM_HEAD = (256, 256, 256, 50)
# float32 loss and gradients of the full-width model (TF32 off) against
# `plain_lm_loss_f64`, a float64 forward written apart from the port that
# downcasts nowhere (the port's rmsnorm, RoPE, attention scores and PV and
# its cross-entropy run float32 whatever the parameters' dtype, as the
# reference's do, so the port's own model in float64 is no float64
# reference). u = 2^-24. The hidden state's relative error after 32 layers,
# each adding a few roundings of 960- and 2560-term products, is ~1e1 u;
# a logit (|.| <~ 10) errs by ~1e-5 at most, and the loss, a mean of 510
# log-sum-exps of such errors, by far less relatively: 1e-5. A gradient
# leaf sums 510 positions' products whose own error is ~1e2 u, held
# relative to its largest entry: ~1e-5; the limit leaves ten times that
# (the port's float64 model read 3.4e-6 worst, PR 20's call 16): 1e-4
LM_F64_TOL = (1e-5, 1e-4)
# the resumed steps' losses against the uninterrupted run's
LM_RESUME_TOL = 1e-3
# the first loss against `expected_first_loss` (its spread over 16,384
# positions is ~1e-3; the residual-growth estimate is the looser part)
LM_FIRST_LOSS_TOL = 0.1


def expected_first_loss(cfg) -> float:
    """The cross-entropy at init on random tokens. The tied logits
    h . t_v, with h rmsnorm'd (|h|^2 = d) and table entries N(0, 1/d), are
    ~N(0, 1) for every id but the input token's own, so with the gold
    logit's mean 0 the loss is E[logsumexp] = ln(V e^(1/2) + e^z): ln V +
    1/2 plus the input token's own logit z. That one is
    d / |x| = sqrt(d / (1 + r)): the residual stream x starts at the
    embedding (sqrt(d) t_in, |.|^2 = d) and each of the L layers adds an
    MLP output of E[silu(a)^2 b^2] = 0.3558 a coordinate (a, b ~ N(0, 1);
    w_down at f^-1/2), so r = 0.3558 L; attention outputs average many
    values and add little. smollm-360m: z = 8.80, 11.382 (ln V + 1/2 =
    11.303); its smoke config (d = 60, L = 3, V = 512): 6.969."""
    z = math.sqrt(cfg.d_model / (1.0 + 0.35578 * cfg.num_layers))
    V = cfg.vocab_size
    return math.log(V) + 0.5 + math.log1p(math.exp(z) / (V * math.exp(0.5)))


def recording(step_fn, losses: list):
    """`step_fn` noting each step's loss (as a float) in `losses`."""
    def step(params, opt_state, batch):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        return params, opt_state, metrics
    return step


class OneBatch:
    """A TokenStream that yields its batch 0 at every step: its position
    advances and checkpoints as the stream's, so a resumed loop reads the
    same position it was saved at."""

    def __init__(self, stream):
        self.stream = stream
        self.batch0 = stream.batch(0)

    def next(self):
        self.stream.state.step += 1
        return self.batch0

    def checkpoint_state(self):
        return self.stream.checkpoint_state()

    def restore_state(self, st):
        self.stream.restore_state(st)


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev: torch.device) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")


def _pooled_features(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """Mean over the sequence of the final (normed) hidden states, float32."""
    with torch.no_grad():
        x = transformer.embed_lookup(params["embed"], tokens, cfg)
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
        x, _, _ = transformer._backbone(params, x, pos, cfg, mode="train", states=None,
                                        cur_pos=None)
    return x.float().mean(dim=1)


def lm_serve_part(cfg, preset: str, params, dev, sizes) -> dict:
    B, S, new = sizes
    cold = lm_serve.serve(LM_ARCH, preset, params=params, batch=B, prompt_len=S,
                          new_tokens=new, device=dev)
    _reset_peak(dev)
    r = lm_serve.serve(LM_ARCH, preset, params=params, batch=B, prompt_len=S,
                       new_tokens=new, device=dev)
    peak = _peak_gib(dev)
    V = cfg.vocab_size
    for name, lg in (("prefill", r.prefill_logits), ("last decode", r.last_logits)):
        check(bool(torch.isfinite(lg[:, :V]).all()), f"[lm] serve: {name} logits not finite")
        check(bool((lg[:, V:] < -1e29).all()), f"[lm] serve: {name} padded ids not masked")
    check(tuple(r.tokens.shape) == (B, new) and int(r.tokens.max()) < V,
          f"[lm] serve: tokens {tuple(r.tokens.shape)}")
    check(torch.equal(r.tokens, cold.tokens), "[lm] serve: two greedy runs disagree")
    log(f"[lm] serve {cfg.name} ({sum(t.numel() for t in flatten(params)[1]):,} parameters, "
        f"{cfg.param_dtype}): B={B} x {S} prompt + {new} new tokens greedy; prefill "
        f"{r.prefill_s * 1e3:.1f} ms ({r.prefill_tok_s:.0f} tok/s; cold {cold.prefill_s * 1e3:.1f} "
        f"ms), decode {r.decode_tok_s:.1f} tok/s ({r.decode_s / new * 1e3:.2f} ms a step), peak "
        f"{peak:.3f} GiB; padded ids {cfg.padded_vocab() - V} (masked < -1e29); sample "
        f"{r.tokens[0, :12].tolist()}")
    return {"prefill_ms": r.prefill_s * 1e3, "decode_tok_s": r.decode_tok_s, "peak_gib": peak}


def plain_lm_loss_f64(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """The dense decoder's next-token loss in float64 throughout, written
    apart from `models/`: embedding x sqrt(d), per layer a pre-norm GQA
    attention with RoPE (full causal) and a pre-norm SwiGLU MLP, the final
    norm, tied logits over the real vocabulary. `params` is the port's
    tree (any dtype), read as float64."""
    check(cfg.tie_embeddings and cfg.act == "swiglu" and set(cfg.layer_windows()) == {-1},
          f"[lm] the plain float64 forward covers tied, SwiGLU, full-causal configs: {cfg.name}")
    eps, d, V = cfg.norm_eps, cfg.d_model, cfg.vocab_size
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    B, S = tokens.shape

    def norm(p, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"].double()

    pos = torch.arange(S, dtype=torch.float64, device=tokens.device)
    inv = 1.0 / cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                device=tokens.device) / hd)
    ang = pos[:, None] * inv  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    def rope(t):  # (B, S, heads, hd)
        a, b = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    causal = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    table = params["embed"]["table"].double()
    x = table[tokens] * d**0.5
    for si, seg in enumerate(transformer.segments(cfg)):
        for r in range(seg.repeat):
            for leaf in params[f"seg{si}"]:
                lp = tree_map(lambda t: t[r], leaf)
                h = norm(lp["ln1"], x)
                a = lp["attn"]
                q = rope((h @ a["wq"].double()).reshape(B, S, H, hd))
                k = rope((h @ a["wk"].double()).reshape(B, S, Kv, hd))
                v = (h @ a["wv"].double()).reshape(B, S, Kv, hd)
                k = k.repeat_interleave(H // Kv, dim=2)
                v = v.repeat_interleave(H // Kv, dim=2)
                sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5
                pr = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
                o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, S, H * hd)
                x = x + o @ a["wo"].double()
                h = norm(lp["ln2"], x)
                m = lp["mlp"]
                g = F.silu(h @ m["w_gate"].double()) * (h @ m["w_up"].double())
                x = x + g @ m["w_down"].double()
    x = norm(params["final_norm"], x)
    logits = x[:, :-1] @ table[:V].T  # (B, S - 1, V): the last position has no label
    return F.cross_entropy(logits.reshape(-1, V), tokens[:, 1:].reshape(-1).long())


def lm_numerics_part(cfg, dev, sizes) -> None:
    """Full width in float32: decode-after-prefill vs the full forward, and
    the loss and gradients against `plain_lm_loss_f64`."""
    B, S, P = sizes
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    m32 = model_zoo.build(cfg32)
    params = m32.init(1, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = model_zoo.make_batch(gen, cfg32, ShapeCell("n", S, B, "train"))["tokens"]
    with torch.no_grad():
        full, _ = m32.prefill(params, {"tokens": tokens[:, :P]})
        _, states = m32.prefill(params, {"tokens": tokens[:, :P - 1]})
        dec, _ = m32.decode_step(params, tokens[:, P - 1:P], P - 1, states)
    scale = float(full.abs().max())
    err = float((full - dec).abs().max())
    log(f"[lm] float32 decode after a {P - 1}-token prefill vs the {P}-token forward: max "
        f"err {err:.3e} (bound 1e-3 max(scale {scale:.3f}, 1))")
    check(err < 1e-3 * max(scale, 1.0), f"[lm] decode vs forward: {err} at scale {scale}")
    del states

    leaves = [t.detach().clone().requires_grad_() for t in flatten(params)[1]]
    loss, _ = m32.train_loss(unflatten(params, leaves), {"tokens": tokens})
    g32 = torch.autograd.grad(loss, leaves)
    l32 = loss.detach()
    del leaves, loss
    leaves = [t.detach().double().requires_grad_() for t in flatten(params)[1]]
    loss = plain_lm_loss_f64(cfg32, unflatten(params, leaves), tokens)
    g64 = torch.autograd.grad(loss, leaves)
    l64 = loss.detach()
    del leaves, loss
    lerr = abs(float(l32) - float(l64)) / abs(float(l64))
    paths = flatten(params)[0]
    gerr = {path: rel_err(a, b) for path, a, b in zip(paths, g32, g64)}
    worst = max(gerr, key=gerr.get)
    log(f"[lm] float32 port vs the plain float64 forward at full width, B={B} S={S}, TF32 "
        f"off: loss {float(l32)!r} vs {float(l64)!r}, rel err {lerr:.3e} (tol "
        f"{LM_F64_TOL[0]:g}); gradients: worst {worst} {gerr[worst]:.3e}, median "
        f"{statistics.median(gerr.values()):.3e} over {len(gerr)} leaves (tol "
        f"{LM_F64_TOL[1]:g})")
    check(lerr <= LM_F64_TOL[0], f"[lm] float32 loss vs float64: {lerr}")
    bad = {k: v for k, v in gerr.items() if not v <= LM_F64_TOL[1]}
    check(not bad, f"[lm] float32 gradients vs float64: {bad}")


def lm_train_part(cfg, preset: str, dev, sizes, ckpt_root: str) -> dict:
    """Train through launch/train's setup and TrainLoop: the first steps on
    one repeated batch, a resume from the checkpoint in a fresh loop, and
    the same steps uninterrupted."""
    B, S, first, total = sizes
    s = lm_train.setup(LM_ARCH, preset, batch=B, seq=S, ckpt_dir=f"{ckpt_root}/a",
                       ckpt_every=0, device=dev, log_every=1)
    _reset_peak(dev)
    history: list = []
    loop = TrainLoop(recording(s.bundle.fn, history), s.params, s.opt, OneBatch(s.data),
                     s.loop_cfg)
    loop.run(first)
    peak = _peak_gib(dev)
    losses = list(history)
    step_ms = statistics.median(loop.step_times[1:]) * 1e3
    expect = expected_first_loss(cfg)
    log(f"[lm] train {cfg.name} B={B} S={S} ({B * S} tokens a step, {cfg.param_dtype}): losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f"; first vs expected {expect:.4f} (ln V + "
        f"1/2 = {math.log(cfg.vocab_size) + 0.5:.4f}); step "
        f"{step_ms:.1f} ms (median of {len(loop.step_times) - 1} after the first; first "
        f"{loop.step_times[0] * 1e3:.1f}), {B * S / step_ms * 1e3:.0f} tokens/s, peak "
        f"{peak:.3f} GiB")
    check(all(math.isfinite(x) for x in losses), f"[lm] train losses {losses}")
    check(abs(losses[0] - expect) <= LM_FIRST_LOSS_TOL,
          f"[lm] first loss {losses[0]} vs expected {expect}")
    check(losses[-1] < losses[0], f"[lm] the loss did not fall: {losses}")
    saved = {k: [t.clone() for t in flatten(getattr(loop, k))[1]] for k in ("params", "opt_state")}

    # a fresh loop over the same directory resumes at step `first`
    fresh = lm_train.setup(LM_ARCH, preset, batch=B, seq=S, ckpt_dir=f"{ckpt_root}/a",
                           ckpt_every=0, device=dev, log_every=1, seed=1)
    after: list = []
    resumed = TrainLoop(recording(fresh.bundle.fn, after), fresh.params, fresh.opt,
                        OneBatch(fresh.data), fresh.loop_cfg)
    check(resumed.try_resume() and resumed.step == first,
          f"[lm] resume: step {resumed.step}, want {first}")
    check(resumed.data.checkpoint_state() == {"seed": 0, "step": first},
          f"[lm] resume: data position {resumed.data.checkpoint_state()}")
    for k in saved:
        same = all(torch.equal(a, b) for a, b in zip(saved[k], flatten(getattr(resumed, k))[1]))
        check(same, f"[lm] resume: restored {k} differ from the saved ones")
    del fresh, saved
    resumed.run(total)
    del resumed
    # the same steps without the interruption, checkpointing elsewhere
    loop.ckpt = type(loop.ckpt)(f"{ckpt_root}/b")
    loop.run(total)
    want = history[first:]
    errs = [abs(a - b) / abs(b) for a, b in zip(after, want)]
    log(f"[lm] resumed at step {first} (params and moments restored bitwise, data position "
        f"{first}): steps {first + 1}-{total} losses " + ", ".join(f"{x:.6f}" for x in after)
        + " vs uninterrupted " + ", ".join(f"{x:.6f}" for x in want)
        + f"; max rel diff {max(errs):.3e} (tol {LM_RESUME_TOL:g}; bitwise "
        f"{after == want})")
    check(len(after) == total - first and max(errs) <= LM_RESUME_TOL,
          f"[lm] resumed losses {after} vs uninterrupted {want}")
    return {"step_ms": step_ms, "tokens_s": B * S / step_ms * 1e3, "peak_gib": peak,
            "params": loop.params}


def lm_head_part(cfg, params, dev, sizes) -> None:
    """The GP head on the trained model's mean-pooled final features."""
    n, S, M, steps = sizes
    stream = TokenStream(cfg, ShapeCell("h", S, n, "train"), seed=2, device=dev)
    tokens = stream.batch(0)["tokens"]
    feats = torch.cat([_pooled_features(cfg, params, t) for t in tokens.split(32)])
    # the target: the sequence's mean token id, centred and scaled (a
    # property of the input the features may carry)
    y = tokens.float().mean(dim=1) / cfg.vocab_size
    y = (y - y.mean()) / y.std()
    head = gp_head.init_head(0, feats.shape[1], M=M, device=dev)
    l0 = float(gp_head.head_loss(head, feats, y))
    head, _ = inference.fit_adam(gp_head.head_loss, head, (feats, y), steps=steps, lr=1e-2)
    l1 = float(gp_head.head_loss(head, feats, y))
    near = gp_head.head_predict(head, feats, y, feats[:16])
    far = gp_head.head_predict(head, feats, y, feats[:16] + 20.0)
    vn, vf = float(near.var.mean()), float(far.var.mean())
    log(f"[lm] GP head on {n} mean-pooled features (Q={feats.shape[1]}, M={M}), {steps} Adam "
        f"steps: loss {l0:.4f} -> {l1:.4f}; predictive variance near the data {vn:.4g}, "
        f"20 away {vf:.4g}")
    check(math.isfinite(l1) and l1 < l0, f"[lm] head loss {l0} -> {l1}")
    check(vn > 0 and vf > vn, f"[lm] head variance near {vn}, far {vf}")


def phase_lm(device: str = "cuda", preset: str = "full", serve_sizes=LM_SERVE,
             numerics_sizes=LM_NUMERICS, train_sizes=LM_TRAIN,
             head_sizes=LM_HEAD) -> dict:
    """The dense LM at smollm-360m's full width (`preset="smoke"` and
    small sizes only to rehearse the phase on the CPU): serve, the float32
    numerics, train and resume, the GP head. The LM launches none of
    B1-B7: every counter stays where it was."""
    dev = torch.device(device)
    cfg = get_config(LM_ARCH) if preset == "full" else get_smoke_config(LM_ARCH)
    before = counts()
    params = model_zoo.build(cfg).init(0, device=dev)
    served = lm_serve_part(cfg, preset, params, dev, serve_sizes)
    del params
    lm_numerics_part(cfg, dev, numerics_sizes)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trained = lm_train_part(cfg, preset, dev, train_sizes, tmp)
    lm_head_part(cfg, trained.pop("params"), dev, head_sizes)
    check(counts() == before, f"[lm] the LM launched a kernel: {counts()} vs {before}")
    return {**served, **trained}


# ---------------------------------------------------------------------------
# phase 19: the remaining LM families at full width
# ---------------------------------------------------------------------------

# per architecture, at full width (d_model, heads, d_ff, experts, vocab and
# window as configured) in bf16 from seed 0: the layers served (None = all)
# and the serve sizes (batch, prompt tokens, new tokens); the layers of the
# float32 decode-vs-forward check; the layers trained (None = all) and the
# train sizes (batch, sequence with any frontend prefix, steps), or None
LM_FAMILIES = {
    "recurrentgemma-2b": {"serve": (None, (2, 512, 32)), "check_layers": 3,
                          "train": (None, (2, 2048, 3))},
    "rwkv6-7b": {"serve": (None, (2, 512, 32)), "check_layers": 2,
                 "train": (8, (2, 2048, 3))},
    "moonshot-v1-16b-a3b": {"serve": (16, (2, 512, 32)), "check_layers": 2,
                            "train": (3, (2, 2048, 3))},
    "arctic-480b": {"serve": (1, (2, 256, 8)), "check_layers": 1, "train": None},
    "whisper-small": {"serve": (None, (2, 128, 32)), "check_layers": 2,
                      "train": (None, (8, 448, 3))},
    "internvl2-2b": {"serve": (None, (2, 512, 32)), "check_layers": 2,
                     "train": (None, (4, 2048, 3))},
}
# why a part runs cut, as the [lm-families] lines print it
LM_FAMILY_CUTS = {
    "recurrentgemma-2b": "float32 check at 3 layers (rglru, rglru, attn: the first period)",
    "rwkv6-7b": "train 8 of 32 layers (a train step holds ~22 bytes a parameter: bf16 "
                "parameters, gradients and the new parameters, old and new float32 "
                "moments)",
    "moonshot-v1-16b-a3b": "serve 16 of 48 layers (52.3 GiB in bf16 at full depth), "
                           "train 3 of 48 (4 ran out of the card's memory in Adam)",
    "arctic-480b": "serve 1 of 35 layers (888 GiB in bf16 at full depth), float32 check at "
                   "1 layer (2 would be 107 GB), no training",
    "whisper-small": "none",
    "internvl2-2b": "none",
}
# the decode-vs-forward check's batch and prompt; the recurrent mixers'
# parallel form vs their step recurrence: batch and tokens, and the CPU
# tests' tolerances (relative and absolute)
LM_FAMILY_CHECK = (2, 128)
LM_SCAN_CHECK = (2, 128)
LM_SCAN_TOL = {"rwkv": 2e-4, "rglru": 3e-4}


def _cut(cfg, layers):
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def _n_params(tree) -> int:
    return sum(t.numel() for t in flatten(tree)[1])


def _family_batch(cfg, B: int, S: int, dev, seed: int) -> dict:
    """A prompt or training batch of S text tokens (after any frontend
    prefix; the audio family's frames ride along), drawn from `seed`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = ShapeCell("f", S + (cfg.frontend_tokens or 0), B, "train")
    return model_zoo.make_batch(gen, cfg, shape, batch=B)


def _release(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def family_serve(arch: str, cfg, dev, layers, sizes, card: str) -> dict:
    """Prefill and greedy decode through `launch.serve.generate`, twice."""
    B, S, new = sizes
    cut = _cut(cfg, layers)
    params = model_zoo.build(cut).init(0, device=dev)
    n = _n_params(params)
    batch = _family_batch(cut, B, S, dev, 0)
    cold = lm_serve.generate(cut, params, batch, new)
    _reset_peak(dev)
    r = lm_serve.generate(cut, params, batch, new)
    peak = _peak_gib(dev)
    V = cut.vocab_size
    for name, lg in (("prefill", r.prefill_logits), ("last decode", r.last_logits)):
        check(bool(torch.isfinite(lg[:, :V]).all()), f"[lm-families] {arch}: {name} logits")
        check(bool((lg[:, V:] < -1e29).all()), f"[lm-families] {arch}: {name} padded ids")
    check(tuple(r.tokens.shape) == (B, new) and int(r.tokens.max()) < V,
          f"[lm-families] {arch}: tokens {tuple(r.tokens.shape)}")
    check(torch.equal(r.tokens, cold.tokens), f"[lm-families] {arch}: two greedy runs disagree")
    extra = (f" + {cut.frontend_tokens}-patch prefix" if cut.frontend_tokens else "") + (
        f", {cut.encoder_frames} encoder frames" if cut.family == "audio" else "")
    log(f"[lm-families] serve {arch} ({n:,} parameters, {cut.num_layers} of {cfg.num_layers} "
        f"layers, {cut.param_dtype}): B={B} x {S}{extra} prompt + {new} greedy tokens; prefill "
        f"{r.prefill_s * 1e3:.1f} ms (cold {cold.prefill_s * 1e3:.1f}), decode "
        f"{r.decode_tok_s:.1f} tok/s ({r.decode_s / new * 1e3:.2f} ms a step), peak "
        f"{peak:.3f} GiB; two runs' tokens equal; sample {r.tokens[0, :8].tolist()} | {card}")
    out = {"params": n, "prefill_ms": r.prefill_s * 1e3, "decode_tok_s": r.decode_tok_s,
           "serve_peak_gib": peak}
    del params, r, cold
    _release(dev)
    return out


def family_decode_check(arch: str, cfg, dev, layers: int, sizes, card: str) -> None:
    """Float32 at full width: decode after a (P - 1)-token prefill against the
    P-token forward, within the reference's 1e-3 max(scale, 1) (MoE at
    capacity factor 8, as the reference's smoke test)."""
    B, P = sizes
    cfg32 = dataclasses.replace(cfg, num_layers=layers, param_dtype="float32",
                                compute_dtype="float32")
    if cfg32.num_experts:
        cfg32 = dataclasses.replace(cfg32, capacity_factor=8.0)
    m32 = model_zoo.build(cfg32)
    params = m32.init(1, device=dev)
    batch = _family_batch(cfg32, B, P, dev, 1)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    pos = P - 1 + (cfg32.frontend_tokens or 0)
    with torch.no_grad():
        full, _ = m32.prefill(params, batch)
        _, states = m32.prefill(params, short)
        dec, _ = m32.decode_step(params, batch["tokens"][:, -1:], pos, states)
    V = cfg32.vocab_size
    scale = float(full[:, :V].abs().max())
    err = float((full[:, :V] - dec[:, :V]).abs().max())
    log(f"[lm-families] {arch} float32 at {layers} layer{'s' * (layers > 1)} of full width: "
        f"decode after a {P - 1}-token prefill vs the {P}-token forward, max err {err:.3e} "
        f"(bound 1e-3 max(scale {scale:.3f}, 1)) | {card}")
    check(err < 1e-3 * max(scale, 1.0), f"[lm-families] {arch} decode vs forward: {err}")
    del params, states
    _release(dev)


def _allclose_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max |got - want| / (tol + tol |want|): at most 1 within the CPU tests'
    rtol = atol = tol."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def family_scan_check(arch: str, cfg, dev, sizes, card: str) -> None:
    """The recurrent mixer's parallel form (RWKV-6's chunks, RG-LRU's
    associative scan) against its step recurrence, float32 at full width."""
    from repro_torch.models import rglru, rwkv6

    B, T = sizes
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
    mixer = "rwkv" if "rwkv" in cfg.layer_mixers() else "rglru"
    with torch.no_grad():
        if mixer == "rwkv":
            p = rwkv6.timemix_init(gen, cfg32, dev)
            st0 = rwkv6.timemix_state_init(cfg32, B, torch.float32, dev)
            par, st_par = rwkv6.timemix_apply_chunked(p, x, st0, cfg32)
            step_fn, state_of = rwkv6.timemix_apply_decode, (lambda s: s.S)
        else:
            p = rglru.rglru_init(gen, cfg32, dev)
            st0 = rglru.rglru_state_init(cfg32, B, torch.float32, dev)
            par, st_par = rglru.rglru_apply_train(p, x, st0, cfg32)
            step_fn, state_of = rglru.rglru_apply_decode, (lambda s: s.h)
        st, outs = st0, []
        for t in range(T):
            o, st = step_fn(p, x[:, t:t + 1], st, cfg32)
            outs.append(o)
        seq = torch.cat(outs, 1)
    tol = LM_SCAN_TOL[mixer]
    e_out, e_st = _allclose_err(par, seq, tol), _allclose_err(state_of(st_par), state_of(st), tol)
    log(f"[lm-families] {arch} {mixer} float32 at full width (d={cfg.d_model}), B={B}: the "
        f"parallel form vs {T} decode steps, outputs {e_out:.3f} and state {e_st:.3f} of the "
        f"rtol = atol = {tol:g} bound (max |out| {float(seq.abs().max()):.3f}) | {card}")
    check(e_out <= 1.0 and e_st <= 1.0, f"[lm-families] {arch} parallel vs step: "
          f"{e_out}, {e_st} of the bound")


def family_train(arch: str, cfg, dev, layers, sizes, card: str) -> dict:
    """Train steps through `launch.steps.make_train_step` on one repeated
    `TokenStream` batch: the first loss finite, the last below it."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import default_adam, make_train_step

    B, S, steps = sizes
    cut = _cut(cfg, layers)
    shape = ShapeCell("train", S, B, "train")
    bundle = make_train_step(cut, shape, make_host_mesh(dev), batch=B)
    params = model_zoo.build(cut).init(0, device=dev)
    n = _n_params(params)
    opt = adam_init(params, default_adam(cut))
    batch = TokenStream(cut, shape, batch=B, device=dev).batch(0)
    _reset_peak(dev)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, metrics = bundle.fn(params, opt, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
    peak = _peak_gib(dev)
    step_ms = statistics.median(times[1:]) * 1e3
    aux = f", aux {float(metrics['aux']):.4f}" if cut.num_experts else ""
    log(f"[lm-families] train {arch} ({n:,} parameters, {cut.num_layers} of {cfg.num_layers} "
        f"layers, {cut.param_dtype}, Adam moments {cut.optimizer_state_dtype}): B={B} x {S} "
        f"positions ({B * S} a step); losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"{aux}; step {step_ms:.1f} ms (median after the first, {times[0] * 1e3:.1f} first), "
        f"{B * S / step_ms * 1e3:.0f} positions/s, peak {peak:.3f} GiB | {card}")
    check(all(math.isfinite(x) for x in losses), f"[lm-families] {arch} losses {losses}")
    check(losses[-1] < losses[0], f"[lm-families] {arch}: the loss did not fall: {losses}")
    del params, opt, bundle
    _release(dev)
    return {"train_step_ms": step_ms, "train_tokens_s": B * S / step_ms * 1e3,
            "train_peak_gib": peak}


def phase_lm_families(device: str = "cuda", preset: str = "full", plan=None,
                      check_sizes=LM_FAMILY_CHECK, scan_sizes=LM_SCAN_CHECK) -> dict:
    """The six architectures past the dense decoder, each at full width
    (`preset="smoke"` and a small plan only to rehearse the phase on the
    CPU): served, held float32 decode-vs-forward, the recurrent mixers'
    parallel forms held to their step recurrences, trained. None of it
    launches B1-B7: every counter stays where it was."""
    dev = torch.device(device)
    plan = LM_FAMILIES if plan is None else plan
    card = card_line() if dev.type == "cuda" else "cpu"
    before = counts()
    out = {}
    for arch, part in plan.items():
        cfg = get_config(arch) if preset == "full" else get_smoke_config(arch)
        t0 = time.perf_counter()
        full_n = _n_params(model_zoo.build(cfg).init(device="meta"))
        rec = {"full_params": full_n, **family_serve(arch, cfg, dev, *part["serve"], card)}
        family_decode_check(arch, cfg, dev, part["check_layers"], check_sizes, card)
        if cfg.family in ("ssm", "hybrid"):
            family_scan_check(arch, cfg, dev, scan_sizes, card)
        if part["train"] is not None:
            rec.update(family_train(arch, cfg, dev, *part["train"], card))
        log(f"[lm-families] {arch}: {full_n:,} parameters at full depth; cuts: "
            f"{LM_FAMILY_CUTS[arch] if preset == 'full' else 'smoke config'}; "
            f"{time.perf_counter() - t0:.1f} s | {card}")
        out[arch] = rec
    check(counts() == before, f"[lm-families] an LM family launched a kernel: {counts()} "
          f"vs {before}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the LM sharded over a device mesh (gloo ranks sharing the card)
# ---------------------------------------------------------------------------

# the ranks: (2, 2) and (1, 4) over ranks 0-3, (4, 2) over all eight
MESH_WORLD = 8
MESH_TIMEOUT_S = 600
# smollm-360m at full width and depth: the train step's batch and sequence;
# the served batch, prompt and greedy tokens
MESH_LM_TRAIN = (8, 512)
MESH_LM_SERVE = (2, 512, 8)
# the float32 hold's depth: smollm-360m's widths at 8 of 32 layers (a cut
# for time: every layer runs the same sharded code)
MESH_F32_LAYERS = 8
# one moonshot-v1-16b-a3b MoE layer at full width in float32 at capacity
# factor 8 (no pair dropped), as the reference's EP test runs its layer:
# (batch, sequence) taking the all-to-all path and the all-reduce path
MESH_MOE = {"a2a": (4, 256), "allreduce": (4, 1)}
# the elastic round trip's depth: smollm-360m's widths at 4 of 32 layers
MESH_ELASTIC_LAYERS = 4
# the reference's EP bounds (tests/test_moe.py): the loss within 1e-2
# relative, each leaf's max error within 1e-3 of its max; logits held as
# the loss. They hold the float32 model, and bf16's loss.
MESH_TOL = {"loss": 1e-2, "leaf": 1e-3, "logits": 1e-2}
# bf16 at full depth: its gradients (Adam's first moment after the step),
# its parameters after the step and its prefill logits differ from the
# single process's by bf16's own rounding, summed in another order, which
# is larger than the EP bounds. Each is held at the geometric mean of two
# readings on the single process, per leaf: the noise (bf16 against the
# same model in float32) and a control (a wrong result of the kind a
# sharding fault gives). A leaf's noise reading is taken no lower than the
# median over the leaves (a small leaf can read 0: bf16 parameters after
# Adam's first step differ only where a gradient entry changes sign). The
# control must exceed the noise MESH_SEPARATION times, so that the limit
# lies at least sqrt(MESH_SEPARATION) from each.
MESH_SEPARATION = 4.0


def _mesh_lm_cfg(preset: str):
    """smollm-360m, or its smoke config in bf16 as the full one is."""
    if preset == "full":
        return get_config(LM_ARCH)
    return dataclasses.replace(get_smoke_config(LM_ARCH), param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def _over(gap: float, limit: float) -> float:
    """gap / limit (inf for a gap over a limit of 0)."""
    return gap / limit if limit > 0 else (math.inf if gap > 0 else 0.0)


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (0 where want is all zero and got too)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale > 0 else diff


def _l2(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double().flatten()))


def _gap(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """||got - want|| / scale, in float64."""
    return _l2(got.detach().double() - want.detach().to(got.device).double()) / scale


def _f32(cfg, layers):
    return dataclasses.replace(_cut(cfg, layers), param_dtype="float32",
                               compute_dtype="float32")


def _mesh_batches(cfg, dev, sizes_train, sizes_serve):
    """The train batch (TokenStream batch 0) and the prompt batch, from the
    seed: the same on every rank and in the parent."""
    B, S = sizes_train
    train = TokenStream(cfg, ShapeCell("mesh", S, B, "train"), batch=B, seed=SEED,
                        device=dev).batch(0)
    Bs, Ss, _ = sizes_serve
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    prompt = model_zoo.make_batch(gen, cfg, ShapeCell("mesh", Ss, Bs, "prefill"), batch=Bs)
    return train, prompt


def _teacher_forced(cfg, prefill, decode, params, prompt, tokens):
    """Prefill logits and each decode step's logits, the step i input being
    tokens[:, i - 1] (the greedy token of the prefill for i = 0)."""
    S = prompt["tokens"].shape[1]
    logits, states = prefill(params, prompt)
    out = [sharding.full(logits).float().cpu()]
    tok = (torch.argmax(sharding.full(logits), -1)[:, None] % cfg.vocab_size).to(torch.int32)
    for i in range(tokens.shape[1]):
        if i:
            tok = tokens[:, i - 1:i].to(tok.device)
        logits, states = decode(params, states, tok, S + i)
        out.append(sharding.full(logits).float().cpu())
    return out


def _single_step(cfg, dev, params, train):
    """One `make_train_step(...).jitted()` step on one process: (loss, new
    parameters, Adam's first moment: the clipped gradients times 1 - b1)."""
    B, S = train["tokens"].shape
    one = lm_steps.make_train_step(cfg, ShapeCell("mesh", S, B, "train"), LocalMesh(dev.type),
                                   batch=B)
    new, opt, metrics = one.jitted()(params, adam_init(params, lm_steps.default_adam(cfg)), train)
    return float(metrics["loss"]), new, opt.m


def mesh_lm_reference(cfg, dev, sizes_train, sizes_serve, f32_layers, path: Path) -> None:
    """The single process on the card, saved to `path` (the float32
    tokens also apart, for every rank).

    bf16 at full depth: one train step's loss, first moment and new
    parameters, and `launch.serve.generate`'s prefill logits and tokens.
    Beside them, per leaf, the readings its limits come from (MESH_
    SEPARATION): the noise, the same model in float32 (the widened
    parameters; its new parameters rounded to bf16); the controls: for the
    gradients the step on the first half of the batch alone (what data
    rank 0 would hold without the reduction over "data"), for the
    parameters the update lost (the old parameters: a gap of 1), for the
    logits the prompt one token short (a sequence shard off by one
    position). Gaps are L2 norms: the moments' relative to the moment's,
    the parameters' relative to the step's update, the logits' relative to
    theirs.

    float32 at `f32_layers`: the step's loss, first moment and new
    parameters, generate's greedy tokens and each teacher-forced step's
    logits."""
    model = model_zoo.build(cfg)
    train, prompt = _mesh_batches(cfg, dev, sizes_train, sizes_serve)
    params = model.init(SEED, device=dev)
    paths = flatten(params)[0]
    loss, new, m = _single_step(cfg, dev, params, train)
    new, m = flatten(new)[1], flatten(m)[1]
    upd = [_l2(n.float() - p.float()) for n, p in zip(new, flatten(params)[1])]
    m_l2 = [_l2(t) for t in m]
    half = {k: v[:v.shape[0] // 2] for k, v in train.items()}
    ctl_m = [_gap(a, b, s) for a, b, s in
             zip(flatten(_single_step(cfg, dev, params, half)[2])[1], m, m_l2)]
    served = lm_serve.generate(cfg, params, prompt, sizes_serve[2])
    logits = served.prefill_logits.float()
    short = {k: v[:, :-1] for k, v in prompt.items()}
    ctl_l = _gap(lm_serve.generate(cfg, params, short, 1).prefill_logits.float(), logits,
                 _l2(logits))
    wide = tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    del params
    loss32, new32, m32 = _single_step(cfg32, dev, wide, train)
    noise_m = [_gap(a, b, _l2(b)) for a, b in zip(m, flatten(m32)[1])]
    noise_p = [_gap(a, b.to(a.dtype), s) for a, b, s in zip(new, flatten(new32)[1], upd)]
    del new32, m32
    logits32 = lm_serve.generate(cfg32, wide, prompt, 1).prefill_logits.float()
    del wide
    bf16 = {"loss": loss, "noise_loss": abs(loss32 - loss) / abs(loss32),
            "m": [t.cpu() for t in m], "params": [t.cpu() for t in new], "m_l2": m_l2,
            "upd": upd, "prefill_logits": logits.cpu(), "tokens": served.tokens.cpu(),
            "noise": {"grads": noise_m, "params": noise_p,
                      "logits": [_gap(logits, logits32, _l2(logits32))]},
            "control": {"grads": ctl_m, "params": [1.0] * len(upd), "logits": [ctl_l]}}
    del new, m, logits, logits32
    cfg = _f32(cfg, f32_layers)
    model = model_zoo.build(cfg)
    params = model.init(SEED, device=dev)
    loss, new, m = _single_step(cfg, dev, params, train)
    served = lm_serve.generate(cfg, params, prompt, sizes_serve[2])
    total = sizes_serve[1] + sizes_serve[2] + 1
    steps_logits = _teacher_forced(
        cfg, lambda p, b: model.prefill(p, b, total_slots=total),
        lambda p, st, t, pos: model.decode_step(p, t, pos, st), params, prompt, served.tokens)
    torch.save(served.tokens.cpu(), path.with_name("lm_tokens.pt"))
    torch.save({"bf16": bf16, "paths": paths, "loss": loss,
                "m": [t.cpu() for t in flatten(m)[1]],
                "params": [t.cpu() for t in flatten(new)[1]], "tokens": served.tokens.cpu(),
                "step_logits": steps_logits}, path)


def _mesh_lm_rank(cfg, dev, mesh, sizes_train, sizes_serve, f32_layers, ref_path: Path) -> dict:
    """smollm on the (2, 2) mesh. bf16 at full depth: one train step
    through `make_train_step(...).jitted()` and `generate` on the mesh,
    timed. float32 at `f32_layers`: the same train step, and the
    teacher-forced logits through the prefill and decode bundles. Each
    step's first moment and new parameters gathered and held on rank 0."""
    rank = dist.get_rank()
    B, S = sizes_train
    Bs, Ss, n_new = sizes_serve
    out = {}
    for kind in ("bf16", "f32"):
        c = cfg if kind == "bf16" else _f32(cfg, f32_layers)
        model = model_zoo.build(c)
        train, prompt = _mesh_batches(c, dev, sizes_train, sizes_serve)
        bundle = lm_steps.make_train_step(c, ShapeCell("mesh", S, B, "train"), mesh, batch=B)
        params = sharding.place(model.init(SEED, device=dev), bundle.in_shardings[0])
        opt = sharding.place(adam_init(params, lm_steps.default_adam(c)),
                             bundle.in_shardings[1])
        data = sharding.place(train, bundle.in_shardings[2])
        rec = {}
        if kind == "bf16":
            leaves = flatten(params)[1]
            rec["local_bytes"] = sum(sharding.local(t).numel() * t.element_size() for t in leaves)
            rec["total_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        _reset_peak(dev)
        t0 = time.perf_counter()
        new, opt, metrics = bundle.jitted()(params, opt, data)
        rec["loss"] = float(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rec["t_step"] = time.perf_counter() - t0
        rec["peak_gib"] = _peak_gib(dev)
        # every rank joins each gather; rank 0 keeps the leaves
        got = {}
        for what, tree in (("m", opt.m), ("params", new)):
            got[what] = []
            for t in flatten(tree)[1]:
                t = sharding.full(t)
                if rank == 0:
                    got[what].append(t.cpu())
                del t
        del new, opt, data
        if kind == "bf16":
            _reset_peak(dev)
            t0 = time.perf_counter()
            served = lm_serve.generate(c, params, prompt, n_new, mesh=mesh)
            rec["t_serve"] = time.perf_counter() - t0
            rec["serve_peak_gib"] = _peak_gib(dev)
            rec["tokens"] = served.tokens.cpu()
            rec["prefill_logits"] = served.prefill_logits.float().cpu()
        else:
            total = Ss + n_new + 1
            cell = ShapeCell("mesh", Ss + (c.frontend_tokens or 0), Bs, "prefill")
            prefill = lm_steps.make_prefill_step(c, cell, mesh, batch=Bs,
                                                 total_slots=total).jitted()
            decode = lm_steps.make_decode_step(c, ShapeCell("mesh", total, Bs, "decode"), mesh,
                                               batch=Bs).jitted()
            tokens = torch.load(ref_path.with_name("lm_tokens.pt"))  # the single process's
            t0 = time.perf_counter()
            step_logits = _teacher_forced(c, prefill, decode, params, prompt, tokens)
            rec["t_serve"] = time.perf_counter() - t0
        del params
        if rank == 0:
            ref = torch.load(ref_path)
            paths = ref["paths"]
            if kind == "bf16":
                r = ref["bf16"]
                rec.update(ref_loss=r["loss"], ref_tokens=r["tokens"], noise_loss=r["noise_loss"],
                           noise=r["noise"], control=r["control"], paths=paths, gap={
                               "grads": [_gap(g, w, s) for g, w, s in
                                         zip(got["m"], r["m"], r["m_l2"])],
                               "params": [_gap(g, w, s) for g, w, s in
                                          zip(got["params"], r["params"], r["upd"])],
                               "logits": [_gap(rec["prefill_logits"], r["prefill_logits"],
                                               _l2(r["prefill_logits"]))]})
            else:
                rec.update(
                    ref_loss=ref["loss"],
                    grad_err={p: _leaf_err(g, w) for p, g, w in zip(paths, got["m"], ref["m"])},
                    param_err={p: _leaf_err(g, w) for p, g, w in
                               zip(paths, got["params"], ref["params"])},
                    step_logits_err=[_leaf_err(g, w) for g, w in
                                     zip(step_logits, ref["step_logits"])])
            del ref
        del got
        out[kind] = rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _moe_cfg(preset: str):
    base = get_config("moonshot-v1-16b-a3b") if preset == "full" else \
        get_smoke_config("moonshot-v1-16b-a3b")
    return dataclasses.replace(base, param_dtype="float32", compute_dtype="float32",
                               capacity_factor=8.0)


def _moe_inputs(cfg, dev, sizes):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    params = moe.moe_init(gen, cfg, dev)
    xs = {k: torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
          for k, (B, S) in sizes.items()}
    return params, xs


def mesh_moe_reference(cfg, dev, sizes, path: Path) -> None:
    """`moe_apply_dense` on one process: each batch's output and the
    gradients of sum(y^2) for the input and every parameter."""
    params, xs = _moe_inputs(cfg, dev, sizes)
    out = {}
    for k, x in xs.items():
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        xg = x.detach().requires_grad_(True)
        y = moe.moe_apply_dense(leaves, xg, cfg).y
        loss = torch.sum(y.float() ** 2)
        g = torch.autograd.grad(loss, [xg, *leaves.values()])
        out[k] = {"loss": float(loss), "y": y.detach().cpu(),
                  "grads": dict(zip(["x", *leaves], (t.cpu() for t in g)))}
    torch.save(out, path)


def _mesh_moe_rank(cfg, dev, mesh, sizes, ref_path: Path) -> dict:
    """The MoE layer on the (1, 4) mesh through `moe_apply` (experts over
    the model axis): each batch's route, output and gradients against
    the dense single process."""
    rank = dist.get_rank()
    params, xs = _moe_inputs(cfg, dev, sizes)
    spec = sharding.to_shardings(sharding.param_specs({"moe": params}, mesh), mesh)["moe"]
    placed = sharding.place(params, spec)
    constrain = sharding.make_constrain(mesh)
    ref = torch.load(ref_path) if rank == 0 else None
    routes = {"ep": 0, "a2a": 0}
    orig = (moe.moe_apply_ep, moe.moe_apply_ep_a2a)

    def spy(name, fn):
        def run(*a, **k):
            routes[name] += 1
            return fn(*a, **k)
        return run

    moe.moe_apply_ep, moe.moe_apply_ep_a2a = spy("ep", orig[0]), spy("a2a", orig[1])
    out = {}
    try:
        for k, x in xs.items():
            before = dict(routes)
            leaves = {n: p.detach().requires_grad_(True) for n, p in placed.items()}
            xg = sharding.replicate(x, mesh).detach().requires_grad_(True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sharding.mesh_context(mesh):
                y = moe.moe_apply(leaves, xg, cfg, constrain).y
                loss = torch.sum(y.float() ** 2)
                g = torch.autograd.grad(loss, [xg, *leaves.values()])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec = {"ms": (time.perf_counter() - t0) * 1e3,
                   "route": [n for n in routes if routes[n] > before[n]],
                   "loss": float(sharding.full(loss))}
            y_full = sharding.full(y).cpu()
            g_full = dict(zip(["x", *leaves], (sharding.full(t).cpu() for t in g)))
            if rank == 0:
                want = ref[k]
                rec["loss_err"] = abs(rec["loss"] - want["loss"]) / abs(want["loss"])
                rec["y_err"] = _leaf_err(y_full, want["y"])
                rec["grad_err"] = {n: _leaf_err(g_full[n], want["grads"][n]) for n in g_full}
            out[k] = rec
    finally:
        moe.moe_apply_ep, moe.moe_apply_ep_a2a = orig
    return out


def _mesh_elastic_rank(cfg, dev, mesh22, mesh42, ckpt: Path) -> dict:
    """Save the parameters from the (2, 2) mesh (ranks 0-3), restore them
    with `reshard_for_mesh` on (4, 2) (all eight ranks), save that as step
    2 and restore it on (2, 2): every restored leaf bitwise equal to the
    parameters saved."""
    rank = dist.get_rank()
    model = model_zoo.build(cfg)
    params = model.init(SEED, device=dev)
    abstract = model.init(device="meta")
    mgr = CheckpointManager(ckpt)
    t0 = time.perf_counter()
    if rank < 4:
        placed = sharding.place(params, sharding.to_shardings(
            sharding.param_specs(params, mesh22), mesh22))
        mgr.save(1, {"params": placed}, extra={"step": 1})
    dist.barrier()
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    on42, extra = reshard_for_mesh(str(ckpt), abstract, mesh42, step=1)
    t_42 = time.perf_counter() - t0
    same42 = all(torch.equal(sharding.full(a), b) for a, b in
                 zip(flatten(on42)[1], flatten(params)[1]))
    mgr.save(2, {"params": on42}, extra={"step": 2})
    dist.barrier()
    out = {"extra": extra, "same42": same42, "t_save": t_save, "t_42": t_42,
           "placements42": [str(t.placements) for t in flatten(on42)[1][:3]]}
    if rank < 4:
        t0 = time.perf_counter()
        on22, extra2 = reshard_for_mesh(str(ckpt), abstract, mesh22, step=2)
        out["t_22"] = time.perf_counter() - t0
        out["same22"] = all(torch.equal(sharding.full(a), b) for a, b in
                            zip(flatten(on22)[1], flatten(params)[1]))
        out["extra2"] = extra2
    return out


def _mesh_rank(rank: int, world: int, store: str, tmp: str, device: str, preset: str,
               layers) -> None:
    """One rank of the [mesh] phase: the three parts in turn, results saved."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    tmp = Path(tmp)
    try:
        mesh22 = lm_mesh.make_mesh((2, 2), ("data", "model"), dev.type)
        mesh14 = lm_mesh.make_mesh((1, 4), ("data", "model"), dev.type)
        mesh42 = lm_mesh.make_mesh((4, 2), ("data", "model"), dev.type)
        res = {}
        lm_cfg = _mesh_lm_cfg(preset)
        if rank < 4:
            res["lm"] = _mesh_lm_rank(lm_cfg, dev, mesh22, *layers["lm_sizes"],
                                      layers["f32"], tmp / "lm_ref.pt")
            res["moe"] = _mesh_moe_rank(_moe_cfg(preset), dev, mesh14, layers["moe_sizes"],
                                        tmp / "moe_ref.pt")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["elastic"] = _mesh_elastic_rank(_cut(lm_cfg, layers["elastic"]), dev, mesh22,
                                            mesh42, tmp / "elastic")
        res["host"] = dict(collectives.host_bytes)
        torch.save(res, tmp / f"mesh_r{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_mesh(device: str = "cuda", preset: str = "full", lm_sizes=(MESH_LM_TRAIN,
               MESH_LM_SERVE), moe_sizes=None, elastic_layers=MESH_ELASTIC_LAYERS,
               f32_layers=MESH_F32_LAYERS) -> dict:
    """The LM sharded over a device mesh on the one card (`preset="smoke"`
    and small sizes only to rehearse on the CPU): the single-process
    references here, then eight spawned gloo ranks sharing the card (NCCL
    refuses two ranks on one card): smollm-360m at full width and depth on
    (data 2, model 2), a moonshot MoE layer through both expert-parallel
    paths on (1, 4), and the elastic round trip (2, 2) -> (4, 2) -> (2, 2).
    Held to the single process at MESH_TOL; the LM launches none of B1-B7."""
    dev = torch.device(device)
    card = card_line() if dev.type == "cuda" else "cpu"
    lm_cfg = _mesh_lm_cfg(preset)
    moe_sizes = MESH_MOE if moe_sizes is None else moe_sizes
    before = counts()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        t0 = time.perf_counter()
        mesh_lm_reference(lm_cfg, dev, *lm_sizes, f32_layers, tmp / "lm_ref.pt")
        mesh_moe_reference(_moe_cfg(preset), dev, moe_sizes, tmp / "moe_ref.pt")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        ctx = multiprocessing.get_context("spawn")
        plan = {"lm_sizes": lm_sizes, "moe_sizes": moe_sizes, "elastic": elastic_layers,
                "f32": f32_layers}
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_mesh_rank, args=(r, MESH_WORLD, str(tmp / "store"),
                                                      str(tmp), device, preset, plan))
                 for r in range(MESH_WORLD)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        try:
            for proc in procs:
                proc.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [proc for proc in procs if proc.is_alive()]
            for proc in hung:
                proc.kill()
                proc.join(30)
        t_ranks = time.perf_counter() - t0
        check(not hung, f"[mesh] {len(hung)} ranks still running after {MESH_TIMEOUT_S} s")
        check(all(proc.exitcode == 0 for proc in procs),
              f"[mesh] rank exit codes {[proc.exitcode for proc in procs]}")
        ranks = [torch.load(tmp / f"mesh_r{r}.pt") for r in range(MESH_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[mesh] single-process references {t_ref:.1f} s; {MESH_WORLD} gloo ranks on one "
        f"card {t_ranks:.1f} s (spawn, build, three parts) | {card}")
    failed = []
    tol = MESH_TOL
    # --- part 1: smollm on (2, 2) ---
    lm = [r["lm"] for r in ranks[:4]]
    b16, f32 = lm[0]["bf16"], lm[0]["f32"]
    f32_layers = f32_layers or lm_cfg.num_layers
    log(f"[mesh] lm {lm_cfg.name} bf16 on (data 2, model 2): local parameter bytes "
        + ", ".join(f"rank {i} {x['bf16']['local_bytes']:,}" for i, x in enumerate(lm))
        + f" of {b16['total_bytes']:,} "
        f"({max(x['bf16']['local_bytes'] for x in lm) / b16['total_bytes']:.1%} at most)")
    loss_err = abs(b16["loss"] - b16["ref_loss"]) / abs(b16["ref_loss"])
    log(f"[mesh] lm bf16 train {lm_sizes[0]}, {lm_cfg.num_layers} layers: loss "
        f"{b16['loss']:.6f} vs single process {b16['ref_loss']:.6f}, rel err "
        f"{loss_err:.3e} (tol {tol['loss']:g}; the single process's bf16 vs float32 "
        f"{b16['noise_loss']:.3e}); greedy tokens equal the single process's: "
        f"{bool(torch.equal(b16['tokens'], b16['ref_tokens']))}")
    if not loss_err <= tol["loss"]:
        failed.append(f"lm bf16 loss {loss_err:.3e}")
    for what in ("grads", "params", "logits"):
        names = b16["paths"] if what != "logits" else ["prefill"]
        floor = statistics.median(b16["noise"][what])
        rows = [(n, g, max(nz, floor), ct, math.sqrt(max(nz, floor) * ct)) for n, g, nz, ct in
                zip(names, b16["gap"][what], b16["noise"][what], b16["control"][what])]
        worst = max(rows, key=lambda r: _over(r[1], r[4]))
        log(f"[mesh] lm bf16 {what} (L2 gap to the single process, per leaf): worst "
            f"{worst[0]} {worst[1]:.3e} of limit {worst[4]:.3e} (noise {worst[2]:.3e}, control "
            f"{worst[3]:.3e}); gaps {min(r[1] for r in rows):.2e}-{max(r[1] for r in rows):.2e},"
            f" noise {min(r[2] for r in rows):.2e}-{max(r[2] for r in rows):.2e}, control "
            f"{min(r[3] for r in rows):.2e}-{max(r[3] for r in rows):.2e}")
        bad = [r for r in rows if not r[1] <= r[4]]
        if bad:
            failed.append(f"lm bf16 {what} {len(bad)} over their limits: " + ", ".join(
                f"{r[0]} {r[1]:.3e} > {r[4]:.3e}" for r in bad[:5]))
        blind = [r for r in rows if not r[3] >= MESH_SEPARATION * r[2]]
        if blind:
            failed.append(f"lm bf16 {what}: the control is not {MESH_SEPARATION:g}x the noise "
                          f"at " + ", ".join(f"{r[0]} {r[3]:.3e} vs {r[2]:.3e}" for r in blind[:5]))
    loss_err = abs(f32["loss"] - f32["ref_loss"]) / abs(f32["ref_loss"])
    log(f"[mesh] lm float32 ({f32_layers} of {lm_cfg.num_layers} layers, a cut) train "
        f"{lm_sizes[0]} through the step's entry point: loss {f32['loss']:.6f} vs single "
        f"process {f32['ref_loss']:.6f}, rel err {loss_err:.3e} (tol {tol['loss']:g})")
    if not loss_err <= tol["loss"]:
        failed.append(f"lm float32 loss {loss_err:.3e}")
    for what, name in (("grad_err", "gradient (Adam's first moment)"),
                       ("param_err", "parameters after the step")):
        errs = f32[what]
        worst = max(errs, key=errs.get)
        log(f"[mesh] lm float32 {name} leaves: worst {worst} {errs[worst]:.3e} of its "
            f"max, median {statistics.median(errs.values()):.3e} (tol {tol['leaf']:g})")
        bad = [p for p, e in errs.items() if not e <= tol["leaf"]]
        if bad:
            failed.append(f"lm float32 {what} {len(bad)} leaves over {tol['leaf']:g}: "
                          + ", ".join(f"{p} {errs[p]:.3e}" for p in bad[:5]))
    errs = f32["step_logits_err"]
    log(f"[mesh] lm float32 serve {lm_sizes[1]}: prefill and teacher-forced step logits "
        f"(the single process's greedy tokens fed) err " + " ".join(f"{e:.2e}" for e in errs)
        + f" (tol {tol['logits']:g})")
    if not all(e <= tol["logits"] for e in errs):
        failed.append(f"lm float32 logits {errs}")
    if any(not torch.equal(x["bf16"]["tokens"], b16["tokens"]) for x in lm):
        failed.append("lm bf16 ranks' greedy tokens differ")
    log(f"[mesh] lm times (gloo over the host, 4 ranks on one card: no speed figure): bf16 "
        f"train step (the first, DTensor's sharding propagation included) "
        + ", ".join(f"{x['bf16']['t_step']:.1f}" for x in lm) + " s, generate "
        + ", ".join(f"{x['bf16']['t_serve']:.1f}" for x in lm) + " s, peak (train) "
        + ", ".join(f"{x['bf16']['peak_gib']:.2f}" for x in lm) + " GiB, peak (generate) "
        + ", ".join(f"{x['bf16']['serve_peak_gib']:.2f}" for x in lm) + " GiB (each rank's "
        "own allocations); float32 train step "
        + ", ".join(f"{x['f32']['t_step']:.1f}" for x in lm) + " s, teacher-forced serve "
        + ", ".join(f"{x['f32']['t_serve']:.1f}" for x in lm) + f" s (ranks 0-3) | {card}")
    # --- part 2: the MoE layer on (1, 4) ---
    for k, want_route in (("a2a", "a2a"), ("allreduce", "ep")):
        rec = ranks[0]["moe"][k]
        worst = max(rec["grad_err"], key=rec["grad_err"].get)
        log(f"[mesh] moe {k} {moe_sizes[k]}: route {rec['route']}, loss rel err "
            f"{rec['loss_err']:.3e} (tol {tol['loss']:g}), output err {rec['y_err']:.3e}, "
            f"gradients " + " ".join(f"{n} {e:.2e}" for n, e in rec["grad_err"].items())
            + f" (tol {tol['leaf']:g}); {rec['ms']:.1f} ms (gloo-bound) | {card}")
        if rec["route"] != [want_route]:
            failed.append(f"moe {k} took {rec['route']}, not {want_route}")
        if not (rec["loss_err"] <= tol["loss"] and rec["grad_err"][worst] <= tol["leaf"]):
            failed.append(f"moe {k} loss {rec['loss_err']:.3e} {worst} "
                          f"{rec['grad_err'][worst]:.3e}")
    # --- part 3: elastic ---
    el = [r["elastic"] for r in ranks]
    ok42 = all(x["same42"] for x in el)
    ok22 = all(x["same22"] for x in el[:4])
    log(f"[mesh] elastic ({elastic_layers} of {lm_cfg.num_layers} layers, a cut): saved on "
        f"(2, 2) in {el[0]['t_save']:.1f} s; restored on (4, 2) in {el[0]['t_42']:.1f} s, "
        f"bitwise {ok42}; saved there and restored on (2, 2) in {el[0]['t_22']:.1f} s, "
        f"bitwise {ok22}; placements on (4, 2) {el[0]['placements42']}")
    if not (ok42 and ok22 and el[0]["extra"] == {"step": 1} and el[0]["extra2"] == {"step": 2}):
        failed.append(f"elastic (4, 2) {ok42} (2, 2) {ok22}")
    host = ranks[0]["host"]
    log(f"[mesh] gloo on CUDA tensors: all-gathers through the host (parallel.collectives."
        f"host_all_gather) on rank 0: {host['calls']} calls, {host['all_gather']:,} bytes; "
        f"all-reduce, reduce-scatter and all-to-all carried by gloo itself")
    check(counts() == before, f"[mesh] the LM launched a kernel: {counts()} vs {before}")
    check(not failed, "[mesh] " + "; ".join(failed))
    return {"lm": lm, "moe": ranks[0]["moe"], "elastic": el[0]}


# ---------------------------------------------------------------------------
# phase 21: the LM dry run (launch/dryrun) against the card
# ---------------------------------------------------------------------------

# one rank's predictions held to the card at [lm]'s sizes: train batch x
# sequence, prefill batch x prompt, decode batch x cache slots at a position
LM_DRYRUN_TRAIN = (8, 2048)
LM_DRYRUN_PREFILL = (4, 512)
LM_DRYRUN_DECODE = (4, 576, 512)
# the dry run's peak against torch.cuda.max_memory_allocated over the step
LM_DRYRUN_PEAK_TOL = 0.10
LM_DRYRUN_TIMED = 3  # steps timed after the one the peak is read on
# production cells (arch, shape, mesh), each traced on rank 0 of a fake 256-
# or 512-rank group by a run of the dry run's CLI, all five at once
LM_DRYRUN_CELLS = (("smollm-360m", "train_4k", "pod"), ("smollm-360m", "prefill_32k", "pod"),
                   ("smollm-360m", "decode_32k", "pod"),
                   ("moonshot-v1-16b-a3b", "train_4k", "multipod"),
                   ("recurrentgemma-2b", "long_500k", "pod"))
LM_DRYRUN_TIMEOUT_S = 300


def _lm_dryrun_args(kind: str, cfg, dev):
    """The step's bundle on the one-rank mesh and real arguments on `dev`
    (random weights from the seed)."""
    mesh = lm_mesh.make_host_mesh(dev)
    model = model_zoo.build(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(SEED, device=dev)
    if kind == "train":
        B, S = LM_DRYRUN_TRAIN
        cell = ShapeCell("dry", S, B, "train")
        bundle = lm_steps.make_train_step(cfg, cell, mesh)
        args = (params, adam_init(params, lm_steps.default_adam(cfg)),
                model_zoo.make_batch(gen, cfg, cell))
    elif kind == "prefill":
        B, S = LM_DRYRUN_PREFILL
        cell = ShapeCell("dry", S, B, "prefill")
        bundle = lm_steps.make_prefill_step(cfg, cell, mesh)
        args = (params, model_zoo.make_batch(gen, cfg, cell))
    else:
        B, slots, pos = LM_DRYRUN_DECODE
        bundle = lm_steps.make_decode_step(cfg, ShapeCell("dry", slots, B, "decode"), mesh)
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, dtype=torch.int32,
                               device=dev)
        args = (params, model.init_decode_state(B, slots, device=dev), tokens,
                torch.tensor(pos, dtype=torch.int32, device=dev))
    return bundle, args


def _alloc_bytes(tree) -> int:
    """What the CUDA caching allocator holds for the tensors of `tree`: each
    storage once, in whole 512-byte blocks."""
    seen = {}
    for _, t in sharding.leaves_with_path(tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
    return sum(seen.values())


def lm_dryrun_step(kind: str, cfg, dev, card: str) -> dict:
    """One rank's dry run of smollm-360m's `kind` step (`StepBundle.lower()`,
    traced on this host's CPU on meta tensors) against the same step on
    the card: the predicted peak within LM_DRYRUN_PEAK_TOL of
    `max_memory_allocated` over the step (reset just before it, the
    arguments' blocks counted and anything else resident not), the counted
    matrix-product flops equal to `FlopCounterMode`'s on the real step, and
    the step's time (median of LM_DRYRUN_TIMED) beside the roofline bound."""
    from torch.utils.flop_counter import FlopCounterMode

    bundle, args = _lm_dryrun_args(kind, cfg, dev)
    t0 = time.perf_counter()
    low = bundle.lower()
    lower_s = time.perf_counter() - t0
    terms = low.terms()
    predicted = low.memory["peak_hbm_bytes_est"]
    fn = bundle.jitted()
    arg_bytes = _alloc_bytes(args)
    out = fn(*args)  # the first call: one-time allocations (cuBLAS workspaces)
    torch.cuda.synchronize()
    del out
    resident = torch.cuda.memory_allocated(dev) - arg_bytes  # not the step's
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated(dev) - resident
    del out
    times = []
    for _ in range(LM_DRYRUN_TIMED):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    torch.cuda.synchronize()
    del out
    real_mm = int(fc.get_total_flops())
    counted_mm = int(sum(low.total.matmul_flops.values()))
    step_ms = statistics.median(times) * 1e3
    bound_ms_ = terms["step_lower_bound_s"] * 1e3
    gap = abs(predicted - measured) / measured
    size = {"train": LM_DRYRUN_TRAIN, "prefill": LM_DRYRUN_PREFILL,
            "decode": LM_DRYRUN_DECODE[:2]}[kind]
    gib = {k: v / 2**30 for k, v in low.memory.items()}
    log(f"[lm-dryrun] {cfg.name} {kind} on one rank ({' x '.join(map(str, size))}, "
        f"{cfg.param_dtype}): predicted peak {gib['peak_hbm_bytes_est']:.3f} GiB (arguments "
        f"{gib['argument_bytes']:.3f}, outputs {gib['output_bytes']:.3f}, temporaries "
        f"{gib['temp_bytes']:.3f}, aliased {gib['alias_bytes']:.3f}; traced in {lower_s:.1f} s), "
        f"measured {measured / 2**30:.3f} GiB ({predicted} vs {measured} bytes): off by "
        f"{100 * gap:.2f} % (tol {100 * LM_DRYRUN_PEAK_TOL:g} %); matrix-product flops counted "
        f"{counted_mm:.6e} vs FlopCounterMode {real_mm:.6e}; step {step_ms:.3f} ms (median of "
        f"{LM_DRYRUN_TIMED}) vs the roofline bound {bound_ms_:.3f} ms ({terms['dominant']}; "
        f"compute {terms['t_compute_s'] * 1e3:.3f} ms of which matrix products "
        f"{terms['t_matmul_s'] * 1e3:.3f}, memory {terms['t_memory_s'] * 1e3:.3f} ms): the step "
        f"at {100 * bound_ms_ / step_ms:.1f} % of the bound | {card}")
    check(gap <= LM_DRYRUN_PEAK_TOL,
          f"[lm-dryrun] {kind} peak predicted {predicted} vs measured {measured} bytes")
    check(counted_mm == real_mm, f"[lm-dryrun] {kind} matrix-product flops {counted_mm} vs "
          f"FlopCounterMode {real_mm}")
    del args, bundle
    _release(dev)
    return {"predicted": predicted, "measured": measured, "step_ms": step_ms,
            "bound_ms": bound_ms_, "matmul_flops": counted_mm}


def start_lm_dryrun_cells(out: str) -> list:
    """`python -m repro_torch.launch.dryrun` for each of LM_DRYRUN_CELLS, a
    child process each (the fake process group shares no process with the
    gloo phases), all started at once; they run on the host's CPU while the
    card is busy with `lm_dryrun_step`."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", sh,
         "--mesh", mesh, "--force", "--out", out], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, sh, mesh in LM_DRYRUN_CELLS]


def finish_lm_dryrun_cells(procs: list, out: str, t0: float, card: str) -> list:
    """The children's records: each exits 0 with its record status ok; per
    chip GiB, the dominant term, the bound and the useful share printed."""
    results = []
    for proc in procs:
        try:
            stdout, err = proc.communicate(timeout=LM_DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, err = proc.communicate()
        results.append((proc.returncode, stdout, err))
    for rc, stdout, err in results:
        for line in stdout.splitlines():
            log(f"[lm-dryrun] {line}")
        check(rc == 0, f"[lm-dryrun] dryrun exited {rc}: {err[-3000:]}")
    log(f"[lm-dryrun] the {len(procs)} dry runs, started together: "
        f"{time.perf_counter() - t0:.1f} s")
    recs = []
    for arch, sh, mesh in LM_DRYRUN_CELLS:
        rec = json.loads((Path(out) / f"{arch}_{sh}_{mesh}.json").read_text())
        check(rec["status"] == "ok", f"[lm-dryrun] {arch} x {sh} x {mesh}: {rec}")
        recs.append(rec)
        t = rec["roofline"]
        log(f"[lm-dryrun] {arch} x {sh} x {mesh} ({rec['n_chips']} ranks, rank 0 traced in "
            f"{rec['lower_s']} s): {rec['memory']['peak_hbm_bytes_est'] / 2**30:.3f} GiB a "
            f"chip, dominant {t['dominant']}, bound {t['step_lower_bound_s'] * 1e3:.3f} ms "
            f"(compute {t['t_compute_s'] * 1e3:.3f}, memory {t['t_memory_s'] * 1e3:.3f}, "
            f"collective {t['t_collective_s'] * 1e3:.3f}), useful "
            f"{rec['useful_compute_fraction']:.3f} | predicted for an H100 cluster, not "
            f"measured; {card}")
    return recs


def phase_lm_dryrun(device: str = "cuda") -> dict:
    """The LM dry run (`launch.dryrun`): the production cells on fake
    256/512-rank groups, in children on the host's CPU, while smollm-360m's
    train, prefill and decode steps are predicted on one rank and held to
    the card (`lm_dryrun_step`). No B1-B7 launch."""
    dev = torch.device(device)
    card = card_line()
    before = counts()
    cfg = get_config(LM_ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = start_lm_dryrun_cells(tmp)
        try:
            steps_ = {kind: lm_dryrun_step(kind, cfg, dev, card)
                      for kind in ("train", "prefill", "decode")}
        finally:
            recs = finish_lm_dryrun_cells(procs, tmp, t0, card)
    check(counts() == before, f"[lm-dryrun] a kernel launched: {counts()} vs {before}")
    return {"steps": steps_, "cells": recs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "a CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # the earlier phases launch today's geometry: tuning off (inherited by
    # every spawned child), over a cache no other run wrote
    scratch = tempfile.TemporaryDirectory()
    os.environ[autotune.TUNE_ENV] = "0"
    os.environ[tune.CACHE_ENV] = str(Path(scratch.name) / "tune.json")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return result

    try:
        card = card_line()
        log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
        log(f"[device] float32 matmul: allow_tf32 {tf32[0]}, precision {tf32[1]!r}")
        check(tf32 == (False, "highest"), "float32 matrix products would use TF32")
        phase("build", phase_build)
        errs = phase("forward kernel vs plain", phase_kernels)
        bwd_errs = phase("reverse kernel vs plain", phase_bwd_kernels)
        single_errs = phase("single-statistic kernels vs plain", phase_single_kernels)
        data = serving_data(PAPER[0], PAPER[1])
        served = phase("serving", watched(phase_serving), data)
        trained = phase("training", phase_training, data)
        pallas = phase("pallas training", phase_pallas, data)
        sgpr = phase("sgpr pallas training", phase_sgpr_pallas, data)
        dp = phase("data parallel", phase_data_parallel)
        phase("float32 repeatability", phase_repeatability, data)
        phase("kernels at Q = 20", phase_large_q)
        phase("half precision through the ops", phase_half)
        family = phase("kernel family", phase_kernel_family, data)
        phase("temporal", phase_temporal)
        persist = phase("persistence", watched(phase_persistence), data)
        phase("autotune", phase_autotune, data)
        phase("analysis", phase_analysis)
        dryrun = phase("dry run", phase_dryrun)
        times = phase("times", phase_times, trained, pallas, sgpr, data)
        phase("lm", phase_lm)
        phase("lm families", phase_lm_families)
        phase("mesh", phase_mesh)
        phase("lm dry run", phase_lm_dryrun)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        scratch.cleanup()
    kernels = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        p50 = served[dtype]["p50"]
        log(f"[time] predict p50 {name}: B=1 {p50[1]:.3f} ms, B=256 {p50[256]:.3f} ms")
        # the Product-of-RBFs fits (phase 11) run in float64
        product = family if dtype == torch.float64 else dict.fromkeys(family, 0)
        stored = persist[dtype]["launches"]  # phase 13's state builds and update
        # phase 16's dry run steps in float32
        dry = dryrun["launches"] if dtype == torch.float32 else dict.fromkeys(COUNTERS, 0)
        kernels.append({"name": f"suffstats_fwd_{name}", **ROUTE,
                        "launches": served[dtype]["launches"] + product["suffstats_fwd"]
                        + stored["suffstats_fwd"] + dry["suffstats_fwd"],
                        "max_abs_err": errs[dtype], **times[dtype, "fwd"]})
        kernels.append({"name": f"suffstats_bwd_{name}", **ROUTE_BWD,
                        "launches": trained[dtype]["launches"]["bwd"]
                        + product["suffstats_bwd"] + dry["suffstats_bwd"],
                        "max_abs_err": bwd_errs[dtype], **times[dtype, "bwd"]})
        # B3-B6 from the GP-LVM's pallas path, B7 from the SGPR's
        launches = {**pallas[dtype]["launches"],
                    "kfu_fwd": sgpr[dtype]["launches"]["kfu_fwd"]}
        launches = {k: v + product[k] + stored[k] for k, v in launches.items()}
        for kernel, route in SINGLE_ROUTES.items():
            kernels.append({"name": f"{kernel}_{name}", **route,
                            "launches": launches[kernel],
                            "max_abs_err": single_errs[kernel, dtype],
                            **times[dtype, kernel]})
    log(f"[time] training step float64 sgpr pallas (N={PAPER[0]}, M={PAPER[1]}), mesh= "
        f"over {DP_WORLD} gloo ranks sharing the one card: "
        + ", ".join(f"rank {r} {t:.3f} ms" for r, t in enumerate(dp["gloo"]))
        + f"; one NCCL rank {dp['nccl']:.3f} ms (median of {TIMED_STEPS - 1} after the first)")
    log(f"[phase] total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
