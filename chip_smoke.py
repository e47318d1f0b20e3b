#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, data-parallel,
persistence and tuning paths on one CUDA card.

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
14. The autotuner, on (every earlier phase runs with REPRO_TORCH_TUNE=0
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
15. Times, with the card's name and power limit: each kernel and its plain
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
   printed by phase 8), with one profiled step each: device time by
   kernel and the device's idle share.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import datetime
import inspect
import json
import multiprocessing
import os
import re
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
from repro_torch.optim.adam import flatten, tree_map  # noqa: E402
from repro_torch.serve import GPServer, StateStore, build_state  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.tune import autotune, search  # noqa: E402

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

# NVIDIA H100 SXM published peaks (data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
FP64_PER_S = 34e12
# exp runs on the special-function units: 16 results a clock per SM
# (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz
SFU_EXP_PER_S = 16 * 132 * 1.98e9

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


def kernel_instance(mangled: str) -> str:
    """A short name of a kernel instance from its mangled name, e.g.
    "pair_kernel<double, 1>" or "point_kernel<float, 0, true>"."""
    m = re.search(r"I([fd])((?:L[ib]\d+E)*)E", mangled)
    if not m:
        return mangled
    # the template's name is the <length><name> just before its arguments
    head = mangled[:m.start()]
    names = [head[-n:] for n in range(1, len(head)) if head[:-n].endswith(str(n))]
    if not names:
        return mangled
    args = ["float" if m.group(1) == "f" else "double"]
    for kind, val in re.findall(r"L([ib])(\d+)E", m.group(2)):
        args.append(val if kind == "i" else ("true" if val == "1" else "false"))
    return f"{names[0]}<{', '.join(args)}>"


def phase_build() -> None:
    """Build every library, then print each kernel instance's registers and
    spills from nvcc's -Xptxas -v report."""
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        log(f"[build] {name}: nvcc {secs:.1f} s")
        entry, spill = "?", ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_instance(line.split("'")[1])
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                log(f"[build]   {entry}: {regs} registers; {spill}")


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
    profile_step(model, f"temporal Matern32 step at N={TEMPORAL_N}", top=10)
    # the scan's first level: N/2 batched (d, d) solves and products
    rng = np.random.default_rng(SEED + 3)
    A2, B2 = (torch.as_tensor(rng.normal(size=(TEMPORAL_N // 2, d, d)) + 3.0 * np.eye(d),
                              device="cuda") for _ in range(2))
    solve_ms = cuda_ms(lambda: torch.linalg.solve(A2, B2), reps=5)
    matmul_ms = cuda_ms(lambda: A2 @ B2, reps=5)
    log(f"[time] temporal scan level ({TEMPORAL_N // 2} float64 ({d}, {d}) matrices): "
        f"torch.linalg.solve {solve_ms:.3f} ms, a batched product {matmul_ms:.3f} ms "
        f"(bytes bound of the product {3 * A2.numel() * 8 / HBM_BYTES_PER_S * 1e3:.3f} ms)")
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
# phase 15: times and the bounds
# ---------------------------------------------------------------------------

def _bound(nbytes: int, flops: int, exps: int, dtype) -> tuple:
    """(ms, "bytes" or "operations", the term that binds): the larger of
    the bytes over the memory rate and the operations over their peak
    rate. In float32 the exps run on the special-function units beside the
    FP32 pipes; float64 has no exp unit, so each exp counts as one FP64
    operation."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == torch.float32:
        t_flops, t_exps = flops / FP32_PER_S, exps / SFU_EXP_PER_S
        t_ops, term = max((t_flops, "FP32 flops"), (t_exps, "exps on the SFUs"))
    else:
        t_ops, term = (flops + exps) / FP64_PER_S, "FP64 flops and exps"
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes", "HBM bytes"
    return 1e3 * t_ops, "operations", term


def bound_ms(N, M, Q, D, dtype) -> tuple:
    """Least work of the forward at this shape. psi2 is symmetric, so
    M (M + 1) / 2 pairs per point need an exp and ~(3Q + 2) flops; psiY
    needs M exps and ~(3Q + 2D) flops per point."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (N * (2 * Q + D) + M * Q + Q + M * M + M * D)
    pairs = N * M * (M + 1) // 2
    exps = pairs + N * M
    flops = pairs * (3 * Q + 2) + N * M * (3 * Q + 2 * D)
    return _bound(nbytes, flops, exps, dtype)


def bwd_bound_ms(N, M, Q, D, dtype) -> tuple:
    """Least work of the reverse pass at this shape, each exponential
    evaluated once (the kernel evaluates each psi2 one once, and the psi1
    ones twice: in its point pass and its dZ pass). Per (point, pair): the
    exponent, d = mu - zbar, d^2 r
    and its sum (4Q); T = Gw E and t += T (2); sd += T d and sv += (T d) d
    (4Q); P += E (1); A_q += (E r_q) d_q (3Q): 11Q + 3 flops and one exp.
    Per (point, m): the exponent (4Q), y . gyv (2D), W1 = (y . gyv) K,
    s1 += W1 (2), s1d += W1 d and s1v += (W1 d) d (4Q), dY += K gyv (2D),
    dz1 += (W1 d) b (2Q): 10Q + 4D + 2 flops and one exp. The O(N Q)
    per-point terms are left out (< 0.1 %). Bytes: mu, S, Y, Z, v, l, g2
    and gY read once, dmu, dS, dY, dZ, dv and dl written once."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (2 * N * (2 * Q + D) + 2 * M * Q + M * M + M * D + 2 * Q + 2)
    pairs = N * M * (M + 1) // 2
    exps = pairs + N * M
    flops = pairs * (11 * Q + 3) + N * M * (10 * Q + 4 * D + 2)
    return _bound(nbytes, flops, exps, dtype)


def psi2_bound_ms(N, M, Q, D, dtype) -> tuple:
    """Least work of psi2 alone (B3): the fused forward's psi2 part, M (M +
    1) / 2 pairs per point, an exp and ~(3Q + 2) flops each. Bytes: mu, S,
    Z, v and l read, psi2 written once."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (2 * N * Q + M * Q + Q + 1 + M * M)
    pairs = N * M * (M + 1) // 2
    return _bound(nbytes, pairs * (3 * Q + 2), pairs, dtype)


def psi2_bwd_bound_ms(N, M, Q, D, dtype) -> tuple:
    """Least work of psi2's reverse pass (B4): the fused reverse pass's
    (point, pair) work without its (point, m) terms, each exponential once,
    11Q + 3 flops a pair (bwd_bound_ms). Bytes: mu, S, Z, v, l and g2 read;
    dmu, dS, dZ, dv and dl written once."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (4 * N * Q + 2 * M * Q + M * M + 2 * Q + 2)
    pairs = N * M * (M + 1) // 2
    return _bound(nbytes, pairs * (11 * Q + 3), pairs, dtype)


def psi1_bound_ms(N, M, Q, D, dtype) -> tuple:
    """Least work of psi1 (B5): per (point, m) an exp and ~(3Q + 2) flops
    (the exponent and the v product). Bytes: mu, S, Z, v and l read, psi1
    (N, M) written once, which binds."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (2 * N * Q + M * Q + Q + 1 + N * M)
    return _bound(nbytes, N * M * (3 * Q + 2), N * M, dtype)


def psi1_bwd_bound_ms(N, M, Q, D, dtype) -> tuple:
    """Least work of psi1's reverse pass (B6): per (point, m) an exp and the
    exponent (4Q), W1 = g v K (2), s1 += W1 (1), s1d += W1 d and s1v +=
    (W1 d) d (4Q), dZ += (W1 d) b (2Q): 10Q + 3 flops. Bytes: mu, S, Z, v,
    l and g (N, M) read, dmu, dS, dZ, dv and dl written once; g binds."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (4 * N * Q + N * M + 2 * M * Q + 2 * Q + 2)
    return _bound(nbytes, N * M * (10 * Q + 3), N * M, dtype)


def kfu_bound_ms(N, M, Q, D, dtype) -> tuple:
    """Least work of K_fu (B7): per (point, m) an exp and ~(3Q + 1) flops
    (the exponent and the v product). Bytes: X, Z, v and l read, K_fu
    (N, M) written once, which binds."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (N * Q + M * Q + Q + 1 + N * M)
    return _bound(nbytes, N * M * (3 * Q + 1), N * M, dtype)


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


def profile_step(model, what: str, top: int = 6) -> None:
    """One training step (after an untimed one) under `torch.profiler`:
    the device time of each kernel name (the `top` largest), their sum
    against the step's wall time (host clock to a synchronize, inflated by
    the profiler's own host work), and so the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    config = AdamConfig(lr=1e-2, clip_norm=None, weight_decay=0.0)
    params, state = model.params, adam_init(model.params, config)

    def step():
        _, grads = inference.value_and_grad(model._loss, params, model._data)
        adam_update(grads, state, params, config)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if not by_name:
        log(f"[profile] {what}: the profiler recorded no device time; not measured")
        return
    log(f"[profile] {what}: device busy {busy:.3f} ms of a {wall:.3f} ms profiled step "
        f"({len(by_name)} kernel names; idle share {100 * (1 - busy / wall):.1f} %)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {ms:8.3f} ms  {name[:110]}")


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
    32-row tiles per 8-column d tile; B2's point pass evaluates M and its dZ
    pass whole 32-row tiles."""
    geo, sms = ss.card_geometry(lib, torch.empty(1, Q, device="cuda", dtype=dtype))
    P = ss.psi2_splits(N, M, geo, sms)
    psi2 = (ss.evaluated_slots(M, geo.pairs_per_block)
            * ss.evaluated_rows(N, P, geo.run, geo.group) / N)
    psi1 = {"suffstats_fwd": -(-M // ss.Y_TILE_M) * ss.Y_TILE_M * -(-D // ss.Y_TILE_D),
            "suffstats_bwd": M + -(-M // ss.Z_TILE_M) * ss.Z_TILE_M}.get(lib, 0)
    blocks = ss.pair_blocks(M, geo.pairs_per_block)
    return (f"[slots] {lib} {str(dtype)[6:]} N={N} M={M} Q={Q} D={D}: {psi2:.1f} psi2 "
            f"exponentials a point for the {ss.pair_count(M)} pairs it needs "
            f"({100 * (psi2 / ss.pair_count(M) - 1):.2f} % more)"
            + (f", psi1 {psi1} for the {M} it needs" if psi1 else "")
            + f"; grid {blocks} pair blocks x {P} N-splits, {geo.blocks_per_sm} resident "
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
            profile_step(model, f"training step {name} {key}")
    set_counts(saved)  # timing launches are not a main path's
    return out


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
        served = phase("serving", phase_serving, data)
        trained = phase("training", phase_training, data)
        pallas = phase("pallas training", phase_pallas, data)
        sgpr = phase("sgpr pallas training", phase_sgpr_pallas, data)
        dp = phase("data parallel", phase_data_parallel)
        phase("float32 repeatability", phase_repeatability, data)
        phase("kernels at Q = 20", phase_large_q)
        phase("half precision through the ops", phase_half)
        family = phase("kernel family", phase_kernel_family, data)
        phase("temporal", phase_temporal)
        persist = phase("persistence", phase_persistence, data)
        phase("autotune", phase_autotune, data)
        times = phase("times", phase_times, trained, pallas, sgpr, data)
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
        kernels.append({"name": f"suffstats_fwd_{name}", **ROUTE,
                        "launches": served[dtype]["launches"] + product["suffstats_fwd"]
                        + stored["suffstats_fwd"],
                        "max_abs_err": errs[dtype], **times[dtype, "fwd"]})
        kernels.append({"name": f"suffstats_bwd_{name}", **ROUTE_BWD,
                        "launches": trained[dtype]["launches"]["bwd"]
                        + product["suffstats_bwd"],
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
