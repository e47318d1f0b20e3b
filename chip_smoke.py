#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result):

1. Device: a CUDA device is required (no CPU fallback); prints
   `nvidia-smi --query-gpu=name,power.limit` for the card.
2. Build: every kernel library is compiled from `src/repro_torch/kernels/
   csrc` (one nvcc per source, all at once) into `build/`.
3. Kernel vs plain version on the card: the fused psi-statistics kernel
   against `suffstats_fused_plain` in float64, at the paper's shape
   (N = 1,000,003, M = 100, Q = 1, D = 3) and at N = 100,003, M = 256,
   Q = 4, D = 5, each with S > 0 (GP-LVM) and S = 0 (SGPR). Float64 kernel
   within 1e-10 and float32 kernel within 1e-4 of the float64 plain
   version, relative to max|plain|; two kernel runs bitwise equal.
4. Serving at the paper's §4 scale (N = 1e6, M = 100, Q = 1, D = 3; data
   and parameters from a numpy seed): a GP-LVM state from q(X) and an SGPR
   state from (X, Y), built through `suff_stats(backend="fused")`, served
   by `GPServer(device="cuda")`: predict at B in {1, 16, 256, 300} (diag
   and full covariance), eight concurrent submits, update with 65,536 new
   points and downdate of the same. The float64 run is held to the same
   steps through the plain statistics path (backend="jnp") on the card;
   the float32 run to the float64 one. The kernel's launch count over each
   run must be > 0.
5. Times, with the card's name and power limit: the kernel and the plain
   version at the paper's shape (median of CUDA-event timings), the
   kernel's bound, and predict p50 at B = 1 and B = 256.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.gp import ExactBatch, ExpectedBatch, get, suff_stats  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import suffstats as ss  # noqa: E402
from repro_torch.serve import GPServer, build_state  # noqa: E402

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

# NVIDIA H100 SXM published peaks (data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
FP64_PER_S = 34e12
# exp runs on the special-function units: 16 results a clock per SM
# (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz
SFU_EXP_PER_S = 16 * 132 * 1.98e9

ROUTE = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/suffstats_fwd.cu",
         "replaces": "src/repro/kernels/suffstats.py:299", "library_ms": None}


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
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        log(f"[build] {name}: nvcc {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


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
        ss.LAUNCHES = 0
        t0 = time.perf_counter()
        runs[dtype] = serve_run(data, device="cuda", dtype=dtype, backend="fused",
                                timed=True)
        torch.cuda.synchronize()
        launches = ss.LAUNCHES
        log(f"[serve] {str(dtype)[6:]} kernel path: {launches} kernel launches, "
            f"{time.perf_counter() - t0:.1f} s")
        check(launches > 0, f"{dtype} serving path never launched the kernel")
        _log_times(runs[dtype], f"{str(dtype)[6:]} kernel path")
        result[dtype] = {"launches": launches,
                         "p50": {B: runs[dtype]["gplvm", B, "p50_ms"] for B in (1, 256)}}
    ss.LAUNCHES = 0
    plain = serve_run(data, device="cuda", dtype=torch.float64, backend="jnp", timed=True)
    check(ss.LAUNCHES == 0, "the plain path launched the kernel")
    _log_times(plain, "float64 plain path")
    compare_runs(runs[torch.float64], plain, PRED_TOL_F64, "float64 kernel vs plain path")
    compare_runs(runs[torch.float32], runs[torch.float64], PRED_TOL_F32,
                 "float32 vs float64 kernel path", var_tol=VAR_TOL_F32,
                 prior_var=float(np.exp(data["params"]["kern"]["log_variance"])))
    return result


# ---------------------------------------------------------------------------
# phase 5: times and the bound
# ---------------------------------------------------------------------------

def bound_ms(N, M, Q, D, dtype) -> float:
    """Least time for the work at this shape: the larger of the bytes over
    the memory rate and the operations over their peak rate. psi2 is
    symmetric, so M (M + 1) / 2 pairs per point need an exp and ~(3Q + 2)
    flops; psiY needs M exps and ~(3Q + 2D) flops per point."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (N * (2 * Q + D) + M * Q + Q + M * M + M * D)
    pairs = N * M * (M + 1) // 2
    exps = pairs + N * M
    flops = pairs * (3 * Q + 2) + N * M * (3 * Q + 2 * D)
    if dtype == torch.float32:
        t_ops = max(flops / FP32_PER_S, exps / SFU_EXP_PER_S)
    else:  # no exp unit in float64: count each exp as one FP64 operation
        t_ops = (flops + exps) / FP64_PER_S
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, t_ops)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_times() -> dict:
    N, M, Q, D = PAPER
    x64 = kernel_inputs(N, M, Q, D, True)
    out = {}
    for dtype in (torch.float64, torch.float32):
        x = [a.to(dtype) for a in x64]
        before = ss.LAUNCHES
        ms = cuda_ms(lambda: ss.suffstats_cuda(*x), reps=20)
        ss.LAUNCHES = before  # timing launches are not the main path's
        plain_ms = cuda_ms(lambda: ss.suffstats_fused_plain(*x), reps=3, warmup=1)
        out[dtype] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms(N, M, Q, D, dtype)}
        log(f"[time] suffstats_fwd {str(dtype)[6:]} N={N} M={M} Q={Q} D={D}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{out[dtype]['bound_ms']:.3f} ms (operations)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "a CUDA device", file=sys.stderr)
        return 2
    try:
        card = card_line()
        log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
        phase_build()
        errs = phase_kernels()
        data = serving_data(PAPER[0], PAPER[1])
        served = phase_serving(data)
        times = phase_times()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for dtype in (torch.float32, torch.float64):
        p50 = served[dtype]["p50"]
        log(f"[time] predict p50 {str(dtype)[6:]}: B=1 {p50[1]:.3f} ms, "
            f"B=256 {p50[256]:.3f} ms")
        kernels.append({"name": f"suffstats_fwd_{str(dtype)[6:]}", **ROUTE,
                        "launches": served[dtype]["launches"],
                        "max_abs_err": errs[dtype], **times[dtype],
                        "bound_by": "operations"})
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
