#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result):

1. Device: a CUDA device is required (no CPU fallback); prints
   `nvidia-smi --query-gpu=name,power.limit` for the card.
2. Build: every kernel library (the forward and the reverse psi-statistics
   kernels) is compiled from `src/repro_torch/kernels/csrc` (one nvcc per
   source, all at once) into `build/`.
3. Kernels vs plain versions on the card, at the paper's shape
   (N = 1,000,003, M = 100, Q = 1, D = 3) and at N = 100,003, M = 256,
   Q = 4, D = 5, each with S > 0 (GP-LVM) and S = 0 (SGPR): the forward
   kernel against `suffstats_fused_plain`, the reverse kernel against
   `suffstats_vjp_plain` with random output cotangents. Float64 kernels
   within 1e-10 and float32 kernels within 1e-4 of the float64 plain
   version, relative to max|plain| per output; two kernel runs bitwise
   equal.
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
6. Times, with the card's name and power limit: each kernel and its plain
   version at the paper's shape (median of CUDA-event timings), the
   kernels' bounds, predict p50 at B = 1 and B = 256, and the median
   training-step time after the first step for both models and dtypes.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import inspect
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
from repro_torch.core import inference  # noqa: E402
from repro_torch.gp import (BayesianGPLVM, ExactBatch, ExpectedBatch,  # noqa: E402
                            SparseGPRegression, get, suff_stats)
from repro_torch.optim import AdamConfig, adam_init, adam_update  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
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


def _leaves(params: dict) -> dict:
    return {"log_variance": params["kern"]["log_variance"],
            "log_lengthscale": params["kern"]["log_lengthscale"],
            **{k: params[k] for k in ("Z", "log_beta", "q_mu", "q_logS")}}


def reverse_pass_extended(mu, S, Y, Z, variance, lengthscale, g2, gY, chunk=128):
    """(dmu, dS, dY, dZ, dvariance, dlengthscale) in numpy's long double
    (x87 80-bit on x86-64 Linux: 11 more bits than float64), point by point
    from equations (8)-(20) of docs/derivations/suffstats_vjp.md with the
    direct (mu - zbar) form: the reference that shows how far a float64
    reverse pass can be trusted where the cotangents cancel."""
    ld = np.longdouble
    check(np.finfo(ld).eps < 1e-18, "numpy long double is not extended precision here")
    mu, S, Y, Z, v, ls, g2, gY = (np.asarray(t.detach().cpu().double().numpy(), dtype=ld)
                                  for t in (mu, S, Y, Z, variance, lengthscale, g2, gY))
    l2 = ls * ls
    zdiff = Z[:, None, :] - Z[None, :, :]  # (M, M, Q)
    zbar = ld(0.5) * (Z[:, None, :] + Z[None, :, :])
    G2p = g2 * v * v * np.exp(-(zdiff * zdiff / (4 * l2)).sum(-1))  # eq. (9)
    gyv = v * gY
    out = {k: [] for k in ("dmu", "dS", "dY")}
    dZ, dv, dl = np.zeros(Z.shape, ld), ld(0), np.zeros(ls.shape, ld)
    for i in range(0, mu.shape[0], chunk):
        m_, s_, y_ = mu[i:i + chunk], S[i:i + chunk], Y[i:i + chunk]
        b, r = 1 / (l2 + s_), 1 / (l2 + 2 * s_)
        # psi1 branch, eq. (8), (10)-(14)
        d1 = m_[:, None, :] - Z[None]  # (c, M, Q)
        K = np.exp(-0.5 * np.log1p(s_ / l2).sum(-1)[:, None]
                   - 0.5 * (d1 * d1 * b[:, None, :]).sum(-1))
        W1 = (y_ @ gyv.T) * K
        s1, s1d, s1v = W1.sum(1), (W1[..., None] * d1).sum(1), (W1[..., None] * d1 * d1).sum(1)
        out["dY"].append(K @ gyv)
        dZ += (W1[..., None] * b[:, None, :] * d1).sum(0)
        # psi2 branch, eq. (9), (15)-(20): T = G2p E over every (a, b)
        d2 = m_[:, None, None, :] - zbar[None]  # (c, M, M, Q)
        E = np.exp(-0.5 * np.log1p(2 * s_ / l2).sum(-1)[:, None, None]
                   - (d2 * d2 * r[:, None, None, :]).sum(-1))
        T = G2p[None] * E
        t, sd, sv = T.sum((1, 2)), (T[..., None] * d2).sum((1, 2)), (T[..., None] * d2 * d2).sum((1, 2))
        out["dmu"].append(-b * s1d - 2 * r * sd)
        out["dS"].append(-0.5 * b * s1[:, None] + 0.5 * b * b * s1v - r * t[:, None] + 2 * r * r * sv)
        dv += (s1 + 2 * t).sum()
        dl += ((s_ * b / ls) * s1[:, None] + ls * b * b * s1v + (2 / ls) * s_ * r * t[:, None]
               + 2 * ls * r * r * sv).sum(0)
        dl += (T.sum(0)[..., None] * zdiff * zdiff).sum((0, 1)) / (2 * ls ** 3)
        # d/dz_a through zbar_ab and zterm_ab, for both orders of the pair
        Ts = T + T.transpose(0, 2, 1)
        dZ += (Ts[..., None] * (r[:, None, None, :] * d2 - zdiff[None] / (2 * l2))).sum((0, 2))
    return (np.concatenate(out["dmu"]), np.concatenate(out["dS"]), np.concatenate(out["dY"]),
            dZ, dv / v, dl)


def check_extended(args: tuple, n: int, what: str) -> list:
    """The reverse kernel and the plain reverse pass on the first n points
    of `args` (the loss's own cotangents), each against the extended-
    precision reference, relative to max|reference| per output. Returns
    the outputs where the kernel's error exceeds EXT_RATIO times the plain
    pass's and EXT_FLOOR."""
    sub = tuple(a[:n] for a in args[:3]) + tuple(args[3:])
    with torch.no_grad():
        kernel, plain = ss.suffstats_bwd_cuda(*sub), ss.suffstats_vjp_plain(*sub)
    ref = reverse_pass_extended(*sub)
    failed = []
    for name, k, p, w in zip(BWD_OUTPUTS, kernel, plain, ref):
        w = np.asarray(w, dtype=np.longdouble).reshape(tuple(k.shape))
        scale = np.abs(w).max()

        def err(x):
            return float(np.abs(np.asarray(x.cpu().numpy(), dtype=np.longdouble) - w).max() / scale)
        ek, ep = err(k), err(p)
        log(f"[train] {what}, first {n} points: {name} vs extended precision: kernel "
            f"{ek:.3e}, plain {ep:.3e}")
        if ek > max(EXT_RATIO * ep, EXT_FLOOR):
            failed.append(f"{name} kernel {ek:.3e} vs plain {ep:.3e} from extended precision")
    return failed


def _grads_and_cotangents(model, params, Y) -> tuple:
    """value_and_grad of the model's loss, and the arguments the op's
    reverse kernel received (inputs plus the output cotangents g2, gY)."""
    seen = []
    real = ops.suffstats_bwd_cuda

    def spy(*args):
        seen.append(args)
        return real(*args)

    ops.suffstats_bwd_cuda = spy
    try:
        loss, grads = inference.value_and_grad(model._loss, params, (Y,))
    finally:
        ops.suffstats_bwd_cuda = real
    check(len(seen) == 1, f"one reverse launch expected, saw {len(seen)}")
    return loss, grads, seen[0]


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

    p0 = BayesianGPLVM(M=M, Q=1, device="cuda").init_params(Y)
    lo, hi = float(p0["q_mu"].min()), float(p0["q_mu"].max())
    p0["Z"] = torch.linspace(lo, hi, M, device="cuda", dtype=torch.float64)[:, None]
    p0["kern"]["log_lengthscale"].fill_(float(np.log((hi - lo) / (M - 1) / 0.75)))
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
        ss.LAUNCHES = ss.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        models = fit_models(data, dtype)
        fwd, bwd = ss.LAUNCHES, ss.BWD_LAUNCHES
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
    for key in ("gplvm", "sgpr"):
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
# phase 6: times and the bounds
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
    evaluated once (the kernel evaluates them twice; that is its design,
    not the work). Per (point, pair): the exponent, d = mu - zbar, d^2 r
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


def phase_times(trained: dict) -> dict:
    """Kernel, plain-version and training-step times; none of these
    launches counts towards a main path."""
    N, M, Q, D = PAPER
    x64 = kernel_inputs(N, M, Q, D, True)
    g64 = bwd_cotangents(M, D)
    counts = (ss.LAUNCHES, ss.BWD_LAUNCHES)
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        x = [a.to(dtype) for a in x64]
        g = [a.to(dtype) for a in g64]
        ms = cuda_ms(lambda: ss.suffstats_cuda(*x), reps=20)
        plain_ms = cuda_ms(lambda: ss.suffstats_fused_plain(*x), reps=3, warmup=1)
        bms = cuda_ms(lambda: ss.suffstats_bwd_cuda(*x, *g), reps=10)
        bplain_ms = cuda_ms(lambda: ss.suffstats_vjp_plain(*x, *g), reps=3, warmup=1)
        for what, t, p, bound in (("fwd", ms, plain_ms, bound_ms(N, M, Q, D, dtype)),
                                  ("bwd", bms, bplain_ms, bwd_bound_ms(N, M, Q, D, dtype))):
            out[dtype, what] = {"ms": t, "plain_ms": p, "bound_ms": bound[0],
                                "bound_by": bound[1]}
            log(f"[time] suffstats_{what} {name} N={N} M={M} Q={Q} D={D}: "
                f"kernel {t:.3f} ms, plain {p:.3f} ms, bound {bound[0]:.3f} ms "
                f"({bound[2]}; kernel at {100 * bound[0] / t:.1f} % of it)")
        for key, model in trained[dtype]["models"].items():
            log(f"[time] training step {name} {key} (N={N}, M={M}): "
                f"{step_ms(model):.3f} ms median of {TIMED_STEPS - 1} after the first")
    ss.LAUNCHES, ss.BWD_LAUNCHES = counts  # timing launches are not a main path's
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "a CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return result

    try:
        card = card_line()
        log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
        phase("build", phase_build)
        errs = phase("forward kernel vs plain", phase_kernels)
        bwd_errs = phase("reverse kernel vs plain", phase_bwd_kernels)
        data = serving_data(PAPER[0], PAPER[1])
        served = phase("serving", phase_serving, data)
        trained = phase("training", phase_training, data)
        times = phase("times", phase_times, trained)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        p50 = served[dtype]["p50"]
        log(f"[time] predict p50 {name}: B=1 {p50[1]:.3f} ms, B=256 {p50[256]:.3f} ms")
        kernels.append({"name": f"suffstats_fwd_{name}", **ROUTE,
                        "launches": served[dtype]["launches"],
                        "max_abs_err": errs[dtype], **times[dtype, "fwd"]})
        kernels.append({"name": f"suffstats_bwd_{name}", **ROUTE_BWD,
                        "launches": trained[dtype]["launches"]["bwd"],
                        "max_abs_err": bwd_errs[dtype], **times[dtype, "bwd"]})
    log(f"[phase] total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
