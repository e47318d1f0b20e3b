#!/usr/bin/env python3
"""Check, time and disassemble the port's kernels B1-B7 on one CUDA card.

    python3 scripts/psi2_kernels.py                 # check B1-B4 against the plain versions
    python3 scripts/psi2_kernels.py --kernels B5,B6,B7   # ... or the kernels named
    python3 scripts/psi2_kernels.py --kernels all   # ... or all seven
    python3 scripts/psi2_kernels.py --time          # ... and time them at the paper's shape
    python3 scripts/psi2_kernels.py --time --clocks # ... with the SM clock and power under each
    python3 scripts/psi2_kernels.py --profile       # ... and each wrapper's device time by kernel
    python3 scripts/psi2_kernels.py --sass DIR      # ... and write cuobjdump -sass of each library
    python3 scripts/psi2_kernels.py --src OTHER/src --time --no-check
    python3 scripts/psi2_kernels.py --kernels B6 --time --no-check --b6-runs 16,32,64
    python3 scripts/psi2_kernels.py --no-check --steps   # ... training steps, all four paths

B1 `suffstats_cuda`, B2 `suffstats_bwd_cuda`, B3 `psi2_cuda`, B4
`psi2_bwd_cuda`, B5 `psi1_cuda`, B6 `psi1_bwd_cuda` (K_fu's reverse at
S = 0) and B7 `kfu_cuda` of the `repro_torch` package under --src
(default: this checkout's `src`), each against its plain PyTorch version
run in float64 on the card: rel err = max|kernel - plain| / max|plain| per
output, two launches bitwise equal, at shapes with ragged and odd N and M
(spans that start on and off 16-byte boundaries), every Q class (1..4, the
run-time Q, Q > 16) and, for B6, a row of M = 1000 doubles that outgrows a
stage. --time prints the median of CUDA-event timings of each kernel at
N = 10^6, M = 100, Q = 1, D = 3 beside the card's name and power limit (a
launch's share of 10 back to back, and one launch an event pair, which also
counts the wrapper's host time), so two checkouts can be timed in one call,
in turns; --profile the device
time of each kernel a wrapper launches (torch.profiler, one call after a
warm-up). --b6-runs times B6 again with its plan's run length set to each
value given, through its fast path (where it applies) and its general one
(the plan's other choices follow from the run), each checked first, at the
paper's shape or at --b6-shape N,M,Q. --steps times one training step (the
loss, its gradients through the kernels, the Adam update; host clock to a
synchronize, median of 5 after one) of BayesianGPLVM and SparseGPRegression
through "fused" and "pallas" in both dtypes at the paper's shape, from each
facade's init, so that two checkouts' end-to-end steps can be compared in
one call. Needs a card; exits non-zero on any failed
check.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1_000_003, 100, 1, 3), (100_003, 256, 4, 5), (1, 1, 1, 3),
          (127, 33, 5, 2), (4099, 257, 4, 3), (1_001, 130, 3, 2), (3_001, 33, 17, 2),
          (20_000, 64, 20, 3), (2_003, 13, 32, 3), (5_003, 1_000, 1, 2))
# the shapes above this M check B5-B7 only
PSI2_MAX_M = 512
KERNELS = {"B1": "suffstats_fwd", "B2": "suffstats_bwd", "B3": "psi2_fwd", "B4": "psi2_bwd",
           "B5": "psi1_fwd", "B6": "psi1_bwd", "B7": "kfu_fwd"}
TOL = {"float64": 1e-10, "float32": 1e-4}
INNER = 10  # back-to-back launches an event pair times
PAPER = (1_000_000, 100, 1, 3)


def inputs(torch, N, M, Q, D, pos_S, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-3.0, 3.0, (N, Q))
    S = rng.uniform(0.001, 0.05, (N, Q)) if pos_S else np.zeros((N, Q))
    # above Q = 16 the exponent sums many terms: lengthscales grow with
    # sqrt(Q), so that psi1 and psi2 stay well above underflow
    spread = np.sqrt(Q) if Q > 16 else 1.0
    arrs = (mu, S, rng.normal(size=(N, D)), rng.uniform(-3.0, 3.0, (M, Q)),
            np.float64(1.3), spread * rng.uniform(0.3, 1.2, Q), rng.normal(size=(M, M)),
            rng.normal(size=(M, D)))
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    g = torch.randn(N, M, generator=gen, device="cuda", dtype=torch.float64)
    return [torch.as_tensor(a, device="cuda") for a in arrs] + [g]


def cases(mods, x, names):
    ss, p1, p2, kf = mods
    mu, S, Y, Z, v, l, g2, gY, g = x
    every = {"B1": (ss.suffstats_cuda, ss.suffstats_fused_plain, (mu, S, Y, Z, v, l)),
             "B2": (ss.suffstats_bwd_cuda, ss.suffstats_vjp_plain, (mu, S, Y, Z, v, l, g2, gY)),
             "B3": (p2.psi2_cuda, p2.psi2_plain, (mu, S, Z, v, l)),
             "B4": (ss.psi2_bwd_cuda, ss.psi2_vjp_plain, (mu, S, Z, v, l, g2)),
             "B5": (p1.psi1_cuda, p1.psi1_plain, (mu, S, Z, v, l)),
             "B6": (ss.psi1_bwd_cuda, ss.psi1_vjp_plain, (mu, S, Z, v, l, g)),
             "B7": (kf.kfu_cuda, kf.kfu_plain, (mu, Z, v, l))}
    return {f"{k} {KERNELS[k]}": every[k] for k in names}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check(torch, mods, names) -> bool:
    ok = True
    for N, M, Q, D in SHAPES:
        for pos_S in (True, False):
            x64 = inputs(torch, N, M, Q, D, pos_S)
            for name, (kernel, plain, args) in cases(mods, x64, names).items():
                if M > PSI2_MAX_M and name[:2] in ("B1", "B2", "B3", "B4"):
                    continue  # the psi2 plain versions hold chunk x M^2 terms
                want = _tuple(plain(*args))
                for dt in (torch.float64, torch.float32):
                    xs = [a.to(dt) for a in args]
                    got, again = _tuple(kernel(*xs)), _tuple(kernel(*xs))
                    torch.cuda.synchronize()
                    errs = []
                    for g, a, w in zip(got, again, want):
                        r = float((g.double() - w).abs().max() / w.abs().max().clamp_min(1e-300))
                        good = (bool(torch.isfinite(g).all()) and torch.equal(g, a)
                                and r <= TOL[str(dt)[6:]])
                        ok &= good
                        errs.append(f"{r:.2e}{'' if good else ' FAIL'}")
                    print(f"[check] {name} N={N} M={M} Q={Q} D={D} S{'>' if pos_S else '='}0 "
                          f"{str(dt)[6:]}: rel err {', '.join(errs)}", flush=True)
    return ok


def cuda_ms(torch, fn, reps, warmup=2, inner=1):
    """Median over `reps` CUDA-event pairs, each around `inner` calls back to
    back, of the time a call (inner > 1: the wrapper's host work overlaps
    the previous call's device work)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def clocks_while(torch, fn, seconds: float = 1.5) -> str:
    """Median SM clock and power draw that nvidia-smi samples (every 100 ms,
    the first 0.3 s dropped) while fn runs back to back for `seconds`."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    proc.terminate()
    rows = [r.split(",") for r in proc.communicate()[0].strip().splitlines()[3:]]
    rows = [r for r in rows if len(r) == 2]
    if not rows:
        return "clocks not sampled"
    mhz = statistics.median(float(r[0]) for r in rows)
    watts = statistics.median(float(r[1]) for r in rows)
    return f"SM clock {mhz:.0f} MHz, {watts:.0f} W (median of {len(rows)} samples)"


def time_kernels(torch, mods, names, src: Path, clocks: bool) -> None:
    x64 = inputs(torch, *PAPER, True)
    for dt in (torch.float32, torch.float64):
        x = [a.to(dt) for a in x64]
        for name, (kernel, _, args) in cases(mods, x, names).items():
            one = cuda_ms(torch, lambda: kernel(*args), reps=20)
            ms = cuda_ms(torch, lambda: kernel(*args), reps=20, inner=INNER)
            load = f"; {clocks_while(torch, lambda: kernel(*args))}" if clocks else ""
            print(f"[time] {src} {name} {str(dt)[6:]} N={PAPER[0]} M={PAPER[1]} Q={PAPER[2]} "
                  f"D={PAPER[3]}: {ms:.3f} ms a launch (median of 20 x {INNER} back to back); "
                  f"{one:.3f} ms one launch an event pair{load}", flush=True)


def b6_plan(ss, M, Q, itemsize, R, fast):
    """B6's launch plan at run length R through its fast path (None where
    that does not apply) or its general one (one column tile), built here
    from the library's layout mirrors."""
    if fast:
        G = ss.psi1_bwd_fast_lanes(M, Q, R)
        return (ss.Psi1BwdPlan(R, M, G, ss.psi1_bwd_fast_smem(itemsize, M, Q, R, G), True)
                if G else None)
    G = ss.psi1_bwd_lanes(M, R, itemsize)
    return ss.Psi1BwdPlan(R, M, G, ss.psi1_bwd_smem(itemsize, M, Q, R, M, G), False)


def time_b6_runs(torch, mods, runs, src: Path, shape) -> bool:
    """B6 at `shape` (N, M, Q) with its run length forced to each of `runs`,
    through the fast path where it applies and through the general one:
    checked against the plain reverse pass (float64 on the card), then
    timed. Returns whether every check passed."""
    ss = mods[0]
    plan = ss.psi1_bwd_plan
    N, M, Q = shape
    x64 = inputs(torch, N, M, Q, 3, True)
    mu, S, _, Z, v, l, _, _, g = x64
    want = ss.psi1_vjp_plain(mu, S, Z, v, l, g)
    ok = True
    try:
        for R, fast in [(R, f) for R in runs for f in (True, False)]:
            def forced(M, Q, itemsize, R=R, fast=fast):
                return b6_plan(ss, M, Q, itemsize, R, fast)
            ss.psi1_bwd_plan = forced  # the wrapper launches the plan forced here
            for dt in (torch.float32, torch.float64):
                args = [a.to(dt) for a in (mu, S, Z, v, l, g)]
                p = forced(M, Q, args[0].element_size())
                if p is None or p.smem > ss.SMEM_LIMIT:
                    continue
                got = ss.psi1_bwd_cuda(*args)
                r = max(float((a.double() - w).abs().max() / w.abs().max()) for a, w in zip(got, want))
                good = r <= TOL[str(dt)[6:]]
                ok &= good
                ms = cuda_ms(torch, lambda: ss.psi1_bwd_cuda(*args), reps=20, inner=INNER)
                print(f"[time] {src} B6 psi1_bwd run {R} ({'fast' if p.fast else 'general'} "
                      f"path, lanes {p.lanes}, {p.smem} bytes) "
                      f"{str(dt)[6:]} N={N} M={M} Q={Q}: {ms:.3f} ms (median of 20 x {INNER}); "
                      f"rel err {r:.2e}{'' if good else ' FAIL'}", flush=True)
    finally:
        ss.psi1_bwd_plan = plan
    return ok


def time_steps(torch, src: Path) -> None:
    """The training step of each model x backend x dtype at the paper's
    shape (chip_smoke.py's step), from the facade's own init."""
    from repro_torch.core import inference
    from repro_torch.gp import BayesianGPLVM, SparseGPRegression
    from repro_torch.optim import AdamConfig, adam_init, adam_update

    N, M = PAPER[0], PAPER[1]
    rng = np.random.default_rng(0)
    x = rng.uniform(-3.0, 3.0, (N, 1))
    y = np.hstack([np.sin(2.0 * x), np.cos(3.0 * x), x * np.sin(x)]) + 0.1 * rng.normal(size=(N, 3))
    for dt in (torch.float32, torch.float64):
        X, Y = (torch.as_tensor(a, device="cuda", dtype=dt) for a in (x, y))
        for name, make, data in (("gplvm", lambda b: BayesianGPLVM(M=M, Q=1, backend=b), (Y,)),
                                 ("sgpr", lambda b: SparseGPRegression(M=M, backend=b), (X, Y))):
            for backend in ("fused", "pallas"):
                model = make(backend)
                params = model._place(model.init_params(*data), *data)
                config = AdamConfig(lr=1e-2, clip_norm=None, weight_decay=0.0)
                state = adam_init(params, config)
                times = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, grads = inference.value_and_grad(model._loss, params, model._data)
                    params, state, _ = adam_update(grads, state, params, config)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                print(f"[time] {src} training step {str(dt)[6:]} {name} {backend} N={N} "
                      f"M={M}: {statistics.median(times[1:]):.3f} ms (median of 5 after the "
                      f"first)", flush=True)


def profile_kernels(torch, mods, names, src: Path) -> None:
    from torch.profiler import ProfilerActivity, profile

    x64 = inputs(torch, *PAPER, True)
    for dt in (torch.float32, torch.float64):
        x = [a.to(dt) for a in x64]
        for name, (kernel, _, args) in cases(mods, x, names).items():
            kernel(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                kernel(*args)
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    short = (e.name.replace("void ", "").replace("(anonymous namespace)::", "")
                             .split("<")[0].split("(")[0])
                    by_name[short] = by_name.get(short, 0.0) + e.time_range.elapsed_us() / 1e3
            parts = ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))
            print(f"[profile] {src} {name} {str(dt)[6:]}: {parts} ms", flush=True)


def sass(build_paths: dict, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    tool = "/usr/local/cuda/bin/cuobjdump"
    for name, path in build_paths.items():
        text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        (out / f"{name}.sass").write_text(text)
        print(f"[sass] {name}: {len(text.splitlines())} lines -> {out / (name + '.sass')}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--kernels", default="B1,B2,B3,B4",
                    help="comma-separated names among B1-B7, or 'all'")
    ap.add_argument("--b6-runs", default="",
                    help="comma-separated run lengths to time B6 at")
    ap.add_argument("--b6-shape", default="1000000,100,1",
                    help="N,M,Q of the --b6-runs timings")
    ap.add_argument("--steps", action="store_true",
                    help="time a training step of each model x backend x dtype")
    args = ap.parse_args()
    names = list(KERNELS) if args.kernels == "all" else args.kernels.split(",")
    unknown = sorted(set(names) - set(KERNELS))
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose among {list(KERNELS)}")
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import kfu as kf
    from repro_torch.kernels import psi1 as p1
    from repro_torch.kernels import psi2 as p2
    from repro_torch.kernels import suffstats as ss
    mods = (ss, p1, p2, kf)

    if not torch.cuda.is_available():
        print("psi2_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {args.src}")
    paths = _build.build(sorted({KERNELS[k] for k in names}))
    for name, (secs, out) in _build.BUILD_LOG.items():
        print(f"[build] {name}: nvcc {secs:.1f} s")
        for line in out.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    if args.sass:
        sass(paths, args.sass)
    ok = True
    if not args.no_check:
        ok = check(torch, mods, names)
    if args.time:
        time_kernels(torch, mods, names, args.src, args.clocks)
    if args.b6_runs:
        ok &= time_b6_runs(torch, mods, [int(r) for r in args.b6_runs.split(",")], args.src,
                           [int(x) for x in args.b6_shape.split(",")])
    if args.profile:
        profile_kernels(torch, mods, names, args.src)
    if args.steps:
        time_steps(torch, args.src)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
