#!/usr/bin/env python3
"""Check, time and disassemble the psi2 kernels B1-B4 on one CUDA card.

    python3 scripts/psi2_kernels.py                 # check against the plain versions
    python3 scripts/psi2_kernels.py --time          # ... and time them at the paper's shape
    python3 scripts/psi2_kernels.py --time --clocks # ... with the SM clock and power under each
    python3 scripts/psi2_kernels.py --profile       # ... and each wrapper's device time by kernel
    python3 scripts/psi2_kernels.py --sass DIR      # ... and write cuobjdump -sass of each library
    python3 scripts/psi2_kernels.py --src OTHER/src --time --no-check

B1 `suffstats_cuda`, B2 `suffstats_bwd_cuda`, B3 `psi2_cuda` and B4
`psi2_bwd_cuda` of the `repro_torch` package under --src (default: this
checkout's `src`), each against its plain PyTorch version run in float64 on
the card: rel err = max|kernel - plain| / max|plain| per output, two
launches bitwise equal. --time prints the median of CUDA-event timings of
each kernel at N = 10^6, M = 100, Q = 1, D = 3 beside the card's name and
power limit, so two checkouts can be timed in one call, in turns;
--profile the device time of each kernel a wrapper launches (torch.profiler,
one call after a warm-up). Needs a card; exits non-zero on any failed
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
          (127, 33, 5, 2), (4099, 257, 4, 3))
TOL = {"float64": 1e-10, "float32": 1e-4}
PAPER = (1_000_000, 100, 1, 3)


def inputs(torch, N, M, Q, D, pos_S, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-3.0, 3.0, (N, Q))
    S = rng.uniform(0.001, 0.05, (N, Q)) if pos_S else np.zeros((N, Q))
    arrs = (mu, S, rng.normal(size=(N, D)), rng.uniform(-3.0, 3.0, (M, Q)),
            np.float64(1.3), rng.uniform(0.3, 1.2, Q), rng.normal(size=(M, M)),
            rng.normal(size=(M, D)))
    return [torch.as_tensor(a, device="cuda") for a in arrs]


def cases(ss, p2, x):
    mu, S, Y, Z, v, l, g2, gY = x
    return {"B1 suffstats_fwd": (ss.suffstats_cuda, ss.suffstats_fused_plain, (mu, S, Y, Z, v, l)),
            "B2 suffstats_bwd": (ss.suffstats_bwd_cuda, ss.suffstats_vjp_plain,
                                 (mu, S, Y, Z, v, l, g2, gY)),
            "B3 psi2_fwd": (p2.psi2_cuda, p2.psi2_plain, (mu, S, Z, v, l)),
            "B4 psi2_bwd": (ss.psi2_bwd_cuda, ss.psi2_vjp_plain, (mu, S, Z, v, l, g2))}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check(torch, ss, p2) -> bool:
    ok = True
    for N, M, Q, D in SHAPES:
        for pos_S in (True, False):
            x64 = inputs(torch, N, M, Q, D, pos_S)
            for name, (kernel, plain, args) in cases(ss, p2, x64).items():
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


def cuda_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def time_kernels(torch, ss, p2, src: Path, clocks: bool) -> None:
    x64 = inputs(torch, *PAPER, True)
    for dt in (torch.float32, torch.float64):
        x = [a.to(dt) for a in x64]
        for name, (kernel, _, args) in cases(ss, p2, x).items():
            ms = cuda_ms(torch, lambda: kernel(*args), reps=20)
            load = f"; {clocks_while(torch, lambda: kernel(*args))}" if clocks else ""
            print(f"[time] {src} {name} {str(dt)[6:]} N={PAPER[0]} M={PAPER[1]} Q={PAPER[2]} "
                  f"D={PAPER[3]}: {ms:.3f} ms (median of 20){load}", flush=True)


def profile_kernels(torch, ss, p2, src: Path) -> None:
    from torch.profiler import ProfilerActivity, profile

    x64 = inputs(torch, *PAPER, True)
    for dt in (torch.float32, torch.float64):
        x = [a.to(dt) for a in x64]
        for name, (kernel, _, args) in cases(ss, p2, x).items():
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
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import psi2 as p2
    from repro_torch.kernels import suffstats as ss

    if not torch.cuda.is_available():
        print("psi2_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {args.src}")
    names = ("suffstats_fwd", "suffstats_bwd", "psi2_fwd", "psi2_bwd")
    paths = _build.build(names)
    for name, (secs, out) in _build.BUILD_LOG.items():
        print(f"[build] {name}: nvcc {secs:.1f} s")
        for line in out.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    if args.sass:
        sass(paths, args.sass)
    ok = True
    if not args.no_check:
        ok = check(torch, ss, p2)
    if args.time:
        time_kernels(torch, ss, p2, args.src, args.clocks)
    if args.profile:
        profile_kernels(torch, ss, p2, args.src)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
