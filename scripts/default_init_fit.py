#!/usr/bin/env python3
"""Fit a facade from its default init on `chip_smoke.py`'s data, on the CPU,
through the JAX package or the PyTorch port, and print its losses.

    PYTHONPATH=src python scripts/default_init_fit.py --impl jax --model sgpr --dtype float32 --n 200000
    PYTHONPATH=src python scripts/default_init_fit.py --impl jax --model gplvm --dtype float64 --n 200000
    PYTHONPATH=src python scripts/default_init_fit.py --impl torch --probe --n 1000000

The data are `chip_smoke.serving_data(n, 100)`'s (numpy seed 0): (X, Y) for
`SparseGPRegression(M=100, backend="fused")` and the GP-LVM's Y for
`BayesianGPLVM(M=100, Q=1, backend="fused")`. The SGPR starts from the
facade's own init (lengthscale 1, variance 1, log_beta 2, every (N // M)-th
point as an inducing point), which both packages compute alike. The
GP-LVM starts from the port's init (PCA means, inducing points drawn from
them with a generator seeded 0), handed to either package through numpy,
each leaf in its own dtype. Adam runs with the facade's default learning
rate. The last line is one JSON object: the settings and every step's loss.

It answers whether a float32 fault at the default init (a NaN loss, a
trajectory far from float64's) is the model's, shown by the JAX package
too, or the port's. Run one process per (impl, dtype): the JAX package's
dtype is fixed at start-up (`jax_enable_x64`).

`--probe` (the port's SGPR, no fit) instead evaluates the float32 loss at
the init three ways: from float32 statistics, from float64 statistics
rounded to float32, and in float64 throughout. It tells the error the
float32 statistics bring from the error of the float32 epilogue.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _port_gplvm_init(Y, M: int) -> dict:
    """The port's default GP-LVM init of Y, as nested numpy arrays."""
    from repro_torch.gp import BayesianGPLVM

    p = BayesianGPLVM(M=M, Q=1, device="cpu").init_params(Y)

    def to_np(tree):
        return {k: to_np(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}

    return to_np(p)


def _probe(X, Y, m: int) -> dict:
    """The SGPR's float32 loss at its init from float32 and from rounded
    float64 statistics, and its float64 loss (the port, on the CPU)."""
    import torch

    from repro_torch.core import svgp
    from repro_torch.core.psi_stats import SuffStats
    from repro_torch.gp import SparseGPRegression
    from repro_torch.kernels.suffstats import suffstats_fused_plain

    X32, Y32 = torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(Y, dtype=torch.float32)
    gp = SparseGPRegression(M=m, backend="fused", device="cpu")
    p = gp.init_params(X32, Y32)
    n = X32.shape[0]

    def loss32(psi2, psiY) -> float:
        v = torch.exp(p["kern"]["log_variance"])
        stats = SuffStats(psi0=n * v, psi2=psi2, psiY=psiY, yy=(Y32 * Y32).sum(),
                          n=X32.new_full((), float(n)))
        terms = svgp.collapsed_bound(gp.kernel.K(p["kern"], p["Z"]), stats,
                                     torch.exp(p["log_beta"]), Y32.shape[1])
        return float(-terms.bound / n)

    def stats(dtype):
        x = [t.to(dtype) for t in (X32, torch.zeros_like(X32), Y32, p["Z"],
                                   torch.exp(p["kern"]["log_variance"]),
                                   torch.exp(p["kern"]["log_lengthscale"]))]
        return suffstats_fused_plain(*x)

    s32, s64 = stats(torch.float32), stats(torch.float64)
    p64 = {"kern": {k: t.double() for k, t in p["kern"].items()},
           "Z": p["Z"].double(), "log_beta": p["log_beta"].double()}
    return {"psi2_f32_rel_err": float((s32[0].double() - s64[0]).abs().max()
                                      / s64[0].abs().max()),
            "loss_f32_stats": loss32(*s32),
            "loss_f64_stats_rounded": loss32(*(t.float() for t in s64)),
            "loss_f64": float(gp._loss(p64, X32.double(), Y32.double()))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--model", choices=("sgpr", "gplvm"), default="sgpr")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--probe", action="store_true",
                    help="the port's SGPR: float32 init loss from float32 / rounded float64 statistics")
    args = ap.parse_args()

    import numpy as np

    from chip_smoke import serving_data

    data = serving_data(args.n, args.m)
    X = data["X"].astype(args.dtype)
    Y = (data["Y"] if args.model == "sgpr" else data["Y_lvm"]).astype(args.dtype)
    if args.probe:
        if args.impl != "torch" or args.model != "sgpr":
            ap.error("--probe takes --impl torch --model sgpr")
        print(json.dumps({"probe": True, "n": args.n, "m": args.m,
                          **_probe(data["X"], data["Y"], args.m)}))
        return 0
    params = _port_gplvm_init(Y, args.m) if args.model == "gplvm" else None
    t0 = time.perf_counter()
    if args.impl == "jax":
        import jax

        jax.config.update("jax_enable_x64", args.dtype == "float64")
        import jax.numpy as jnp

        from repro.gp import BayesianGPLVM, SparseGPRegression

        if args.model == "sgpr":
            gp = SparseGPRegression(M=args.m, backend="fused").fit(
                jnp.asarray(X), jnp.asarray(Y), steps=args.steps, log_every=1)
        else:
            gp = BayesianGPLVM(M=args.m, Q=1, backend="fused").fit(
                jnp.asarray(Y), steps=args.steps, log_every=1,
                params=jax.tree.map(jnp.asarray, params))
    else:
        from repro_torch import convert
        from repro_torch.gp import BayesianGPLVM, SparseGPRegression

        if args.model == "sgpr":
            gp = SparseGPRegression(M=args.m, backend="fused", device="cpu").fit(
                X, Y, steps=args.steps, log_every=1)
        else:
            gp = BayesianGPLVM(M=args.m, Q=1, backend="fused", device="cpu").fit(
                Y, steps=args.steps, log_every=1,
                params=convert.params_from_numpy(params, device="cpu"))
    history = [float(h) for h in gp.history]
    print(json.dumps({"impl": args.impl, "model": args.model, "dtype": args.dtype,
                      "n": args.n, "m": args.m, "steps": args.steps,
                      "finite": all(math.isfinite(h) for h in history),
                      "seconds": round(time.perf_counter() - t0, 1),
                      "history": [h if math.isfinite(h) else str(h) for h in history],
                      "numpy": np.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
