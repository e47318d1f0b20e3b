"""Serve quickstart for the PyTorch/CUDA port: fit once, serve forever —
online updates included.

    PYTHONPATH=src python examples/torch_serve_quickstart.py [--steps 150]
    PYTHONPATH=src python examples/torch_serve_quickstart.py --device cpu --n 1000 --steps 60

Fits a sparse GP on the LEFT half of the input range only, exports the
O(M^2) posterior state into a `GPServer`, serves concurrent predictions
through the micro-batching queue, then streams the RIGHT half of the data
in through `server.update()` — no refit, no access to the original
training set — and shows the predictions on the new region snapping into
place. Asserts the JAX example's criteria. The data come from a numpy
generator, so the draw is not the JAX example's.
"""
import argparse
import sys
from concurrent.futures import Future
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.gp import SparseGPRegression, get
from repro_torch.serve import GPServer


def rmse(mean: torch.Tensor, truth: np.ndarray) -> float:
    return float(np.sqrt(np.mean((mean.cpu().double().numpy()[:, 0] - truth) ** 2)))


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    N, M = args.n, 32
    X = np.sort(rng.uniform(-3.0, 3.0, (N, 1)), axis=0).astype(np.float32)
    f = np.sin(2.0 * X[:, 0])
    Y = (f + 0.1 * rng.standard_normal(N)).astype(np.float32)[:, None]
    left = X[:, 0] < 0.0

    # --- fit on the left half only; the right half arrives "in production".
    # Inducing points span the FULL expected input domain (not just the
    # fitted half): online updates can only sharpen the posterior inside
    # span{k(., z_m)}, so a serving deployment places Z over the domain it
    # intends to serve, not over the data it happens to start with.
    gp = SparseGPRegression(kernel=get("rbf")(1), M=M, device=args.device)
    params = gp.init_params(X[left], Y[left])
    params["Z"] = torch.linspace(-3.0, 3.0, M, device=params["Z"].device)[:, None]
    gp.fit(X[left], Y[left], steps=args.steps, lr=3e-2, params=params)

    server = GPServer(device=args.device)
    server.register("demo", gp)  # export_state(): Choleskys + SuffStats
    print(f"registered state: M={server.state('demo').M}, "
          f"n={float(server.state('demo').stats.n):.0f} points absorbed")

    # --- concurrent predictions through the micro-batching queue
    Xt = np.linspace(0.1, 3.0, 128, dtype=np.float32)[:, None]  # the UNSEEN region
    f_t = np.sin(2.0 * Xt[:, 0].astype(np.float64))
    futures: list[Future] = [server.submit("demo", Xt[i: i + 16]) for i in range(0, 128, 16)]
    mean_before = torch.cat([fut.result(timeout=60)[0] for fut in futures])
    before = rmse(mean_before, f_t)
    print(f"RMSE on unseen region before update: {before:.3f}")

    # --- stream the right half in: monoid fold + O(M^3) refold, no refit
    right_idx = np.flatnonzero(~left)
    for start in range(0, right_idx.size, 256):
        sl = right_idx[start: start + 256]
        server.update("demo", X[sl], Y[sl])
    print(f"absorbed {right_idx.size} new points online "
          f"(n={float(server.state('demo').stats.n):.0f})")

    mean_after, var_after = server.predict("demo", Xt)
    after = rmse(mean_after, f_t)
    err = np.abs(mean_after.cpu().double().numpy()[:, 0] - f_t)
    inside = float(np.mean(err < 2.0 * np.sqrt(var_after.cpu().double().numpy())))
    print(f"RMSE on unseen region after update:  {after:.3f} "
          f"({inside * 100:.0f}% of truth inside 2-sigma)")
    server.close()

    assert after < 0.5 * before, (before, after)
    assert after < 0.2, after
    print("serve quickstart OK")
    return before, after


if __name__ == "__main__":
    main()
