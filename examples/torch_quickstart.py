"""Quickstart for the PyTorch/CUDA port: sparse GP regression through the
`repro_torch.gp` facade.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 300] [--backend fused]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 400 --steps 30 --max-rmse 0.3

Fits a sparse GP (Titsias bound, the paper's eq. (2)-(3)) to 1-D data on
the card (``--device cpu`` runs the plain PyTorch versions), then prints
test RMSE and calibration and asserts the JAX quickstart's accuracy bar.
The data come from a numpy generator, so the draw is not the JAX
example's.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.gp import SparseGPRegression, get


def truth(x: np.ndarray) -> np.ndarray:
    return np.sin(2.0 * x) + 0.3 * np.cos(5.0 * x)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--backend", choices=("jnp", "pallas", "fused"),
                    default="jnp",
                    help="statistics path; 'fused' and 'pallas' train through "
                         "the hand-written kernels on the card")
    ap.add_argument("--max-rmse", type=float, default=0.1,
                    help="accuracy bar (smoke sizes/steps warrant a looser one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    N, M = args.n, 32
    X = np.sort(rng.uniform(-3.0, 3.0, (N, 1)), axis=0).astype(np.float32)
    Y = (truth(X[:, 0]) + 0.1 * rng.standard_normal(N)).astype(np.float32)[:, None]

    gp = SparseGPRegression(kernel=get("rbf")(1), M=M, backend=args.backend,
                            device=args.device)
    loss0 = -gp.fit(X, Y, steps=0).elbo() / N  # initial nlml/point (0 steps)
    print(f"initial nlml/point: {loss0:.4f}")
    gp.fit(X, Y, steps=args.steps, lr=3e-2)
    print(f"final   nlml/point: {-gp.elbo() / N:.4f}")

    Xt = np.linspace(-3, 3, 200, dtype=np.float32)[:, None]
    mean, var = (a.cpu().double().numpy() for a in gp.predict(Xt))
    f_true = truth(Xt[:, 0].astype(np.float64))
    rmse = float(np.sqrt(np.mean((mean[:, 0] - f_true) ** 2)))
    inside = float(np.mean(np.abs(mean[:, 0] - f_true) < 2 * np.sqrt(var)))
    print(f"test RMSE {rmse:.4f}; {inside * 100:.0f}% of truth inside 2-sigma")
    p = gp.params
    print(f"learned lengthscale {float(torch.exp(p['kern']['log_lengthscale'])[0]):.3f}, "
          f"noise std {float(torch.exp(p['log_beta'])) ** -0.5:.3f}")
    assert rmse < args.max_rmse, (rmse, args.max_rmse)
    print("quickstart OK")
    return rmse


if __name__ == "__main__":
    main()
