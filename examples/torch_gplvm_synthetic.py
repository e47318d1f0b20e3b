"""The paper's §4 experiment in the PyTorch/CUDA port: Bayesian GP-LVM
dimensionality reduction on synthetic data — recover the 1-D latent line
from 3-D observations.

    PYTHONPATH=src python examples/torch_gplvm_synthetic.py [--n 2048] [--backend fused]
    PYTHONPATH=src python examples/torch_gplvm_synthetic.py --device cpu --m 16 --steps 30 --min-corr 0.9

Q = 1 latent dimension, M = 100 inducing points, data drawn through an
RBF-kernel function (`repro_torch.data.gplvm_synthetic`, a numpy draw, not
the JAX example's). Optimizes the bound with Adam (``--lbfgs`` for the
paper's optimizer) through `repro_torch.gp.BayesianGPLVM` on the card
(``--device cpu`` runs the plain versions) and asserts the latent-recovery
correlation (up to sign and scale).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.data import gplvm_synthetic
from repro_torch.gp import BayesianGPLVM, get


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lbfgs", action="store_true", help="paper's optimizer")
    ap.add_argument("--backend", choices=("jnp", "pallas", "fused"),
                    default="jnp",
                    help="psi-statistics path; 'fused' and 'pallas' train "
                         "through the hand-written kernels on the card")
    ap.add_argument("--min-corr", type=float, default=0.95,
                    help="latent-recovery bar (smoke runs relax it: the "
                         "recovery quality depends on the data draw and N)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    X_true, Y = gplvm_synthetic(0, N=args.n, D=3, Q=1, device=args.device)
    print(f"data: N={args.n} 3-D points from a 1-D latent (paper §4)")

    lvm = BayesianGPLVM(kernel=get("rbf")(1), M=args.m, backend=args.backend,
                        device=args.device)
    t0 = time.time()
    lvm.fit(Y, optimizer="lbfgs" if args.lbfgs else "adam", steps=args.steps,
            lr=2e-2, log_every=0 if args.lbfgs else max(args.steps // 8, 1),
            generator=torch.Generator().manual_seed(0))
    dt = time.time() - t0
    print(f"optimized {args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.1f} ms/iter) final loss {lvm.history[-1]:.4f}")

    mu, _ = lvm.latent()
    corr = abs(np.corrcoef(mu[:, 0].cpu().double().numpy(),
                           X_true[:, 0].cpu().double().numpy())[0, 1])
    print(f"|corr(latent, truth)| = {corr:.3f}")
    assert corr > args.min_corr, f"latent line not recovered: {corr:.3f} <= {args.min_corr}"
    print("recovered the 1-D latent structure — paper reproduction OK")
    return corr


if __name__ == "__main__":
    main()
