"""The paper's synthetic GP-LVM dataset (§4), counterpart of
`repro.data.synthetic.gplvm_synthetic`.

N 1-D latent points are mapped to D dimensions by function draws under an
RBF kernel: an exact GP draw (a float64 Cholesky) up to 4,096 points, and
random Fourier features (Rahimi & Recht) beyond. The numbers come from a
numpy generator seeded by `seed`, so the draw is not the JAX package's
(which comes from `jax.random`), only one of the same distribution.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device


def gplvm_synthetic(seed: int, N: int, D: int = 3, Q: int = 1,
                    lengthscale: float = 1.0, noise_std: float = 0.05,
                    n_features: int = 512, *, device="cuda",
                    dtype: torch.dtype = torch.float32):
    """Returns (X_true (N, Q), Y (N, D)) as tensors on `device` (the CUDA
    device unless ``device="cpu"``), drawn on the host in float64."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (N, Q))
    if N <= 4096:
        # exact GP draw; the float32 Cholesky of a dense RBF Gram matrix is
        # indefinite beyond a few hundred points, so float64
        d2 = ((X[:, None] - X[None, :]) ** 2).sum(-1)
        K = np.exp(-0.5 * d2 / lengthscale**2) + 1e-6 * np.eye(N)
        F = np.linalg.cholesky(K) @ rng.standard_normal((N, D))
    else:
        # random Fourier features: k(x, x') = 2 E[cos(w x + b) cos(w x' + b)]
        omega = rng.standard_normal((Q, n_features)) / lengthscale
        b = rng.uniform(0.0, 2 * np.pi, n_features)
        phi = np.sqrt(2.0 / n_features) * np.cos(X @ omega + b)  # (N, F)
        F = phi @ rng.standard_normal((n_features, D))
    Y = F + noise_std * rng.standard_normal((N, D))
    return (torch.as_tensor(X, dtype=dtype, device=dev),
            torch.as_tensor(Y, dtype=dtype, device=dev))
