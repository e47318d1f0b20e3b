"""The cells' inputs, made on the device from the seed: the data Y and the
starting parameters, the same tensors for the program and the reference.

The draw is the one `repro_torch.launch.gp_dryrun.make_problem` makes,
copied here so the program cannot move it: latents uniform over
[-M/2, M/2] (q_mu starts at them, q_logS at log 0.1), inducing points one
unit apart over [-(M-1)/2, (M-1)/2] with the lengthscale at 1 (so K_uu's
condition number stays near 64 at any M, in float32 and float64 alike),
and outputs a random-feature draw of an RBF GP of lengthscale about 1 plus
noise of standard deviation 0.05. A traffic mix may ask for the global
parameters to be moved off that grid (`perturb`), as a refit leaves them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}
_FEATURES = 64
_DRAW_ROWS = 1 << 20  # rows of Y made by one call


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one stream of numbers of the seed."""
    return torch.Generator(device=device).manual_seed((2 * seed + stream) % (1 << 63))


def draw(shape: Dict, seed: int, device, perturb: Optional[Dict] = None):
    """(params, Y) of a configuration's shapes (N, M, Q, D, dtype)."""
    N, M, Q, D = shape["N"], shape["M"], shape["Q"], shape["D"]
    dtype = DTYPES[shape["dtype"]]
    dev = torch.device(device)
    kw = dict(generator=generator(seed, dev), device=dev, dtype=dtype)
    X = M * torch.rand(N, Q, **kw) - M / 2
    omega = torch.randn(Q, _FEATURES, **kw)
    phase = 2 * math.pi * torch.rand(_FEATURES, **kw)
    W = torch.randn(_FEATURES, D, **kw) * math.sqrt(2.0 / _FEATURES)
    Y = torch.empty(N, D, device=dev, dtype=dtype)
    for lo in range(0, N, _DRAW_ROWS):
        hi = min(lo + _DRAW_ROWS, N)
        Y[lo:hi] = torch.cos(X[lo:hi] @ omega + phase) @ W
        Y[lo:hi] += 0.05 * torch.randn(hi - lo, D, **kw)
    grid = torch.linspace(-(M - 1) / 2, (M - 1) / 2, M, device=dev, dtype=dtype)
    Z = torch.stack([grid.roll(q * M // Q) for q in range(Q)], dim=1)
    params = {
        "kern": {"log_variance": torch.zeros((), device=dev, dtype=dtype),
                 "log_lengthscale": torch.zeros(Q, device=dev, dtype=dtype)},
        "Z": Z,
        "log_beta": torch.full((), math.log(100.0), device=dev, dtype=dtype),
        "q_mu": X,
        "q_logS": torch.full((N, Q), math.log(0.1), device=dev, dtype=dtype),
    }
    if perturb:
        g = generator(seed, dev, stream=1)

        def moved(t, half_width):
            u = torch.rand(t.shape, generator=g, device=dev, dtype=dtype)
            return t + half_width * (2 * u - 1)

        for key in ("log_variance", "log_lengthscale"):
            if key in perturb:
                params["kern"][key] = moved(params["kern"][key], perturb[key])
        for key in ("Z", "log_beta"):
            if key in perturb:
                params[key] = moved(params[key], perturb[key])
    return params, Y
