"""Synthetic data (counterpart of `repro.data.synthetic`): the paper's
GP-LVM dataset (§4) and a checkpointable LM token stream.

GP dataset: N 1-D latent points are mapped to D dimensions by function
draws under an RBF kernel: an exact GP draw (a float64 Cholesky) up to
4,096 points, and random Fourier features (Rahimi & Recht) beyond. The
numbers come from a numpy generator seeded by `seed`, so the draw is not
the JAX package's (which comes from `jax.random`), only one of the same
distribution.

LM stream: an infinite deterministic token stream. Batch t is a pure
function of (seed, t), so the iterator's state is one integer and a
restart from a checkpoint reproduces the stream exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.parallel import sharding as shd


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


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenStreamState:
    seed: int
    step: int  # the only mutable state — exactly checkpointable


class TokenStream:
    """Deterministic synthetic LM batches: batch(t) = f(seed, t).

    Each batch comes from a fresh `torch.Generator` on `device`, seeded
    from (seed, t), so a batch needs no state but its index. The tokens
    cannot be the reference's bit for bit (`jax.random` has no torch
    counterpart): a test that holds the two packages to each other feeds
    both the same numpy tokens. `checkpoint_state` / `restore_state` keep
    the reference's {"seed", "step"} dict, so a reference checkpoint's
    data position restores here. With a real corpus, per-host reads would
    live here behind the same interface. `shardings` ({name: Sharding},
    e.g. `sharding.to_shardings(sharding.batch_specs(...), mesh)`) places
    each batch on a device mesh: every rank draws the whole batch and keeps
    its own rows.
    """

    def __init__(self, cfg, shape, *, seed: int = 0, batch: Optional[int] = None,
                 device="cuda", shardings=None):
        from repro_torch.models.model_zoo import batch_shapes

        self.spec = batch_shapes(cfg, shape, batch)
        self.vocab = cfg.vocab_size
        self.state = TokenStreamState(seed=seed, step=0)
        self.device = _device.resolve(device)
        self.shardings = shardings

    def checkpoint_state(self) -> Dict[str, int]:
        return dataclasses.asdict(self.state)

    def restore_state(self, st: Dict[str, int]) -> None:
        self.state = TokenStreamState(seed=int(st["seed"]), step=int(st["step"]))

    def batch(self, t: int) -> Dict[str, torch.Tensor]:
        """Batch t of this stream (its position is not touched)."""
        seed = int(np.random.SeedSequence([self.state.seed, t]).generate_state(1)[0])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        out = {}
        for name, (shp, dtype) in self.spec.items():
            if dtype == torch.int32:
                out[name] = torch.randint(0, self.vocab, shp, generator=gen, dtype=dtype,
                                          device=self.device)
            else:
                out[name] = torch.randn(shp, generator=gen, dtype=torch.float32,
                                        device=self.device).to(dtype)
            if self.shardings is not None and name in self.shardings:
                out[name] = shd.place(out[name], self.shardings[name])
        return out

    def next(self) -> Dict[str, torch.Tensor]:
        out = self.batch(self.state.step)
        self.state.step += 1
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next()
