"""Kernel protocol + string registry (GPy-style), in PyTorch.

Counterpart of `repro.gp.kernels`. Every kernel is a stateless object;
its parameters live in a plain dict of (log-transformed) tensors:

    init(...)                 -> Params             unconstrained init
    K(params, X, X2=None)     -> (N, N2)            dense covariance
    Kdiag(params, X)          -> (N,)               diagonal of K(X, X)
    exact_suff_stats(...)     -> SuffStats          deterministic-X statistics
    expected_suff_stats(...)  -> SuffStats          statistics under q(X)

Ported so far: the base class and the RBF kernel (the paper's, and the
one with a fused statistics kernel). Linear, the Materns, Sum and Product
come with later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple, Type

import torch

from repro_torch import device as _device
from repro_torch.core import psi_stats
from repro_torch.core.psi_stats import SuffStats
from repro_torch.kernels import ref

Params = Dict[str, torch.Tensor]

_REGISTRY: Dict[str, Type["Kernel"]] = {}


def register(name: str) -> Callable[[Type["Kernel"]], Type["Kernel"]]:
    def deco(cls: Type["Kernel"]) -> Type["Kernel"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> Type["Kernel"]:
    """Resolve a kernel class by registry name, e.g. get("rbf")(1)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def default_rbf(kernel: "Kernel | None", input_dim: int) -> "Kernel":
    """The shared defaulting rule: no kernel given -> the paper's RBF."""
    return kernel if kernel is not None else RBF(input_dim)


class Kernel:
    """The protocol every kernel implements (see the module docstring). The
    generic K_fu-based exact statistics that the kernels without a fused
    statistics kernel use come with those kernels, in a later slice."""

    name: str = "kernel"
    input_dim: int

    def init(self, **kwargs) -> Params:
        raise NotImplementedError

    def K(self, params: Params, X: torch.Tensor,
          X2: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError

    def Kdiag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def exact_suff_stats(self, params: Params, X, Y, Z, *,
                         backend: str = "jnp",
                         bwd_backend: str = "auto") -> SuffStats:
        raise NotImplementedError

    def psi0(self, params: Params, mu, S) -> torch.Tensor:
        raise NotImplementedError

    def psi1(self, params: Params, mu, S, Z) -> torch.Tensor:
        raise NotImplementedError

    def psi2(self, params: Params, mu, S, Z) -> torch.Tensor:
        raise NotImplementedError

    def expected_suff_stats(self, params: Params, mu, S, Y, Z, *,
                            backend: str = "jnp",
                            bwd_backend: str = "auto") -> SuffStats:
        raise NotImplementedError


@register("rbf")
@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """RBF (squared exponential) kernel with ARD lengthscales:

        k(x, x') = sigma_f^2 * exp(-0.5 * sum_q (x_q - x'_q)^2 / l_q^2)

    stored as unconstrained log-values. Its statistics run through the
    fused kernel with backend="fused" (expected ones, and exact ones via
    S -> 0).
    """

    input_dim: int

    def init(self, variance: float = 1.0, lengthscale: float = 1.0, *,
             device: str | torch.device = _device.DEFAULT_DEVICE,
             dtype: torch.dtype = torch.float32) -> Params:
        dev = _device.resolve(device)
        return {
            "log_variance": torch.tensor(math.log(variance), dtype=dtype,
                                         device=dev),
            "log_lengthscale": torch.full((self.input_dim,),
                                          math.log(lengthscale), dtype=dtype,
                                          device=dev),
        }

    @staticmethod
    def variance(params: Params) -> torch.Tensor:
        return torch.exp(params["log_variance"])

    @staticmethod
    def lengthscale(params: Params) -> torch.Tensor:
        return torch.exp(params["log_lengthscale"])

    def K(self, params: Params, X: torch.Tensor,
          X2: torch.Tensor | None = None) -> torch.Tensor:
        ls = self.lengthscale(params)
        Xs = X / ls
        X2s = Xs if X2 is None else X2 / ls
        # squared euclidean distances via the (a-b)^2 expansion, as the
        # reference computes them
        d2 = ((Xs**2).sum(-1)[:, None] + (X2s**2).sum(-1)[None, :]
              - 2.0 * Xs @ X2s.T)
        return self.variance(params) * torch.exp(-0.5 * d2.clamp_min(0.0))

    def Kdiag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return self.variance(params).expand(X.shape[0]).clone()

    def exact_suff_stats(self, params, X, Y, Z, *, backend: str = "jnp",
                         bwd_backend: str = "auto") -> SuffStats:
        return psi_stats.exact_stats_rbf(params, X, Y, Z, backend=backend,
                                         bwd_backend=bwd_backend)

    def psi0(self, params, mu, S) -> torch.Tensor:
        return ref.psi0_rbf(mu, S, self.variance(params),
                            self.lengthscale(params))

    def psi1(self, params, mu, S, Z) -> torch.Tensor:
        return ref.psi1_rbf(mu, S, Z, self.variance(params),
                            self.lengthscale(params))

    def psi2(self, params, mu, S, Z) -> torch.Tensor:
        return psi_stats._psi2_rbf_chunked(mu, S, Z, self.variance(params),
                                           self.lengthscale(params))

    def expected_suff_stats(self, params, mu, S, Y, Z, *,
                            backend: str = "jnp",
                            bwd_backend: str = "auto") -> SuffStats:
        return psi_stats.expected_stats_rbf(params, mu, S, Y, Z,
                                            backend=backend,
                                            bwd_backend=bwd_backend)
