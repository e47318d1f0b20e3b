"""Kernel protocol + string registry (GPy-style), in PyTorch.

Counterpart of `repro.gp.kernels`. Every kernel is a stateless object;
its parameters live in a plain dict of (log-transformed) tensors:

    init(...)                 -> Params             unconstrained init
    K(params, X, X2=None)     -> (N, N2)            dense covariance
    Kdiag(params, X)          -> (N,)               diagonal of K(X, X)
    exact_suff_stats(...)     -> SuffStats          deterministic-X statistics
    expected_suff_stats(...)  -> SuffStats          statistics under q(X)

Expected (psi) statistics additionally factor through `psi0/psi1/psi2`,
which is what lets `Sum` compose them: psi2 of a sum kernel needs the
closed-form cross statistics sum_n <kA(x_n, z_m) kB(x_n, z_m')> between
every pair of parts (RBF x Linear and Linear x Linear here). The Materns
have no closed-form psi statistics: they support the exact path, and on
1-D inputs the state-space (temporal) backend through `to_sde()`.

Every `init` takes ``device=`` (the CUDA device unless ``device="cpu"``)
and ``dtype=`` (float32 by default, as the reference's); composites pass
both to their parts.
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
    """Base kernel: generic exact statistics via K_fu, psi-statistics
    abstract.

    `exact_suff_stats` works for any kernel that can evaluate K — the
    supervised sparse-GP path only needs K_fu products. The expected path
    needs the kernel-specific closed forms (psi0/psi1/psi2).
    """

    name: str = "kernel"
    input_dim: int

    def init(self, **kwargs) -> Params:
        raise NotImplementedError(
            f"{type(self).__name__} does not define init()")

    def K(self, params: Params, X: torch.Tensor,
          X2: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} does not define K()")

    def Kdiag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not define Kdiag()")

    def _check_backend(self, backend: str) -> None:
        # loud rather than a silent plain fallback: only the RBF hot path
        # (and delegating composites like an all-RBF Product) have kernels
        if backend != "jnp":
            raise ValueError(
                f"{type(self).__name__} implements backend='jnp' statistics "
                f"only (got {backend!r}); the Pallas/fused backends exist for "
                f"the RBF kernel"
            )

    # -- exact statistics (deterministic X) ---------------------------------
    def exact_suff_stats(self, params: Params, X, Y, Z, *,
                         backend: str = "jnp",
                         bwd_backend: str = "auto") -> SuffStats:
        self._check_backend(backend)
        del bwd_backend  # only the RBF kernel's backends have hand-written
        # reverse passes; the generic path differentiates through autograd
        Kfu = self.K(params, X, Z)
        return SuffStats(psi0=self.Kdiag(params, X).sum(),
                         psi2=psi_stats.stat_matmul(Kfu.T, Kfu),
                         psiY=psi_stats.stat_matmul(Kfu.T, Y),
                         yy=(Y * Y).sum(), n=Kfu.new_full((), float(X.shape[0])))

    # -- expected statistics under q(X) = prod_n N(mu_n, diag(S_n)) ---------
    def psi0(self, params: Params, mu, S) -> torch.Tensor:
        raise NotImplementedError(self._no_psi())

    def psi1(self, params: Params, mu, S, Z) -> torch.Tensor:
        raise NotImplementedError(self._no_psi())

    def psi2(self, params: Params, mu, S, Z) -> torch.Tensor:
        raise NotImplementedError(self._no_psi())

    def expected_suff_stats(self, params: Params, mu, S, Y, Z, *,
                            backend: str = "jnp",
                            bwd_backend: str = "auto") -> SuffStats:
        self._check_backend(backend)
        del bwd_backend  # see exact_suff_stats
        psi1 = self.psi1(params, mu, S, Z)
        return SuffStats(psi0=self.psi0(params, mu, S),
                         psi2=self.psi2(params, mu, S, Z),
                         psiY=psi_stats.stat_matmul(psi1.T, Y),
                         yy=(Y * Y).sum(), n=mu.new_full((), float(mu.shape[0])))

    def _no_psi(self) -> str:
        return (
            f"closed-form psi statistics under Gaussian q(X) do not exist for "
            f"the {type(self).__name__!r} kernel; it supports the exact "
            f"(deterministic-X) path only. Use an 'rbf'/'linear' kernel (or a "
            f"Sum/Product of them) for Bayesian GP-LVM models."
        )

    # -- capability queries (what facades dispatch on) -----------------------
    def supports_psi(self) -> bool:
        """True when the closed-form expected (psi) statistics path exists."""
        return type(self).psi0 is not Kernel.psi0

    def supports_sde(self) -> bool:
        """True when `to_sde()` works: the kernel has an exact state-space
        (LTI SDE) form, so the temporal backend can train and serve it."""
        return False

    def to_sde(self, params: Params):
        """The kernel's exact LTI SDE (`repro_torch.temporal.sde.LTISDE`) at
        the given hyperparameters — the hook the temporal backend
        dispatches through."""
        raise NotImplementedError(
            f"kernel {type(self).__name__!r} has no state-space (SDE) form; "
            f"backend='temporal' supports 'matern12'/'matern32'/'matern52' "
            f"on 1-D inputs, and Sum/Product compositions of those"
        )


def _log_full(n: int, value: float, device, dtype) -> torch.Tensor:
    return torch.full((n,), math.log(value), dtype=dtype,
                      device=_device.resolve(device))


def _log_scalar(value: float, device, dtype) -> torch.Tensor:
    return torch.tensor(math.log(value), dtype=dtype,
                        device=_device.resolve(device))


@register("rbf")
@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """RBF (squared exponential) kernel with ARD lengthscales:

        k(x, x') = sigma_f^2 * exp(-0.5 * sum_q (x_q - x'_q)^2 / l_q^2)

    stored as unconstrained log-values. Its statistics run through the
    fused kernel with backend="fused" (expected ones, and exact ones via
    S -> 0) and through the single-statistic kernels with backend="pallas"
    (K_fu for the exact ones, psi1 and psi2 for the expected ones).
    """

    input_dim: int

    def init(self, variance: float = 1.0, lengthscale: float = 1.0, *,
             device: str | torch.device = _device.DEFAULT_DEVICE,
             dtype: torch.dtype = torch.float32) -> Params:
        return {"log_variance": _log_scalar(variance, device, dtype),
                "log_lengthscale": _log_full(self.input_dim, lengthscale,
                                             device, dtype)}

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


@register("linear")
@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    """Linear kernel k(x, x') = sum_q a_q x_q x'_q (ARD variances), with
    closed-form psi statistics."""

    input_dim: int

    def init(self, variance: float = 1.0, *,
             device: str | torch.device = _device.DEFAULT_DEVICE,
             dtype: torch.dtype = torch.float32) -> Params:
        return {"log_ard": _log_full(self.input_dim, variance, device, dtype)}

    @staticmethod
    def ard(params: Params) -> torch.Tensor:
        return torch.exp(params["log_ard"])

    def K(self, params: Params, X: torch.Tensor,
          X2: torch.Tensor | None = None) -> torch.Tensor:
        X2 = X if X2 is None else X2
        return (X * self.ard(params)) @ X2.T

    def Kdiag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return (self.ard(params) * X * X).sum(-1)

    def psi0(self, params, mu, S) -> torch.Tensor:
        return ref.psi0_linear(mu, S, self.ard(params))

    def psi1(self, params, mu, S, Z) -> torch.Tensor:
        return ref.psi1_linear(mu, S, Z, self.ard(params))

    def psi2(self, params, mu, S, Z) -> torch.Tensor:
        return ref.psi2_linear(mu, S, Z, self.ard(params))


@dataclasses.dataclass(frozen=True)
class _Matern(Kernel):
    """Shared machinery of the Matern family: K is a function of the scaled
    distance r = sqrt(sum_q (x_q - x'_q)^2 / l_q^2). No closed-form psi
    statistics under Gaussian q(X) exist, so only the exact path is
    supported — the base-class expected statistics raise."""

    input_dim: int

    def init(self, variance: float = 1.0, lengthscale: float = 1.0, *,
             device: str | torch.device = _device.DEFAULT_DEVICE,
             dtype: torch.dtype = torch.float32) -> Params:
        return {"log_variance": _log_scalar(variance, device, dtype),
                "log_lengthscale": _log_full(self.input_dim, lengthscale,
                                             device, dtype)}

    @staticmethod
    def variance(params: Params) -> torch.Tensor:
        return torch.exp(params["log_variance"])

    @staticmethod
    def lengthscale(params: Params) -> torch.Tensor:
        return torch.exp(params["log_lengthscale"])

    def _r(self, params: Params, X: torch.Tensor,
           X2: torch.Tensor | None) -> torch.Tensor:
        ls = self.lengthscale(params)
        Xs = X / ls
        X2s = Xs if X2 is None else X2 / ls
        # the reference's expanded form: on the diagonal d2 cancels to
        # ~1e-15, not 0, which K inherits (see `Kdiag`)
        d2 = ((Xs**2).sum(-1)[:, None] + (X2s**2).sum(-1)[None, :]
              - 2.0 * Xs @ X2s.T)
        # sqrt has an infinite derivative at 0: clamp from below
        return torch.sqrt(d2.clamp_min(1e-18))

    def _shape_fn(self, r: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def K(self, params: Params, X: torch.Tensor,
          X2: torch.Tensor | None = None) -> torch.Tensor:
        return self.variance(params) * self._shape_fn(self._r(params, X, X2))

    def Kdiag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return self.variance(params).expand(X.shape[0]).clone()

    def _no_psi(self) -> str:
        return (
            f"closed-form psi statistics under Gaussian q(X) do not exist for "
            f"the {type(self).__name__!r} kernel (the expectation of exp(-r) "
            f"has no elementary form), so the collapsed-bound expected path "
            f"cannot use it. On 1-D inputs the Matern family has an exact "
            f"O(N) state-space path instead: use backend='temporal' "
            f"(repro_torch.gp.regression(kernel, backend='temporal') / "
            f"repro_torch.gp.TemporalGPRegression)."
        )

    def supports_sde(self) -> bool:
        # the kernel -> SDE duality is a property of stationary 1-D priors
        return self.input_dim == 1

    def to_sde(self, params: Params):
        if self.input_dim != 1:
            raise NotImplementedError(
                f"{type(self).__name__} with input_dim={self.input_dim} has "
                f"no state-space form; the kernel -> LTI SDE duality is 1-D "
                f"(temporal). Use input_dim=1 for backend='temporal'.")
        from repro_torch.temporal import sde as _sde  # lazy: import cycle

        make_sde = getattr(_sde, f"{self.name}_sde")
        return make_sde(self.variance(params), self.lengthscale(params))


@register("matern12")
@dataclasses.dataclass(frozen=True)
class Matern12(_Matern):
    """Matern nu=1/2 (exponential / Ornstein-Uhlenbeck) kernel."""

    def _shape_fn(self, r: torch.Tensor) -> torch.Tensor:
        return torch.exp(-r)


@register("matern32")
@dataclasses.dataclass(frozen=True)
class Matern32(_Matern):
    """Matern nu=3/2 kernel."""

    def _shape_fn(self, r: torch.Tensor) -> torch.Tensor:
        s = math.sqrt(3.0) * r
        return (1.0 + s) * torch.exp(-s)


@register("matern52")
@dataclasses.dataclass(frozen=True)
class Matern52(_Matern):
    """Matern nu=5/2 kernel."""

    def _shape_fn(self, r: torch.Tensor) -> torch.Tensor:
        s = math.sqrt(5.0) * r
        return (1.0 + s + s**2 / 3.0) * torch.exp(-s)


# ---------------------------------------------------------------------------
# cross psi-2 statistics between heterogeneous parts (for Sum)
# ---------------------------------------------------------------------------


def _cross_psi2_rbf_linear(rbf: RBF, p_rbf: Params, lin: Linear,
                           p_lin: Params, mu, S, Z) -> torch.Tensor:
    """C[m, m'] = sum_n <k_rbf(x_n, z_m) k_lin(x_n, z_m')>_{q(x_n)}.

    q(x_n) times k_rbf(x, z_m) is an unnormalized Gaussian with mass
    Psi1[n, m] and mean c[n, m, q] = (mu_nq l_q^2 + z_mq S_nq) /
    (l_q^2 + S_nq), so the term is Psi1[n, m] (a * c[n, m]) . z_m' (GPy's
    RBF x Linear cross term). As in the reference, c is a full (N, M, Q)
    tensor: 8 N M Q bytes in float64.
    """
    l2 = rbf.lengthscale(p_rbf) ** 2  # (Q,)
    a = lin.ard(p_lin)  # (Q,)
    psi1 = ref.psi1_rbf(mu, S, Z, rbf.variance(p_rbf), rbf.lengthscale(p_rbf))
    c = (mu[:, None, :] * l2 + Z[None, :, :] * S[:, None, :]) / (
        l2 + S[:, None, :])
    return torch.einsum("nm,nmq,kq->mk", psi1, c, Z * a)


def _cross_psi2_linear_linear(ka: Linear, pa: Params, kb: Linear, pb: Params,
                              mu, S, Z) -> torch.Tensor:
    """C[m, m'] = (z_m * a1)^T [sum_n (mu_n mu_n^T + diag(S_n))] (z_m' * a2)."""
    moment = mu.T @ mu + torch.diag(S.sum(0))  # (Q, Q)
    return (Z * ka.ard(pa)) @ moment @ (Z * kb.ard(pb)).T


def _cross_psi2(ka: Kernel, pa: Params, kb: Kernel, pb: Params,
                mu, S, Z) -> torch.Tensor:
    """Dispatch the closed-form cross term; transpose handles argument order."""
    if isinstance(ka, RBF) and isinstance(kb, Linear):
        return _cross_psi2_rbf_linear(ka, pa, kb, pb, mu, S, Z)
    if isinstance(ka, Linear) and isinstance(kb, RBF):
        return _cross_psi2_rbf_linear(kb, pb, ka, pa, mu, S, Z).T
    if isinstance(ka, Linear) and isinstance(kb, Linear):
        return _cross_psi2_linear_linear(ka, pa, kb, pb, mu, S, Z)
    raise NotImplementedError(
        f"no closed-form cross psi2 statistics between "
        f"{type(ka).__name__} and {type(kb).__name__} (GPy implements "
        f"RBF x Linear; use the exact path or those part types)"
    )


def _has_cross_psi2(ka: Kernel, kb: Kernel) -> bool:
    """Mirror of `_cross_psi2`'s dispatch table, for capability queries."""
    return (isinstance(ka, RBF) and isinstance(kb, Linear)) or (
        isinstance(ka, Linear) and isinstance(kb, (RBF, Linear)))


# ---------------------------------------------------------------------------
# composite kernels
# ---------------------------------------------------------------------------


class _Composite(Kernel):
    """Shared plumbing: parts act on the same inputs, params nest as k0/k1/..."""

    def __init__(self, *parts: Kernel):
        if len(parts) < 2:
            raise ValueError(f"{type(self).__name__} needs >= 2 parts")
        dims = {p.input_dim for p in parts}
        if len(dims) != 1:
            raise ValueError(f"parts disagree on input_dim: {sorted(dims)}")
        self.parts: Tuple[Kernel, ...] = tuple(parts)
        self.input_dim = parts[0].input_dim

    def init(self, *, device: str | torch.device = _device.DEFAULT_DEVICE,
             dtype: torch.dtype = torch.float32, **kwargs) -> Params:
        """Per-part init kwargs, addressed by slot: ``init(k0={"variance":
        2.0})`` forwards to ``parts[0].init(variance=2.0)``; `device` and
        `dtype` go to every part. Unknown slots raise instead of being
        silently dropped."""
        slots = [f"k{i}" for i in range(len(self.parts))]
        unknown = sorted(set(kwargs) - set(slots))
        if unknown:
            raise TypeError(
                f"{type(self).__name__}.init() takes per-part kwargs keyed by "
                f"slot ({', '.join(slots)}), each a dict of that part's init "
                f"kwargs; got unknown key(s) {unknown}"
            )
        out = {}
        for slot, part in zip(slots, self.parts):
            part_kwargs = kwargs.get(slot, {})
            if not isinstance(part_kwargs, dict):
                raise TypeError(
                    f"{type(self).__name__}.init({slot}=...) must be a dict of "
                    f"{type(part).__name__}.init kwargs, got "
                    f"{type(part_kwargs).__name__}"
                )
            out[slot] = part.init(**{"device": device, "dtype": dtype,
                                     **part_kwargs})
        return out

    def _split(self, params: Params):
        return [(p, params[f"k{i}"]) for i, p in enumerate(self.parts)]

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(map(repr, self.parts))})"


@register("sum")
class Sum(_Composite):
    """k = sum_i k_i. Exact statistics come generically from K; expected
    statistics compose part psi statistics plus pairwise closed-form cross
    terms."""

    def K(self, params: Params, X: torch.Tensor,
          X2: torch.Tensor | None = None) -> torch.Tensor:
        return sum(p.K(pp, X, X2) for p, pp in self._split(params))

    def Kdiag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return sum(p.Kdiag(pp, X) for p, pp in self._split(params))

    def psi0(self, params, mu, S) -> torch.Tensor:
        return sum(p.psi0(pp, mu, S) for p, pp in self._split(params))

    def psi1(self, params, mu, S, Z) -> torch.Tensor:
        return sum(p.psi1(pp, mu, S, Z) for p, pp in self._split(params))

    def psi2(self, params, mu, S, Z) -> torch.Tensor:
        pairs = self._split(params)
        total = sum(p.psi2(pp, mu, S, Z) for p, pp in pairs)
        for i, (pa, ppa) in enumerate(pairs):
            for pb, ppb in pairs[i + 1:]:
                cross = _cross_psi2(pa, ppa, pb, ppb, mu, S, Z)
                total = total + cross + cross.T
        return total

    def supports_psi(self) -> bool:
        # a sum needs every part's psi statistics and every cross term
        return all(p.supports_psi() for p in self.parts) and all(
            _has_cross_psi2(pa, pb)
            for i, pa in enumerate(self.parts) for pb in self.parts[i + 1:])

    def supports_sde(self) -> bool:
        return all(p.supports_sde() for p in self.parts)

    def to_sde(self, params: Params):
        from repro_torch.temporal import sde as _sde  # lazy: import cycle

        return _sde.sum_sde(*[p.to_sde(pp) for p, pp in self._split(params)])


@register("product")
class Product(_Composite):
    """k = prod_i k_i. Exact statistics are generic (K_fu is an elementwise
    product). Expected statistics exist in closed form only when every part
    is an RBF: a product of RBFs is itself an RBF with variance
    prod sigma_i^2 and lengthscales (sum_i l_i^-2)^(-1/2) — delegate to
    that kernel, and with it to the fused and pallas ops on the card.
    """

    def K(self, params: Params, X: torch.Tensor,
          X2: torch.Tensor | None = None) -> torch.Tensor:
        out = None
        for p, pp in self._split(params):
            k = p.K(pp, X, X2)
            out = k if out is None else out * k
        return out

    def Kdiag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        out = None
        for p, pp in self._split(params):
            k = p.Kdiag(pp, X)
            out = k if out is None else out * k
        return out

    def _equivalent_rbf(self, params: Params) -> tuple[RBF, Params]:
        """The RBF equal to this product, with params that are functions of
        the parts' (so gradients flow back to them)."""
        pairs = self._split(params)
        if not all(isinstance(p, RBF) for p, _ in pairs):
            raise NotImplementedError(
                "Product psi statistics exist in closed form only for "
                "all-RBF parts (the product is then itself an RBF); "
                f"got {[type(p).__name__ for p, _ in pairs]}"
            )
        log_var = sum(pp["log_variance"] for _, pp in pairs)
        inv_l2 = sum(torch.exp(-2.0 * pp["log_lengthscale"]) for _, pp in pairs)
        eq_params = {"log_variance": log_var,
                     "log_lengthscale": -0.5 * torch.log(inv_l2)}
        return RBF(self.input_dim), eq_params

    def psi0(self, params, mu, S) -> torch.Tensor:
        k, p = self._equivalent_rbf(params)
        return k.psi0(p, mu, S)

    def psi1(self, params, mu, S, Z) -> torch.Tensor:
        k, p = self._equivalent_rbf(params)
        return k.psi1(p, mu, S, Z)

    def psi2(self, params, mu, S, Z) -> torch.Tensor:
        k, p = self._equivalent_rbf(params)
        return k.psi2(p, mu, S, Z)

    def expected_suff_stats(self, params, mu, S, Y, Z, *,
                            backend: str = "jnp",
                            bwd_backend: str = "auto") -> SuffStats:
        k, p = self._equivalent_rbf(params)
        return k.expected_suff_stats(p, mu, S, Y, Z, backend=backend,
                                     bwd_backend=bwd_backend)

    def supports_psi(self) -> bool:
        # closed form only when the product is itself an RBF
        return all(isinstance(p, RBF) for p in self.parts)

    def supports_sde(self) -> bool:
        return all(p.supports_sde() for p in self.parts)

    def to_sde(self, params: Params):
        from repro_torch.temporal import sde as _sde  # lazy: import cycle

        return _sde.product_sde(
            *[p.to_sde(pp) for p, pp in self._split(params)])


# ---------------------------------------------------------------------------
# registry-level capability query
# ---------------------------------------------------------------------------


def capabilities(kernel: "Kernel | str", input_dim: int = 1) -> Dict[str, bool]:
    """What inference paths a kernel supports, for fail-fast facade
    dispatch. Accepts a kernel instance or a registry name (instantiated
    at `input_dim`: Materns are SDE-capable only in 1-D). Keys: "exact"
    (collapsed bound, deterministic X — always true), "psi" (collapsed
    bound under Gaussian q(X)), "sde" (backend="temporal")."""
    if isinstance(kernel, str):
        kernel = get(kernel)(input_dim)
    return {"exact": True, "psi": kernel.supports_psi(),
            "sde": kernel.supports_sde()}
