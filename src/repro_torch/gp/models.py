"""GPy-style model facades over the collapsed bound (counterpart of
`repro.gp.models`).

    gp = SparseGPRegression(M=32, backend="fused")     # device="cuda"
    gp.fit(X, Y, steps=300)
    mean, var = gp.predict(Xt)

The facades own the wiring: parameter init, the loss, the optimizer loop
and the posterior/prediction epilogue. The math stays where it is —
`core.svgp` for the bound, the kernel objects for the statistics.

`mesh=` selects the paper's data-parallel path (`core.distributed`: each
rank keeps its shard of the data and of q(X), one all-reduce of the
sufficient statistics; the mesh comes from `distributed.make_gp_mesh()`
over an initialized process group); `backend=` routes the statistics
through the fused op ("fused": expected statistics for the GP-LVM, exact
ones for regression via S -> 0; the CUDA kernels on the card), the
single-statistic ops ("pallas": K_fu for regression, psi1 and psi2 for the
GP-LVM) or plain PyTorch ("jnp"); `bwd_backend=` picks the ops' reverse
passes ("auto": the reverse kernels on the card); `chunk=` streams the
plain statistics over N in chunks of that size ("auto": the autotuner's
measured size, `repro_torch.tune.best_chunk`). `device=` is where data and
parameters live: the CUDA device unless ``device="cpu"``; numpy arrays and
tensors given to `fit` and `predict` are moved there in their own dtype.
With `mesh=`, `fit`, `posterior`, `predict` and `export_state` take the
full arrays, as without, and every rank returns the same answers.

Any kernel of `gp.kernels` goes in; each fails as the reference's does: a
Matern in `BayesianGPLVM` (no closed-form psi statistics), a non-RBF
kernel with backend="fused"/"pallas" (an all-RBF `Product` delegates to
the equivalent RBF and runs them). `regression(backend="temporal")` is
`repro_torch.temporal.TemporalGPRegression`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import device as _device
from repro_torch.core import distributed, gplvm, inference, svgp
from repro_torch.gp.kernels import RBF, Kernel, default_rbf
from repro_torch.gp.stats import ExactBatch, suff_stats

Params = Dict[str, torch.Tensor]

_OPTIMIZERS = ("adam", "lbfgs")


def _as_2d(Y: torch.Tensor) -> torch.Tensor:
    return Y[:, None] if Y.ndim == 1 else Y


def _pick_inducing(X: torch.Tensor, M: int) -> torch.Tensor:
    """Every (N // M)-th datapoint — the quickstart's deterministic subset."""
    N = X.shape[0]
    if M >= N:
        return X
    return X[:: max(N // M, 1)][:M]


class _CollapsedGPModel:
    """Shared facade plumbing: kernel/mesh/backend/chunk/device state, the
    optimizer loop and the (possibly distributed) posterior statistics
    pass."""

    def __init__(self, kernel: Optional[Kernel], M: int, *, mesh=None,
                 backend: str = "jnp", chunk: Optional[Union[int, str]] = None,
                 bwd_backend: str = "auto",
                 device: str | torch.device = _device.DEFAULT_DEVICE):
        self.device = _device.resolve(device)
        self.kernel = kernel
        self.M = int(M)
        self.mesh = mesh
        self.backend = backend
        self.bwd_backend = bwd_backend
        if chunk is None or chunk == "auto":
            self.chunk = chunk
        elif isinstance(chunk, str):
            raise ValueError(
                f'chunk must be None, a positive int or "auto", got {chunk!r}')
        else:
            self.chunk = int(chunk)
        self.params: Optional[Params] = None
        self.history: list = []
        self._data: tuple = ()  # this rank's shard with mesh=
        self._n = 0  # datapoints fitted, over every rank
        self._posterior_cache: Optional[svgp.Posterior] = None  # cleared by fit
        self._stats_value_cache = None  # fitted-data SuffStats, cleared by fit

    def _tensor(self, a) -> torch.Tensor:
        """`a` on the model's device, in its own dtype."""
        return torch.as_tensor(a, device=self.device)

    def _knobs(self) -> dict:
        return {"kernel": self.kernel, "backend": self.backend,
                "chunk": self.chunk, "bwd_backend": self.bwd_backend}

    def _place(self, params: Params, *data: torch.Tensor) -> Params:
        """Keep the data to fit; with `mesh=`, this rank's shard of it, and
        the params placed by `distributed.shard_gp_params`."""
        self._n = data[0].shape[0]
        if self.mesh is not None:
            params = distributed.shard_gp_params(params, self.mesh)
            data = tuple(distributed.shard(a, self.mesh) for a in data)
        self._data = data
        return params

    # -- subclass hooks ----------------------------------------------------
    def _loss(self, params: Params, *data) -> torch.Tensor:
        raise NotImplementedError

    def _stats(self, params: Params, *data):
        raise NotImplementedError

    def _require_fitted(self):
        if self.params is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted yet — call .fit() first")

    def _optimize(self, params: Params, data: tuple, *, optimizer: str,
                  steps: int, lr: float, log_every: int) -> Params:
        self._posterior_cache = None
        self._stats_value_cache = None
        if optimizer == "adam":
            params, self.history = inference.fit_adam(
                self._loss, params, data, steps=steps, lr=lr, log_every=log_every)
        elif optimizer == "lbfgs":
            params, final = inference.fit_lbfgs(self._loss, params, data,
                                                maxiter=steps)
            self.history = [final]
        else:
            raise ValueError(f"optimizer must be one of {_OPTIMIZERS}, got {optimizer!r}")
        return params

    def _fitted_stats(self):
        """SuffStats of the fitted data at the fitted params, computed once
        per fit (the O(N M^2) pass) and shared by `posterior()` and
        `export_state()`."""
        self._require_fitted()
        if self._stats_value_cache is None:
            with torch.no_grad():
                self._stats_value_cache = self._stats(self.params, *self._data)
        return self._stats_value_cache

    @torch.no_grad()
    def posterior(self) -> svgp.Posterior:
        """Optimal q(u) implied by the collapsed bound at the fitted params,
        computed once per fit."""
        self._require_fitted()
        if self._posterior_cache is None:
            p = self.params
            beta = torch.exp(p["log_beta"])
            factors = svgp.posterior_factors(self.kernel.K(p["kern"], p["Z"]),
                                             self._fitted_stats(), beta)
            self._posterior_cache = svgp.optimal_qu(factors, beta)
        return self._posterior_cache

    @torch.no_grad()
    def export_state(self):
        """Freeze the fitted model into a `repro_torch.serve.PosteriorState`
        — everything `repro_torch.serve` needs to predict and to absorb new
        data without the training set."""
        from repro_torch.serve.state import build_state

        self._require_fitted()
        return build_state(self.kernel, self.params, self._fitted_stats())

    @torch.no_grad()
    def elbo(self) -> float:
        """Evidence lower bound (total, not per-datapoint) on the training data."""
        self._require_fitted()
        return float(-self._loss(self.params, *self._data) * self._n)

    @torch.no_grad()
    def predict(self, Xt) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean (N*, D) and marginal variance (N*,) of f at Xt."""
        self._require_fitted()
        p = self.params
        Xt = self._tensor(Xt)
        return svgp.predict_f(self.posterior(), self.kernel.K(p["kern"], Xt, p["Z"]),
                              self.kernel.Kdiag(p["kern"], Xt))


class SparseGPRegression(_CollapsedGPModel):
    """Sparse GP regression on the collapsed (Titsias) bound, paper eq. (2)-(3).

    Args:
      kernel: a `repro_torch.gp.kernels.Kernel`; default RBF (input dim
        inferred).
      M: number of inducing points (initialized as a subset of X).
      mesh: optional `DeviceMesh` (`distributed.make_gp_mesh()`): each rank
        keeps its shard of (X, Y) and the statistics merge with one
        all-reduce (the paper's MPI scheme); None = single-process math.
      backend: "jnp" | "pallas" | "fused" statistics path ("pallas" is the
        K_fu kernel with the two products as matrix products; "fused" rides
        the fused statistics kernels with S -> 0; both kernelized in both
        directions).
      chunk: stream the statistics in chunks of this size ("auto": the
        tuner's); None = one shot.
      bwd_backend: "auto" | "pallas" | "jnp" — the ops' reverse passes.
      device: where data and parameters live ("cuda" by default).
    """

    def __init__(self, kernel: Optional[Kernel] = None, M: int = 32, *,
                 mesh=None, backend: str = "jnp",
                 chunk: Optional[Union[int, str]] = None,
                 bwd_backend: str = "auto",
                 device: str | torch.device = _device.DEFAULT_DEVICE):
        super().__init__(kernel, M, mesh=mesh, backend=backend, chunk=chunk,
                         bwd_backend=bwd_backend, device=device)

    def _stats(self, params: Params, X: torch.Tensor, Y: torch.Tensor):
        if self.mesh is not None:
            return distributed.sgpr_stats_dist(self.mesh, **self._knobs())(
                params, X, Y)
        kern = default_rbf(self.kernel, params["Z"].shape[1])
        return suff_stats(kern, params["kern"], ExactBatch(X, Y, params["Z"]),
                          backend=self.backend, chunk=self.chunk,
                          bwd_backend=self.bwd_backend)

    def _loss(self, params: Params, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        kern = default_rbf(self.kernel, params["Z"].shape[1])
        stats = self._stats(params, X, Y)
        Kuu = kern.K(params["kern"], params["Z"])
        terms = svgp.collapsed_bound(Kuu, stats, torch.exp(params["log_beta"]),
                                     Y.shape[1])
        return -terms.bound / stats.n

    def init_params(self, X, Y, *, log_beta: float = 2.0) -> Params:
        X = self._tensor(X)
        if self.kernel is None:
            self.kernel = RBF(X.shape[1])
        return {
            "kern": self.kernel.init(device=self.device),
            "Z": _pick_inducing(X, self.M),
            "log_beta": torch.tensor(log_beta, dtype=X.dtype, device=self.device),
        }

    def fit(self, X, Y, *, optimizer: str = "adam", steps: int = 300,
            lr: float = 3e-2, log_every: int = 0,
            params: Optional[Params] = None) -> "SparseGPRegression":
        X, Y = self._tensor(X), _as_2d(self._tensor(Y))
        if params is None:
            params = self.init_params(X, Y)
        elif self.kernel is None:
            self.kernel = RBF(params["Z"].shape[1])
        params = self._place(params, X, Y)
        self.params = self._optimize(params, self._data, optimizer=optimizer,
                                     steps=steps, lr=lr, log_every=log_every)
        return self


class BayesianGPLVM(_CollapsedGPModel):
    """Bayesian GP-LVM (paper eq. (4)): latent X with factorized Gaussian q(X).

    Args:
      kernel: kernel with closed-form psi statistics; default RBF(Q).
      Q: latent dimensionality.
      M: number of inducing points.
      mesh / backend / chunk / bwd_backend / device: as for
        SparseGPRegression; backend="fused" is the fused statistics op and
        backend="pallas" the psi1 and psi2 ops, each differentiable through
        its hand-derived reverse pass (the reverse kernels on the card).
        With `mesh=` the PCA init runs on the full Y, then each rank keeps
        its shard of Y and q(X).
    """

    def __init__(self, kernel: Optional[Kernel] = None, M: int = 100,
                 Q: Optional[int] = None, *, mesh=None, backend: str = "jnp",
                 chunk: Optional[Union[int, str]] = None,
                 bwd_backend: str = "auto",
                 device: str | torch.device = _device.DEFAULT_DEVICE):
        super().__init__(kernel, M, mesh=mesh, backend=backend, chunk=chunk,
                         bwd_backend=bwd_backend, device=device)
        if kernel is not None and Q is not None and Q != kernel.input_dim:
            raise ValueError(
                f"Q={Q} conflicts with kernel.input_dim={kernel.input_dim}; "
                f"pass one or make them agree"
            )
        self.Q = kernel.input_dim if kernel is not None else (Q if Q is not None else 1)

    def _loss(self, params: Params, Y: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return distributed.gplvm_loss_dist(self.mesh, **self._knobs())(
                params, Y)
        return gplvm.loss(params, Y, **self._knobs())

    def _stats(self, params: Params, Y: torch.Tensor):
        if self.mesh is not None:
            return distributed.gplvm_stats_dist(self.mesh, **self._knobs())(
                params, Y)
        return gplvm.local_stats(params, Y, **self._knobs())

    def init_params(self, Y, *, init_X=None,
                    generator: Optional[torch.Generator] = None) -> Params:
        """`gplvm.init_params` on the model's device; the default generator
        is a CPU `torch.Generator` seeded with 0."""
        if self.kernel is None:
            self.kernel = RBF(self.Q)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return gplvm.init_params(
            generator, _as_2d(self._tensor(Y)), self.Q, self.M,
            init_X=None if init_X is None else self._tensor(init_X),
            kernel=self.kernel)

    def fit(self, Y, *, optimizer: str = "adam", steps: int = 400,
            lr: float = 2e-2, log_every: int = 0, init_X=None,
            generator: Optional[torch.Generator] = None,
            params: Optional[Params] = None) -> "BayesianGPLVM":
        Y = _as_2d(self._tensor(Y))
        if self.kernel is None:
            self.kernel = RBF(self.Q)
        if params is None:
            params = self.init_params(Y, init_X=init_X, generator=generator)
        params = self._place(params, Y)
        self.params = self._optimize(params, self._data, optimizer=optimizer,
                                     steps=steps, lr=lr, log_every=log_every)
        return self

    def latent(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Variational posterior over the latents: (q_mu, q_S); with
        `mesh=`, this rank's shard of them."""
        self._require_fitted()
        return self.params["q_mu"], torch.exp(self.params["q_logS"])


# ---------------------------------------------------------------------------
# backend dispatch
# ---------------------------------------------------------------------------

_BACKENDS = ("collapsed", "temporal")


def regression(kernel: Optional[Kernel] = None, *, backend: str = "collapsed",
               **kwargs):
    """GP regression facade picked by compute backend.

    backend="collapsed" (default) -> `SparseGPRegression`; kwargs = (M,
    mesh, backend, chunk, bwd_backend, device), with the statistics-path
    knob spelled `stats_backend=` here to avoid clashing.

    backend="temporal" -> `repro_torch.temporal.TemporalGPRegression`:
    exact state-space inference for 1-D stationary kernels (the Matern
    family and Sum/Product of it — `kernel.supports_sde()`), O(N) with a
    parallel associative-scan path; kwargs = (parallel, device).

    Fails fast with the chosen backend's capability error (e.g. an RBF
    kernel under backend="temporal").
    """
    if backend == "collapsed":
        if "stats_backend" in kwargs:
            kwargs["backend"] = kwargs.pop("stats_backend")
        return SparseGPRegression(kernel, **kwargs)
    if backend == "temporal":
        from repro_torch.temporal import TemporalGPRegression

        return TemporalGPRegression(kernel, **kwargs)
    raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
