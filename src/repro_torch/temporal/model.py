"""`TemporalGPRegression`: the state-space GP facade, plus the O(d^2)
`TemporalState` the serving tier ships (counterpart of
`repro.temporal.model`).

The facade matches `SparseGPRegression`'s surface (fit / elbo / predict /
posterior / export_state) over the kernel -> SDE -> Kalman path of
`sde` and `pskf`: O(N d^3) work, O(N d^2) memory, exact inference
(elbo() == lml()), and `parallel=` picks the associative scans or the
sequential twin. `device=` is where data and parameters live: the CUDA
device unless ``device="cpu"``.

Serving: `export_state()` freezes the terminal filtered state (kernel
hyperparameters, noise, last timestamp, m (d, D), P (d, d)). `forecast()`
predicts the latent marginal at future timestamps in O(d^3) a row (rows
are independent, so `GPServer`'s padding and coalescing apply), and
`update_state()` folds new observations in by filtering forward from the
stored state with the sequential filter: the streamed state is the one a
sequential filter over the concatenated series reaches. Timestamps before
the forecast origin get the origin's nowcast (dt clamped to 0).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import inference
from repro_torch.gp.kernels import Kernel, Matern32
from repro_torch.temporal import pskf, sde

Params = Dict[str, torch.Tensor]

_OPTIMIZERS = ("adam", "lbfgs")


def _as_tensor(a, device) -> torch.Tensor:
    """`a` on `device` in its own dtype (a numpy view with negative
    strides, such as a reversed series, is copied first)."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, device=device)


def _as_2d(Y: torch.Tensor) -> torch.Tensor:
    return Y[:, None] if Y.ndim == 1 else Y


def _as_times(X: torch.Tensor) -> torch.Tensor:
    """Accept (N,) timestamps or the facade-standard (N, 1) column."""
    if X.ndim == 2 and X.shape[1] == 1:
        return X[:, 0]
    if X.ndim == 1:
        return X
    raise ValueError(
        f"temporal models take 1-D inputs: X must be (N,) or (N, 1) "
        f"timestamps, got shape {tuple(X.shape)}")


def _validate_times(t: torch.Tensor, *, what: str = "X") -> None:
    """Sort-order and duplicate validation on the host (fit/update time)."""
    tn = t.detach().cpu().numpy()
    if tn.size < 1:
        raise ValueError(f"{what} must contain at least one timestamp")
    d = np.diff(tn)
    if np.any(d < 0):
        i = int(np.argmax(d < 0))
        raise ValueError(
            f"{what} timestamps must be sorted ascending; {what}[{i + 1}] = "
            f"{tn[i + 1]!r} < {what}[{i}] = {tn[i]!r} (sort the series — the "
            f"Kalman recursion runs in time order)")
    if np.any(d == 0):
        i = int(np.argmax(d == 0))
        raise ValueError(
            f"duplicate timestamp in {what}: {what}[{i}] == {what}[{i + 1}] "
            f"== {tn[i]!r}; aggregate duplicate observations (e.g. average "
            f"them) before fitting — a zero gap makes the transition "
            f"degenerate (Q_k = 0)")


def _gaps(t: torch.Tensor, t0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaps before each timestamp: from `t0` for the first (0 without)."""
    first = torch.zeros_like(t[:1]) if t0 is None else t[:1] - t0
    return torch.cat([first, torch.diff(t)])


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class TemporalState(NamedTuple):
    """Everything a fitted temporal GP needs to forecast and to keep
    learning online: O(d^2) however many points were absorbed. The kernel
    object stays outside, as for `serve.state.PosteriorState`."""

    kern: Params  # kernel hyperparameters (log-transformed)
    log_beta: torch.Tensor  # scalar log noise precision
    t_last: torch.Tensor  # scalar: the forecast origin (last absorbed time)
    m: torch.Tensor  # (d, D) terminal filtered state mean, one column per output
    P: torch.Tensor  # (d, d) terminal filtered state covariance
    n: torch.Tensor  # scalar: datapoints absorbed so far

    @property
    def d(self) -> int:
        return self.P.shape[-1]

    @property
    def D(self) -> int:
        return self.m.shape[-1]

    @property
    def nbytes(self) -> int:
        """Resident bytes of every tensor in the state; constant per
        registration (the state never grows with the data absorbed)."""
        return _tree_nbytes(tuple(self))


def _require_sde(kernel: Kernel) -> None:
    if not kernel.supports_sde():
        raise ValueError(
            f"kernel {kernel!r} has no state-space (SDE) form: temporal "
            f"models need kernel.supports_sde() — matern12/matern32/"
            f"matern52 on input_dim=1, or Sum/Product of those. For other "
            f"kernels use SparseGPRegression (the collapsed bound).")


def forecast_closure(kernel: Kernel):
    """The marginal forecast epilogue closed over a kernel — the temporal
    analogue of `serve.state._predict_closure`. Each row of Xt is an
    independent forecast from the stored terminal state (mean = H A(dt) m,
    var = H (A P A^T + Q) H^T); dt clamps at 0."""

    def fn(state: TemporalState, Xt: torch.Tensor):
        model = kernel.to_sde(state.kern)
        dt = (Xt[:, 0] - state.t_last).clamp_min(0.0)
        A, Q = sde.discretize(model, dt)
        H = model.H.to(A.dtype)
        mean = H @ (A @ state.m.to(A.dtype))
        P = A @ state.P.to(A.dtype) @ A.mT + Q
        return mean, (P @ H) @ H

    return fn


@torch.no_grad()
def forecast(kernel: Kernel, state: TemporalState,
             Xt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent marginal forecast at Xt (B, 1) timestamps: mean (B, D) and
    variance (B,). O(B d^3)."""
    return forecast_closure(kernel)(state, _as_tensor(Xt, state.m.device))


@torch.no_grad()
def update_state(kernel: Kernel, state: TemporalState, X_new,
                 Y_new) -> TemporalState:
    """Fold new observations into a served state by filtering forward from
    the stored terminal (m, P) with the sequential filter: O(B d^3), no
    access to past data, and the result is the state a sequential filter
    over the concatenated series reaches. New timestamps must be sorted and
    strictly after `state.t_last`."""
    dev = state.m.device
    t_new = _as_times(_as_tensor(X_new, dev))
    _validate_times(t_new, what="X_new")
    t0, t_last = float(t_new[0]), float(state.t_last)
    if t0 <= t_last:
        raise ValueError(
            f"X_new must start strictly after the state's forecast origin "
            f"t_last = {t_last!r}, got first new timestamp {t0!r}; a "
            f"temporal state only filters FORWARD (re-fit to revise the past)")
    Y_new = _as_2d(_as_tensor(Y_new, dev))
    if Y_new.shape[1] != state.D:
        raise ValueError(
            f"Y_new has {Y_new.shape[1]} output column(s), state carries "
            f"D={state.D}")
    model = kernel.to_sde(state.kern)
    A, Q = sde.discretize(model, _gaps(t_new, state.t_last))
    res = pskf.kalman_filter(A, Q, model.H, torch.exp(-state.log_beta), Y_new,
                             state.m, state.P, parallel=False)
    return TemporalState(kern=state.kern, log_beta=state.log_beta,
                         t_last=t_new[-1], m=res.means[-1], P=res.covs[-1],
                         n=state.n + t_new.shape[0])


class TemporalGPRegression:
    """Exact GP regression on 1-D (temporal) inputs via the state-space
    path: kernel -> LTI SDE -> Kalman filter/smoother, O(N) in the number
    of datapoints with no (N, N) or (N, M) intermediate.

    Args:
      kernel: a kernel with `supports_sde()` (matern12/32/52 on 1-D input,
        or Sum/Product of those); default Matern32(1).
      parallel: True (default) runs filter and smoother as associative
        scans (O(log N) depth); False the sequential twin (O(N) depth).
      device: where data and parameters live ("cuda" by default).
    """

    def __init__(self, kernel: Optional[Kernel] = None, *,
                 parallel: bool = True,
                 device: str | torch.device = _device.DEFAULT_DEVICE):
        self.device = _device.resolve(device)
        self.kernel = kernel if kernel is not None else Matern32(1)
        _require_sde(self.kernel)
        self.parallel = bool(parallel)
        self.params: Optional[Params] = None
        self.history: list = []
        self._data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def _tensor(self, a) -> torch.Tensor:
        return _as_tensor(a, self.device)

    def _filter(self, params: Params, t, Y, *, mask=None,
                parallel: Optional[bool] = None):
        """The discretized model and the filter over (t, Y) from the
        stationary prior."""
        model = self.kernel.to_sde(params["kern"])
        A, Q = sde.discretize(model, _gaps(t))
        m0 = torch.zeros(model.d, Y.shape[1], dtype=A.dtype, device=A.device)
        res = pskf.kalman_filter(
            A, Q, model.H, torch.exp(-params["log_beta"]), Y, m0, model.Pinf,
            mask=mask, parallel=self.parallel if parallel is None else parallel)
        return model, A, Q, res

    def _loss(self, params: Params, t, Y) -> torch.Tensor:
        return -self._filter(params, t, Y)[3].lml / t.shape[0]

    @torch.no_grad()
    def _smooth(self, params: Params, t_all, Y_all, mask, parallel: bool):
        """Smoothed latent marginals over a merged (train + query) timeline;
        masked steps carry no observation."""
        model, A, Q, res = self._filter(params, t_all, Y_all, mask=mask,
                                        parallel=parallel)
        ms, Ps = pskf.rts_smoother(A, Q, res.means, res.covs,
                                   parallel=parallel)
        H = model.H.to(A.dtype)
        return H @ ms, (Ps @ H) @ H

    def init_params(self, X, Y=None, *, log_beta: float = 2.0) -> Params:
        t = _as_times(self._tensor(X))
        return {"kern": self.kernel.init(device=self.device),
                "log_beta": torch.tensor(log_beta, dtype=t.dtype,
                                         device=self.device)}

    def _require_fitted(self):
        if self.params is None:
            raise RuntimeError(
                f"{type(self).__name__} is not fitted yet — call .fit() first")

    def fit(self, X, Y, *, optimizer: str = "adam", steps: int = 300,
            lr: float = 3e-2, log_every: int = 0,
            params: Optional[Params] = None) -> "TemporalGPRegression":
        """Maximize the exact log marginal likelihood over the kernel
        hyperparameters and the noise with the shared optimizer loops
        (`core.inference.fit_adam` / `fit_lbfgs`). X must be sorted,
        duplicate-free timestamps ((N,) or (N, 1)); Y is (N,) or (N, D)."""
        t = _as_times(self._tensor(X))
        _validate_times(t)
        Y = _as_2d(self._tensor(Y))
        if Y.shape[0] != t.shape[0]:
            raise ValueError(f"X has {t.shape[0]} rows, Y has {Y.shape[0]}")
        if params is None:
            params = self.init_params(t)
        self._data = (t, Y)
        if optimizer == "adam":
            self.params, self.history = inference.fit_adam(
                self._loss, params, (t, Y), steps=steps, lr=lr,
                log_every=log_every)
        elif optimizer == "lbfgs":
            self.params, final = inference.fit_lbfgs(self._loss, params,
                                                     (t, Y), maxiter=steps)
            self.history = [final]
        else:
            raise ValueError(
                f"optimizer must be one of {_OPTIMIZERS}, got {optimizer!r}")
        return self

    @torch.no_grad()
    def lml(self) -> float:
        """Exact log marginal likelihood (total) on the training data."""
        self._require_fitted()
        t, Y = self._data
        return float(-self._loss(self.params, t, Y) * t.shape[0])

    def elbo(self) -> float:
        """Surface parity with SparseGPRegression; the state-space
        likelihood is exact, so elbo() == lml()."""
        return self.lml()

    def predict(self, Xt, *, parallel: Optional[bool] = None):
        """Exact posterior latent marginals at Xt: mean (B, D), var (B,).

        Query timestamps may come in any order and may coincide with
        training timestamps: they join the training timeline as masked
        (observation-free) steps, which are filtered, smoothed and mapped
        back, so interpolation and extrapolation are both exact."""
        self._require_fitted()
        parallel = self.parallel if parallel is None else bool(parallel)
        t_test = _as_times(self._tensor(Xt)).to(self._data[0].dtype)
        t, Y = self._data
        # merge: a stable argsort keeps training entries ahead of coincident
        # queries, so a query at a training time smooths (a dt = 0 step)
        t_all = torch.cat([t, t_test])
        order = torch.argsort(t_all, stable=True)
        mask = torch.cat([torch.ones_like(t, dtype=torch.bool),
                          torch.zeros_like(t_test, dtype=torch.bool)])[order]
        Y_all = torch.cat([Y, Y.new_zeros(t_test.shape[0], Y.shape[1])])[order]
        mean_all, var_all = self._smooth(self.params, t_all[order], Y_all,
                                         mask, parallel)
        # scatter back: positions of the query rows in the merged timeline
        inv = torch.argsort(order, stable=True)[t.shape[0]:]
        return mean_all[inv], var_all[inv]

    def posterior(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Smoothed latent marginals at the training timestamps:
        (mean (N, D), var (N,)) — the exact posterior."""
        self._require_fitted()
        t, Y = self._data
        return self._smooth(self.params, t, Y,
                            torch.ones_like(t, dtype=torch.bool), self.parallel)

    @torch.no_grad()
    def export_state(self) -> TemporalState:
        """Freeze the fitted model into the O(d^2) `TemporalState` the
        serving tier ships: terminal filtered moments + hyperparameters."""
        self._require_fitted()
        t, Y = self._data
        res = self._filter(self.params, t, Y)[3]
        return TemporalState(kern=self.params["kern"],
                             log_beta=self.params["log_beta"], t_last=t[-1],
                             m=res.means[-1], P=res.covs[-1],
                             n=t.new_full((), float(t.shape[0])))
