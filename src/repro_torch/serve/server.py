"""`GPServer`: named posterior states behind a low-latency predict front.

Counterpart of `repro.serve.server`, on one device (the CUDA device unless
``device="cpu"``):

* **Bucketed predict.** Every request is padded up to a small set of
  bucket shapes (repeating its last row) and the answer sliced back, so
  the device sees a bounded set of shapes; oversized requests are served in
  largest-bucket slices.
* **Micro-batching.** `submit()` enqueues a request and returns a
  `Future`; one worker thread drains the queue, coalesces compatible
  requests (same model, diag, feature dim, dtype) into one padded device
  call and hands each caller its rows.
* **Admission and deadlines.** `max_pending=` bounds the queue
  (`QueueFullError` in the caller); a request still queued past its
  `timeout=` (or `default_timeout=`) fails with `TimeoutError` on its own
  future. `close()` drains every accepted request and is idempotent.
* **Online learning.** `update()` / `downdate()` swap a model's state
  atomically under its lock, so readers see the old or the new posterior.

* **Refit.** `refit()` re-optimizes a model's noise precision against its
  cached statistics and swaps the refolded state in the same way.

Not ported yet: persistence (`store=`, `save_all`, `load`) and the byte
budget (`budget_bytes=`) — each raises `NotImplementedError` naming the
slice it comes with.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device
from repro_torch.gp.kernels import Kernel
from repro_torch.serve import online
from repro_torch.serve.state import PosteriorState, _predict_closure

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class ServerClosedError(RuntimeError):
    """register()/submit() after close(): the worker is gone; nothing may
    be enqueued. The message contains "closed" for RuntimeError matchers."""


class QueueFullError(RuntimeError):
    """Admission control: the submit queue is at max_pending. Rejected in
    the calling thread — the request never entered the queue."""


class _Entry:
    """A registered model: kernel, state (swapped atomically under `lock`)
    and its predict closures keyed by diag."""

    __slots__ = ("kernel", "state", "lock", "fns")

    def __init__(self, kernel: Kernel, state: PosteriorState):
        self.kernel = kernel
        self.state = state
        self.lock = threading.Lock()
        self.fns = {True: _predict_closure(kernel, True),
                    False: _predict_closure(kernel, False)}


class _Request:
    __slots__ = ("name", "X", "diag", "future", "deadline")

    def __init__(self, name: str, X: torch.Tensor, diag: bool, future: Future,
                 deadline: Optional[float] = None):
        self.name = name
        self.X = X
        self.diag = diag
        self.future = future
        self.deadline = deadline  # time.monotonic() timestamp, or None


class GPServer:
    """Register `PosteriorState`s by name; serve batched low-latency
    predictions; fold new data in online.

    Args:
      buckets: allowed padded batch sizes, ascending and unique.
      use_buckets: `False` disables padding (every request runs at its own
        shape) — for latency comparisons, not production use.
      max_pending: admission bound on submit-queue depth.
      default_timeout: seconds a submitted request may wait in the queue
        before expiring with `TimeoutError` (per-call `timeout=` overrides).
      device: where states must live and requests are moved to; "cuda" by
        default, and raises on a host without a CUDA device.
    """

    def __init__(self, *, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 use_buckets: bool = True, store=None,
                 budget_bytes: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 default_timeout: Optional[float] = None,
                 device: str | torch.device = _device.DEFAULT_DEVICE):
        if store is not None or budget_bytes is not None:
            raise NotImplementedError(
                "store= and budget_bytes= (persistence and the byte-budgeted "
                "LRU) come with a later slice of the port")
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"buckets must be ascending and unique, got {buckets!r}")
        self.buckets = tuple(int(b) for b in buckets)
        self.use_buckets = bool(use_buckets)
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self.default_timeout = default_timeout
        self.device = _device.resolve(device)
        self._models: Dict[str, _Entry] = {}
        self._registry_lock = threading.Lock()
        self._rejected = 0
        self._expired = 0
        # micro-batching queue (worker started lazily on first submit)
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    # ------------------------------------------------------------------ #
    # registry
    # ------------------------------------------------------------------ #

    def register(self, name: str, model=None, *, kernel: Kernel | None = None,
                 state: PosteriorState | None = None) -> None:
        """Register a fitted model under `name`: either a facade exposing
        `export_state()` (`SparseGPRegression`, `BayesianGPLVM`) or an
        explicit (kernel, state) pair. The state's tensors must live on the
        server's device."""
        if model is not None:
            if kernel is not None or state is not None:
                raise ValueError("pass either a fitted model or kernel=+state=, not both")
            kernel, state = model.kernel, model.export_state()
        if kernel is None or state is None:
            raise ValueError("register needs a fitted model or both kernel= and state=")
        if not isinstance(state, PosteriorState):
            raise TypeError(f"state must be a PosteriorState, got {type(state).__name__}")
        if state.Z.device != self.device:
            raise ValueError(f"state lives on {state.Z.device}, the server "
                             f"on {self.device}")
        with self._cv:
            if self._closed:
                raise ServerClosedError(
                    "GPServer is closed: register() after close() would pair "
                    "a model with a dead worker")
        entry = _Entry(kernel, state)
        with self._registry_lock:
            self._models[name] = entry

    def state(self, name: str) -> PosteriorState:
        return self._entry(name).state

    def models(self) -> Tuple[str, ...]:
        with self._registry_lock:
            return tuple(sorted(self._models))

    def _entry(self, name: str) -> _Entry:
        with self._registry_lock:
            entry = self._models.get(name)
        if entry is None:
            # models() re-takes the (non-reentrant) lock: raise outside it
            raise KeyError(f"no model {name!r} registered; have {self.models()}")
        return entry

    def metrics(self) -> Dict[str, int]:
        """Admission counters: registered models, rejections, expiries."""
        with self._registry_lock:
            return {"registered": len(self._models),
                    "rejected": self._rejected, "expired": self._expired}

    # ------------------------------------------------------------------ #
    # bucketed predict
    # ------------------------------------------------------------------ #

    def _bucket(self, B: int) -> int:
        for b in self.buckets:
            if B <= b:
                return b
        return self.buckets[-1]

    def _check_batch(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, device=self.device)
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(
                f"requests must be non-empty (B, Q) batches, got shape {tuple(X.shape)}")
        return X

    def _predict_padded(self, entry: _Entry, X: torch.Tensor, diag: bool):
        """One device call at a bucket shape; returns unpadded (mean, var).
        The state is read once, so the slices of an oversized request all
        use the same posterior even if update() swaps it meanwhile."""
        state = entry.state
        fn = entry.fns[diag]
        X = X.to(state.Z.dtype)
        if not self.use_buckets:
            return fn(state, X)
        return self._call_bucketed(fn, state, X, diag)

    def _call_bucketed(self, fn, state: PosteriorState, X: torch.Tensor,
                       diag: bool):
        B = X.shape[0]
        bucket = self._bucket(B)
        if B == bucket:  # exact bucket shape: no padding
            return fn(state, X)
        if B > bucket:  # oversized: serve in largest-bucket slices
            if not diag:
                raise ValueError(
                    f"diag=False requests must fit one bucket (B={B} > "
                    f"max bucket {bucket}): a full covariance does not "
                    f"concatenate across slices")
            parts = [self._call_bucketed(fn, state, X[i:i + bucket], diag)
                     for i in range(0, B, bucket)]
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts]))
        # pad by repeating the last row: benign values, sliced away after
        X = torch.cat([X, X[-1:].expand(bucket - B, -1)])
        mean, second = fn(state, X)
        if diag:
            return mean[:B], second[:B]
        return mean[:B], second[:B, :B]

    def predict(self, name: str, X, *, diag: bool = True):
        """Synchronous predict through the buckets: mean (B, D) and marginal
        variance (B,) (or the (B, B) covariance with diag=False)."""
        return self._predict_padded(self._entry(name), self._check_batch(X),
                                    diag)

    # ------------------------------------------------------------------ #
    # micro-batching submit
    # ------------------------------------------------------------------ #

    def submit(self, name: str, X, *, diag: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Enqueue a predict; returns a Future of (mean, var). Concurrent
        submissions against the same model coalesce into one device call.
        `timeout` bounds how long the request may wait in the queue."""
        self._entry(name)  # fail fast on unknown names, in the caller
        if timeout is None:
            timeout = self.default_timeout
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        fut: Future = Future()
        req = _Request(name, self._check_batch(X), bool(diag), fut, deadline)
        with self._cv:
            if self._closed:
                raise ServerClosedError("GPServer is closed")
            if self.max_pending is not None and len(self._queue) >= self.max_pending:
                with self._registry_lock:
                    self._rejected += 1
                raise QueueFullError(
                    f"GPServer queue is full ({len(self._queue)} pending >= "
                    f"max_pending={self.max_pending}); retry later or raise "
                    f"max_pending")
            self._queue.append(req)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._serve_loop, name="gpserver-worker", daemon=True)
                self._worker.start()
            self._cv.notify()
        return fut

    def _claim(self, pending: list) -> list:
        """Mark each dequeued request running (skipping ones the caller
        cancelled) and expire those past their deadline on their own
        future only."""
        claimed = []
        now = time.monotonic()
        for r in pending:
            if not r.future.set_running_or_notify_cancel():
                continue  # caller cancelled while queued
            if r.deadline is not None and now > r.deadline:
                r.future.set_exception(TimeoutError(
                    f"request for {r.name!r} expired after waiting past its "
                    f"deadline in the GPServer queue"))
                with self._registry_lock:
                    self._expired += 1
                continue
            claimed.append(r)
        return claimed

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                pending = list(self._queue)
                self._queue.clear()
            # coalesce by (model, diag, feature dim, dtype); diag=False
            # answers are per-request covariance blocks, so those run alone
            groups: Dict[tuple, list] = {}
            for r in self._claim(pending):
                groups.setdefault((r.name, r.diag, r.X.shape[1], r.X.dtype),
                                  []).append(r)
            for (name, diag, *_), reqs in groups.items():
                # a failure fails its own group only; the worker survives
                try:
                    entry = self._entry(name)
                    if not diag or len(reqs) == 1:
                        for r in reqs:
                            r.future.set_result(
                                self._predict_padded(entry, r.X, diag))
                        continue
                    mean, var = self._predict_padded(
                        entry, torch.cat([r.X for r in reqs]), True)
                    off = 0
                    for r in reqs:
                        b = r.X.shape[0]
                        r.future.set_result((mean[off:off + b], var[off:off + b]))
                        off += b
                except Exception as e:  # noqa: BLE001 — delivered to callers
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the queue and stop the worker thread. Idempotent. Every
        request accepted before close() completes; register() and submit()
        afterwards raise ServerClosedError."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join(timeout)
            if not worker.is_alive():
                with self._cv:
                    if self._worker is worker:
                        self._worker = None

    def __enter__(self) -> "GPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # online learning
    # ------------------------------------------------------------------ #

    def _as_data(self, A, state: PosteriorState) -> torch.Tensor:
        return torch.as_tensor(A, device=self.device, dtype=state.Z.dtype)

    def update(self, name: str, X_new, Y_new, *, backend: str = "jnp",
               chunk: Optional[int] = None, bwd_backend: str = "auto") -> None:
        """Fold new observations into the named state (monoid combine +
        O(M^3) refold) and swap it in atomically."""
        entry = self._entry(name)
        with entry.lock:
            state = entry.state
            entry.state = online.update(
                entry.kernel, state, self._as_data(X_new, state),
                self._as_data(Y_new, state), backend=backend, chunk=chunk,
                bwd_backend=bwd_backend)

    def downdate(self, name: str, X_old, Y_old, *, backend: str = "jnp",
                 chunk: Optional[int] = None) -> None:
        """Subtract previously absorbed observations (guarded refold)."""
        entry = self._entry(name)
        with entry.lock:
            state = entry.state
            entry.state = online.downdate(
                entry.kernel, state, self._as_data(X_old, state),
                self._as_data(Y_old, state), backend=backend, chunk=chunk)

    def refit(self, name: str, *, steps: int = 50, lr: float = 5e-2) -> list:
        """Noise-precision touch-up from the cached statistics (see
        `repro_torch.serve.online.refit`); swaps the refolded state in and
        returns the loss history."""
        entry = self._entry(name)
        with entry.lock:
            entry.state, history = online.refit(entry.kernel, entry.state,
                                                steps=steps, lr=lr)
        return history

    def save_all(self):
        raise NotImplementedError(
            "persistence (StateStore, save_all, load) comes with a later "
            "slice of the port")

    @classmethod
    def load(cls, store, **kwargs) -> "GPServer":
        raise NotImplementedError(
            "persistence (StateStore, save_all, load) comes with a later "
            "slice of the port")
