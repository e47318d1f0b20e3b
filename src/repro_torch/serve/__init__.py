"""Online prediction: cached posterior state, incremental sufficient-
statistics updates, batched low-latency serving (counterpart of
`repro.serve`).

    kernel = get("rbf")(Q)
    stats = suff_stats(kernel, params["kern"], ExactBatch(X, Y, params["Z"]),
                       backend="fused")            # the CUDA kernel on the card
    server = GPServer()                            # device="cuda"
    server.register("demand", kernel=kernel, state=build_state(kernel, params, stats))
    mean, var = server.predict("demand", Xt)       # bucket-padded
    server.update("demand", X_new, Y_new, backend="fused")

    server = GPServer(store=StateStore("states/"), budget_bytes=1 << 30)
    server.save_all()                              # durable: survives restarts
    server = GPServer.load("states/")              # restart: bit-identical serving

Layering: `state` (the cached-posterior tuple + predict epilogue), `online`
(update / downdate on the SuffStats monoid), `persist` (the durable named
store over `repro_torch.checkpoint` + kernel specs, in the reference's
on-disk format), `server` (named registry, buckets, micro-batching queue,
byte-budgeted LRU residency, admission control).

Temporal models serve through the same tier: register a fitted
`TemporalGPRegression` (its `TemporalState` is the O(d^2) analogue of
`PosteriorState`); `predict` forecasts marginals at new timestamps and
`update` filters new observations forward.
"""
from repro_torch.checkpoint.manager import CheckpointCorruptError
from repro_torch.serve.online import batch_stats, downdate, refit, refold, update
from repro_torch.serve.persist import (PERSIST_SCHEMA, StateStore,
                                       kernel_from_spec, kernel_spec,
                                       state_kind)
from repro_torch.serve.server import GPServer, QueueFullError, ServerClosedError
from repro_torch.serve.state import PosteriorState, build_state, predict
from repro_torch.temporal.model import TemporalState

__all__ = [
    "PosteriorState", "TemporalState", "build_state", "predict",
    "update", "downdate", "refit", "refold", "batch_stats",
    "GPServer", "QueueFullError", "ServerClosedError",
    "StateStore", "PERSIST_SCHEMA", "kernel_spec", "kernel_from_spec",
    "state_kind", "CheckpointCorruptError",
]
