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

Layering: `state` (the cached-posterior tuple + predict epilogue), `online`
(update / downdate on the SuffStats monoid), `server` (named registry,
buckets, micro-batching queue, admission control).
"""
from repro_torch.serve.online import batch_stats, downdate, refit, refold, update
from repro_torch.serve.server import GPServer, QueueFullError, ServerClosedError
from repro_torch.serve.state import PosteriorState, build_state, predict

__all__ = [
    "PosteriorState", "build_state", "predict",
    "update", "downdate", "refit", "refold", "batch_stats",
    "GPServer", "QueueFullError", "ServerClosedError",
]
