"""Gradient compression for cross-pod data parallelism (counterpart of
`repro.optim.compression`).

At 2+ pods the data-parallel all-reduce crosses the slow inter-pod links,
so this is top-k sparsification with error feedback (Stich et al. style):
keep the k largest-magnitude entries per tensor and carry the residual
into the next step. Error feedback loses nothing over the steps: the sum
of what was sent plus the residual is the sum of the raw gradients.

As in the reference, no launcher wires it into the train step (the
reference's `launch/` never calls it).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adam import flatten, tree_map, unflatten

Tree = Any


class CompressionState(NamedTuple):
    residual: Tree  # error-feedback accumulator, same structure as grads


def compression_init(grads_like: Tree) -> CompressionState:
    return CompressionState(tree_map(torch.zeros_like, grads_like))


def _one(g: torch.Tensor, r: torch.Tensor, ratio: float) -> tuple:
    flat = (g.to(torch.float32) + r.to(torch.float32)).reshape(-1)
    k = max(1, int(ratio * flat.numel()))
    thresh = torch.topk(flat.abs(), k).values[-1]  # the k-th largest magnitude
    kept = flat * (flat.abs() >= thresh).to(flat.dtype)
    return kept.reshape(g.shape).to(g.dtype), (flat - kept).reshape(g.shape).to(r.dtype)


def topk_compress_decompress(grads: Tree, state: CompressionState,
                             ratio: float = 0.01) -> tuple:
    """Returns (sparsified-but-dense grads, new residual state).

    The output keeps the dense layout (so it can feed an ordinary
    all-reduce) with about ceil(ratio * n) nonzeros per tensor (more on
    ties at the threshold); a deployment pairs it with a sparse
    collective."""
    pairs = [_one(g, r, ratio)
             for g, r in zip(flatten(grads)[1], flatten(state.residual)[1])]
    return (unflatten(grads, [p[0] for p in pairs]),
            CompressionState(unflatten(state.residual, [p[1] for p in pairs])))
