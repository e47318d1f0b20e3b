"""SVGP readout head on transformer features (deep-kernel integration;
counterpart of `repro.core.gp_head`).

The backbone produces pooled features h_n in R^Q; a sparse-GP regression
layer with inducing points in feature space gives a calibrated predictive
distribution over a scalar or vector target (reward modelling, value
heads, uncertainty-aware regression). Features are deterministic, so the
exact statistics path applies, through `gp.stats.suff_stats` with its
default backend. The collapsed bound is differentiable w.r.t. the
features, so gradients flow into the transformer.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import svgp
from repro_torch.core.psi_stats import SuffStats
from repro_torch.core.gp_kernels import RBF
from repro_torch.gp.stats import ExactBatch, suff_stats
from repro_torch.models.layers import normal
from repro_torch.parallel import collectives

Params = Dict[str, torch.Tensor]


def init_head(seed: int, feature_dim: int, M: int = 256, D: int = 1, *,
              device="cuda") -> Params:
    """Unit variance, lengthscale sqrt(feature_dim), M inducing points drawn
    standard normal from `seed` on `device`, noise precision 10, all
    float32 (the draw is the port's own, not `jax.random`'s)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "kern": RBF(feature_dim).init(variance=1.0, lengthscale=float(feature_dim) ** 0.5,
                                      device=dev),
        "Z": normal(gen, (M, feature_dim), dev),
        "log_beta": torch.tensor(math.log(10.0), dtype=torch.float32, device=dev),
    }


def _in_float32(x: torch.Tensor, params: Params) -> torch.Tensor:
    """x rounded to float32, as the reference casts features and targets,
    then promoted with the parameters' dtype as its jnp arithmetic does."""
    return x.to(torch.float32).to(torch.promote_types(torch.float32, params["Z"].dtype))


def _as_targets(targets: torch.Tensor, params: Params) -> torch.Tensor:
    t = _in_float32(targets, params)
    return t[:, None] if t.ndim == 1 else t


def head_loss(params: Params, features: torch.Tensor, targets: torch.Tensor,
              *, axis_names: tuple = (), mesh=None) -> torch.Tensor:
    """Negative collapsed bound per datapoint.

    If `axis_names` is non-empty, the features and targets are this rank's
    shard over those axes of `mesh`, and the statistics are summed over
    their process groups (the reference psums them under shard_map). The
    parameters are the same on every rank; each rank's statistics'
    cotangents are summed back over the groups, so every rank's gradient
    is the whole one."""
    feats = _in_float32(features, params)
    tgts = _as_targets(targets, params)
    kern = RBF(params["Z"].shape[1])
    groups = []
    if axis_names:
        if mesh is None:
            raise ValueError("head_loss over mesh axes needs the mesh")
        groups = [mesh.get_group(a) for a in axis_names]
    kp, Z = params["kern"], params["Z"]
    for g in groups:
        names = sorted(kp)
        *vals, Z = collectives.sum_grads([kp[k] for k in names] + [Z], g)
        kp = dict(zip(names, vals))
    stats = suff_stats(kern, kp, ExactBatch(feats, tgts, Z))
    for g in groups:
        stats = SuffStats(*(collectives.all_reduce_sum(x, g) for x in stats))
    Kuu = kern.K(params["kern"], params["Z"])
    terms = svgp.collapsed_bound(Kuu, stats, torch.exp(params["log_beta"]), tgts.shape[1])
    return -terms.bound / stats.n


class HeadPrediction(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


def head_predict(params: Params, train_features: torch.Tensor, train_targets: torch.Tensor,
                 test_features: torch.Tensor) -> HeadPrediction:
    feats = _in_float32(train_features, params)
    tgts = _as_targets(train_targets, params)
    kern = RBF(params["Z"].shape[1])
    stats = suff_stats(kern, params["kern"], ExactBatch(feats, tgts, params["Z"]))
    Kuu = kern.K(params["kern"], params["Z"])
    beta = torch.exp(params["log_beta"])
    terms = svgp.collapsed_bound(Kuu, stats, beta, tgts.shape[1])
    post = svgp.optimal_qu(terms, beta)
    test = _in_float32(test_features, params)
    Ksu = kern.K(params["kern"], test, params["Z"])
    Kss = kern.Kdiag(params["kern"], test)
    mean, var = svgp.predict_f(post, Ksu, Kss)
    return HeadPrediction(mean, var)
