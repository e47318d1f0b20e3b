"""Data-parallel sparse-GP inference (paper §2) over a `torch.distributed`
process group (counterpart of `repro.core.distributed`).

The paper's MPI scheme:

  * every rank owns a contiguous shard of (Y, q_mu, q_logS) [GP-LVM] or
    (X, Y) [sparse GP regression]: rows [N r // W, N (r + 1) // W) of rank
    r of W, so N need not divide;
  * each rank computes its local `SuffStats` (the only O(N) work);
  * one all-reduce (SUM) combines them: the paper's single Allreduce of
    {phi, Phi, Psi, yy}, with the GP-LVM's KL in the same buffer;
  * the O(M^3) epilogue runs replicated on every rank.

Gradients. Every rank evaluates the same replicated loss
L(g, sum_r s_r(g, l_r)) of the global parameters g and its local ones l_r.
Two autograd functions give every rank the true gradient, as the
shard_map transpose does in the reference:

  * `_AllReduceSum` sums forward and is the identity backward: the
    cotangent of a replicated output is already the true one (summing it
    again, as `torch.distributed.nn.functional.all_reduce` does, makes
    every gradient W times too large);
  * `_SumOverRanks` is the identity forward and sums backward: the globals
    pass through it on their way into the local statistics, so their
    statistics' cotangents are summed over the ranks in one flat all-reduce
    (the paper's Allreduce in reverse).

The globals enter the epilogue directly. So `torch.autograd.grad` of the
loss gives every rank E + sum_r L_r for a global parameter (E the
epilogue's share, L_r rank r's statistics' share), the same bits on every
rank, and the true gradient of its own shard for a local one. No caller
all-reduces gradients, and Adam keeps the globals bitwise equal on every
rank. Only `all_reduce` and `broadcast` are used: gloo's CUDA support
covers those.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.core import gplvm, svgp
from repro_torch.core.psi_stats import SuffStats
from repro_torch.gp.kernels import Kernel, default_rbf
from repro_torch.gp.stats import ExactBatch, suff_stats
from repro_torch.optim.adam import flatten, unflatten

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# declarative parameter-role table (the paper's local/global split)
# ---------------------------------------------------------------------------
# "local"  — per-datapoint parameters, sharded over the data axis;
# "global" — model parameters, replicated (their gradients summed over ranks).
PARAM_ROLES: Dict[str, str] = {
    "kern": "global",
    "Z": "global",
    "log_beta": "global",
    "q_mu": "local",
    "q_logS": "local",
}

SGPR_PARAM_NAMES = ("kern", "Z", "log_beta")
GPLVM_PARAM_NAMES = SGPR_PARAM_NAMES + ("q_mu", "q_logS")


def _data_axes(mesh) -> tuple[str, ...]:
    """All mesh dims used for data parallelism (everything except 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def _group(mesh):
    """The process group of the mesh's one data dim."""
    axes = _data_axes(mesh)
    if len(axes) != 1:
        raise ValueError(f"a mesh with one data dim is expected, got dims "
                         f"{mesh.mesh_dim_names}")
    return mesh.get_group(axes[0])


def make_gp_mesh(n_devices: int | None = None, axis: str = "data", *,
                 device_type: str = "cuda"):
    """1-D `DeviceMesh` over the initialized default process group, its dim
    named `axis`: one rank per device, the same code path for 1 or many.
    The caller initializes the group first
    (`torch.distributed.init_process_group(backend, init_method=...,
    world_size=..., rank=...)` on every rank); `n_devices`, if given, must
    be its world size. `device_type="cpu"` for a CPU (gloo) group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_gp_mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) on every rank first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices} differs from the process "
                         f"group's world size {world}")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def shard(a: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous rows [N r // W, N (r + 1) // W) of `a`."""
    group = _group(mesh)
    r, W = dist.get_rank(group), dist.get_world_size(group)
    N = a.shape[0]
    return a[N * r // W: N * (r + 1) // W]


def shard_gp_params(params: Params, mesh) -> Params:
    """Placement mirroring PARAM_ROLES: each local parameter cut to this
    rank's shard; each global one broadcast from the group's first rank, so
    every rank holds the same values (collective: every rank calls it)."""
    group = _group(mesh)
    src = dist.get_global_rank(group, 0)
    out = {}
    for k, v in params.items():
        if PARAM_ROLES.get(k) == "local":
            out[k] = shard(v, mesh)
            continue
        copies = [t.detach().clone() for t in flatten(v)[1]]
        for t in copies:
            dist.broadcast(t, src=src, group=group)
        out[k] = unflatten(v, copies)
    return out


# ---------------------------------------------------------------------------
# the two collectives, with the gradients of the shard_map transpose
# ---------------------------------------------------------------------------

def _flat(tensors) -> torch.Tensor:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def _unflat(flat: torch.Tensor, like) -> list:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, flat, group):
        out = flat.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverRanks(torch.autograd.Function):
    """Identity forward; every leaf's cotangent summed over the group in one
    flat all-reduce backward."""

    @staticmethod
    def forward(ctx, group, *leaves):
        ctx.group = group
        return tuple(t.clone() for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        flat = _flat(grads)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        return (None, *_unflat(flat, grads))


def _globals_summed_backward(params: Params, group) -> Params:
    """`params` with every global leaf passed through `_SumOverRanks`: what
    the local statistics read."""
    names = [k for k in params if PARAM_ROLES.get(k) == "global"]
    tree = {k: params[k] for k in names}
    leaves = flatten(tree)[1]
    return {**params, **unflatten(tree, _SumOverRanks.apply(group, *leaves))}


def _all_reduce(stats: SuffStats, *extra: torch.Tensor, group):
    """(summed stats, *summed extras): one all-reduce of every leaf."""
    leaves = [*stats, *extra]
    out = _unflat(_AllReduceSum.apply(_flat(leaves), group), leaves)
    return (SuffStats(*out[:len(stats)]), *out[len(stats):])


def _sgpr_stats(params, X_local, Y_local, group, kernel, backend, chunk,
                bwd_backend) -> SuffStats:
    local = _globals_summed_backward(params, group)
    kern = default_rbf(kernel, params["Z"].shape[1])
    stats = suff_stats(kern, local["kern"], ExactBatch(X_local, Y_local, local["Z"]),
                       backend=backend, chunk=chunk, bwd_backend=bwd_backend)
    return _all_reduce(stats, group=group)[0]


def _gplvm_stats(params, Y_local, group, kernel, backend, chunk, bwd_backend):
    """(summed stats, summed KL)."""
    local = _globals_summed_backward(params, group)
    stats = gplvm.local_stats(local, Y_local, kernel=kernel, backend=backend,
                              chunk=chunk, bwd_backend=bwd_backend)
    kl = gplvm.kl_qp(params["q_mu"], params["q_logS"])
    return _all_reduce(stats, kl, group=group)


# ---------------------------------------------------------------------------
# the distributed losses and statistics passes
# ---------------------------------------------------------------------------

def gplvm_loss_dist(mesh, *, kernel: Optional[Kernel] = None,
                    backend: str = "jnp", chunk: Union[int, str, None] = None,
                    bwd_backend: str = "auto"):
    """Distributed GP-LVM negative ELBO per datapoint: loss(params, Y_local)
    with Y and q(X) this rank's shards and the globals replicated; the same
    value on every rank. Differentiable (see the module docstring);
    `chunk=` streams each shard's datapoints."""
    group = _group(mesh)

    def loss(params: Params, Y_local: torch.Tensor) -> torch.Tensor:
        stats, kl = _gplvm_stats(params, Y_local, group, kernel, backend, chunk,
                                 bwd_backend)
        bound = gplvm.bound_from_stats(params, stats, kl, Y_local.shape[1],
                                       kernel=kernel)
        return -bound / stats.n

    return loss


def sgpr_loss_dist(mesh, *, kernel: Optional[Kernel] = None,
                   backend: str = "jnp", chunk: Union[int, str, None] = None,
                   bwd_backend: str = "auto"):
    """Distributed sparse-GP-regression negative bound per datapoint:
    loss(params, X_local, Y_local)."""
    group = _group(mesh)

    def loss(params: Params, X_local: torch.Tensor,
             Y_local: torch.Tensor) -> torch.Tensor:
        stats = _sgpr_stats(params, X_local, Y_local, group, kernel, backend,
                            chunk, bwd_backend)
        kern = default_rbf(kernel, params["Z"].shape[1])
        Kuu = kern.K(params["kern"], params["Z"])
        terms = svgp.collapsed_bound(Kuu, stats, torch.exp(params["log_beta"]),
                                     Y_local.shape[1])
        return -terms.bound / stats.n

    return loss


def sgpr_stats_dist(mesh, *, kernel: Optional[Kernel] = None,
                    backend: str = "jnp", chunk: Union[int, str, None] = None,
                    bwd_backend: str = "auto"):
    """The SGPR's O(N M^2) statistics pass for the posterior and prediction,
    sharded like the loss: stats_fn(params, X_local, Y_local) -> the summed
    `SuffStats`, the same on every rank."""
    group = _group(mesh)

    def stats_fn(params: Params, X_local: torch.Tensor,
                 Y_local: torch.Tensor) -> SuffStats:
        return _sgpr_stats(params, X_local, Y_local, group, kernel, backend,
                           chunk, bwd_backend)

    return stats_fn


def gplvm_stats_dist(mesh, *, kernel: Optional[Kernel] = None,
                     backend: str = "jnp", chunk: Union[int, str, None] = None,
                     bwd_backend: str = "auto"):
    """The GP-LVM's statistics pass for the posterior: stats_fn(params,
    Y_local) -> the summed `SuffStats`."""
    group = _group(mesh)

    def stats_fn(params: Params, Y_local: torch.Tensor) -> SuffStats:
        return _gplvm_stats(params, Y_local, group, kernel, backend, chunk,
                            bwd_backend)[0]

    return stats_fn
