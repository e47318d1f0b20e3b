"""Differentiable collectives over one process group, for the paths that
leave DTensor's propagation and run on local shards, as the reference
drops to `shard_map`: MoE expert parallelism (`models.moe`), flash-decode
(`models.attention`) and the GP head's statistics (`core.gp_head`).

`all_reduce_sum` sums forward and is the identity backward: its output
is replicated over the group, so the cotangent each rank receives is
already the whole one (the reference's psum of an output that shard_map
returns replicated). `all_to_all` sends chunk j of its leading dim to
rank j; its backward is the same exchange of the cotangents.

Gloo and CUDA tensors (one card shared by several ranks, where NCCL
refuses a second rank). With torch 2.11 on an H100 a gloo group
carries all_reduce, broadcast, all_gather, all_gather_into_tensor,
reduce_scatter_tensor and all_to_all_single for CUDA tensors, and the
functional reduce-scatter, all-to-all and all-reduce that DTensor calls;
the functional all-gather (`_functional_collectives.all_gather_tensor`,
which DTensor calls for every Shard -> Replicate) crashes the process.
`route_gloo_cuda_all_gather` puts one helper, `host_all_gather`, in its
place for a gloo group holding CUDA tensors only: a copy to the host, the
all-gather there, a copy back, each use counted in `host_bytes` and
logged. Every other group and tensor goes to torch's own function; NCCL
never takes the helper. `launch.mesh` installs it when it builds a CUDA
mesh over a gloo group, and logs that it did.
"""
from __future__ import annotations

import logging

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# bytes moved through the host by `host_all_gather` (sent + received)
host_bytes = {"all_gather": 0, "calls": 0}
_ORIGINAL = {}


def _process_group(group, tag: str):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(funcol._resolve_group_name(group, tag))


def host_all_gather(t: torch.Tensor, gather_dim: int, pg) -> torch.Tensor:
    """All-gather of `t` along `gather_dim` over a gloo group, through host
    copies (the counterpart of the functional all-gather's result)."""
    n = dist.get_world_size(pg)
    inp = t.detach().contiguous().cpu()
    out = torch.empty((n * inp.shape[0], *inp.shape[1:]), dtype=inp.dtype)
    dist.all_gather_into_tensor(out, inp, group=pg)
    if gather_dim != 0:
        out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
    moved = (inp.numel() + out.numel()) * inp.element_size()
    host_bytes["all_gather"] += moved
    host_bytes["calls"] += 1
    log.debug("[mesh] all_gather through the host (gloo, CUDA): %d bytes", moved)
    return out.to(t.device)


def _routed(name: str):
    original = _ORIGINAL[name]

    def all_gather(self, gather_dim, group, tag=""):
        if self.is_cuda:
            pg = _process_group(group, tag)
            if dist.get_backend(pg) == dist.Backend.GLOO:
                return host_all_gather(self, gather_dim, pg)
        return original(self, gather_dim, group, tag)

    all_gather.__name__ = name
    all_gather.__doc__ = (f"`{name}`, through `host_all_gather` for a gloo group holding "
                          f"CUDA tensors (see `parallel.collectives`).")
    return all_gather


def route_gloo_cuda_all_gather() -> bool:
    """Install `host_all_gather` in front of the functional all-gather
    (under each name this torch has: `all_gather_tensor`, and
    `all_gather_single` where it exists) for gloo groups holding CUDA
    tensors. Idempotent; returns True the first time."""
    import torch.distributed._functional_collectives as funcol

    if _ORIGINAL:
        return False
    for name in ("all_gather_tensor", "all_gather_single"):
        if hasattr(funcol, name):
            _ORIGINAL[name] = getattr(funcol, name)
    for name in list(_ORIGINAL):
        setattr(funcol, name, _routed(name))
    log.info("[mesh] gloo group with CUDA tensors: DTensor's all-gathers go through "
             "the host (parallel.collectives.host_all_gather)")
    return True


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`; the identity backward."""
    return _AllReduceSum.apply(t, group)


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """t: (n, ...) with n the group's size. Chunk j of the leading dim goes
    to rank j; chunk j of the result came from rank j (the reference's
    `lax.all_to_all(t, axis, 0, 0, tiled=False)`)."""
    if t.shape[0] != dist.get_world_size(group):
        raise ValueError(f"leading dim {t.shape[0]} != group size {dist.get_world_size(group)}")
    if not t.dtype.is_floating_point:
        return _exchange(t, group)
    return _AllToAll.apply(t, group)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.clone() for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.contiguous().clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
            out.append(g)
        return (None, *out)


def sum_grads(ts, group) -> tuple:
    """The identity forward; each cotangent summed over `group` backward.
    A replicated input passes through it on its way into a rank's local
    share of a sum, so every rank's gradient is the whole one."""
    return _SumGrads.apply(group, *ts)
