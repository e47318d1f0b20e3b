"""Device meshes for the LM launchers (counterpart of `repro.launch.mesh`).

Functions, not module-level constants: importing this module touches no
device and no process group.

Production target: pods of 256 devices each, mesh (data = 16, model = 16)
per pod; multi-pod adds a leading "pod" axis used for data parallelism.
A mesh is a torch `DeviceMesh` over the current process group, one rank
per device; `parallel.sharding` places tensors on it as DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.parallel import collectives

POD_SHAPE = (16, 16)
N_PODS = 2


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The one-rank mesh of a process with no process group: (data = 1,
    model = 1) on `device_type`. Every spec on it resolves to replicated,
    so nothing placed on it becomes a DTensor (`sharding.is_distributed`
    is false)."""

    device_type: str
    mesh_dim_names: Tuple[str, ...] = ("data", "model")

    @property
    def mesh(self) -> torch.Tensor:
        return torch.zeros((1,) * len(self.mesh_dim_names), dtype=torch.int64)

    @property
    def ndim(self) -> int:
        return len(self.mesh_dim_names)

    def size(self, dim: int | None = None) -> int:
        return 1


def _device_type(device) -> str:
    """The mesh's device type. Over a fake process group (the LM dry run,
    `launch.dryrun`) no device is touched, so a CUDA mesh needs no card."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        return torch.device(device).type
    return _device.resolve(device).type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(data 16, model 16), or (pod 2, data 16, model 16) with `multi_pod`,
    over a process group of exactly that many ranks."""
    shape = (N_PODS, *POD_SHAPE) if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f"mesh {shape} needs {n} devices, one rank each; the process "
                           f"group has {world} rank(s): start {n} processes first")
    from torch.distributed.device_mesh import init_device_mesh

    return _checked(init_device_mesh(_device_type(device), shape, mesh_dim_names=axes))


def make_host_mesh(device="cuda"):
    """Every rank of the current process group as (data = 1, model =
    world); without a process group, the one-rank `LocalMesh` on `device`
    (CUDA by default, which raises on a host without one)."""
    dev_type = _device_type(device)
    if not dist.is_initialized():
        return LocalMesh(dev_type)
    return make_mesh((1, dist.get_world_size()), ("data", "model"), device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device="cuda"):
    """A `DeviceMesh` of `shape` named `axes` over ranks 0 .. prod(shape) - 1
    of the current process group, row-major (rank r at the row-major index
    r, as the reference's meshes order their devices). The group may hold
    more ranks than the mesh; every rank must call this."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, found a process group of {world}")
    return _checked(DeviceMesh(_device_type(device), torch.arange(n).reshape(shape),
                               mesh_dim_names=tuple(axes)))


def _checked(mesh):
    """`mesh`, with DTensor's all-gathers routed through the host where it
    is a CUDA mesh over a gloo group (several ranks sharing one card):
    gloo does not carry the functional all-gather for CUDA tensors
    (`parallel.collectives`)."""
    if mesh.device_type == "cuda" and dist.get_backend() == dist.Backend.GLOO:
        collectives.route_gloo_cuda_all_gather()
    return mesh
