"""Device meshes for the LM launchers (counterpart of `repro.launch.mesh`).

Functions, not module-level constants: importing this module touches no
device. The port has no model sharding yet (that waits for
`parallel/sharding`), so a mesh here only describes the devices a
launcher runs on: `make_host_mesh` the visible ones as (data = 1,
model = n), and
`make_production_mesh` refuses, as the reference does, where the
production mesh's device count is not there.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import device as _device

POD_SHAPE = (16, 16)
N_PODS = 2


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The devices a launcher runs on, named by axis. Only the first device
    runs work until `parallel/sharding` lands."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _devices(device) -> Tuple[torch.device, ...]:
    dev = _device.resolve(device)
    if dev.type == "cuda":  # the named device first, then the others
        others = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                  if i != dev.index]
        return (dev, *others)
    return (dev,)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> HostMesh:
    shape = (N_PODS, *POD_SHAPE) if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    devices = _devices(device)
    if len(devices) < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices, found {len(devices)}; the port "
                           f"shards nothing yet: the production mesh waits for parallel/sharding")
    return HostMesh(shape, axes, devices[:n])


def make_host_mesh(device="cuda") -> HostMesh:
    """Whatever devices exist, as (data = 1, model = n): the CUDA devices by
    default (raising on a host without one), the CPU when asked."""
    devices = _devices(device)
    return HostMesh((1, len(devices)), ("data", "model"), devices)
