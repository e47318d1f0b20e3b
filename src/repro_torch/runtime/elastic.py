"""Elastic scaling: resume any checkpoint on any mesh (counterpart of
`repro.runtime.elastic`).

Checkpoints store full (gathered) tensors; resuming on another topology
is re-placement, not resharding of shard files: build the step on the NEW
mesh, compute its shardings from the same rules table, and restore with
them. `reshard_for_mesh` is the one-call utility; tests/test_torch_elastic.py
restores a checkpoint saved on a (2, 2) mesh onto (4, 2) and back, bit for
bit, and one the reference saved.
"""
from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.parallel import sharding as shd

Tree = Any


def reshard_for_mesh(ckpt_dir: str, abstract_params: Tree, mesh,
                     step: int | None = None) -> tuple[Tree, dict]:
    """Load `ckpt_dir` and place parameters for `mesh` (any device count).
    `abstract_params` gives the structure, shapes and dtypes (meta-device
    tensors will do)."""
    mgr = CheckpointManager(ckpt_dir)
    specs = shd.param_specs(abstract_params, mesh)
    shardings = shd.to_shardings(specs, mesh)
    tree = {"params": abstract_params}
    restored, extra = mgr.restore(tree, step=step, shardings={"params": shardings},
                                  device=mesh.device_type)
    return restored["params"], extra
