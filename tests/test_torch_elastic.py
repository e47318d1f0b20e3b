"""Elastic restore (`repro_torch.runtime.elastic.reshard_for_mesh`) and
`TrainLoop(shardings=)` across meshes, on eight spawned gloo ranks (CPU),
one world joined with a timeout of its own; the (2, 2) mesh is ranks 0-3,
the (4, 2) mesh all eight.

* A checkpoint the reference saves from a (2, 2) mesh of four host
  devices (a subprocess, as tests/test_checkpoint.py's elastic test runs
  it) restores through the port's `reshard_for_mesh` on (4, 2), bit for
  bit; saved from there by the port, it restores on (2, 2) bit for bit.
* The port's own round trip: saved from (2, 2), restored on (4, 2), bit
  for bit.
* A `TrainLoop` of two steps on (2, 2) checkpoints; a fresh loop on (4, 2)
  resumes from it with the parameters, Adam's state and the data
  position bitwise as saved, and its steps 3-4 match a single-process
  loop's at the float32 tolerance (1e-5 relative: the reductions
  regroup).
"""
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models import model_zoo
from repro_torch.optim import adam_init
from repro_torch.optim.adam import flatten
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import LoopConfig, TrainLoop, reshard_for_mesh

WORLD = 8
JOIN_TIMEOUT_S = 240
LOSS_TOL = 1e-5
TRAIN = (4, 32)  # batch, sequence

_REF_SAVE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import jax, numpy as np
from repro import compat
from repro.checkpoint.manager import CheckpointManager
from repro.configs.base import get_smoke_config
from repro.models.model_zoo import build
from repro.parallel import sharding as shd

params = build(get_smoke_config("smollm-360m")).init(jax.random.PRNGKey(7))
mesh = compat.make_mesh((2, 2), ("data", "model"))
sharded = jax.device_put(params, shd.to_shardings(shd.param_specs(params, mesh), mesh))
CheckpointManager({ckpt!r}).save(11, {{"params": sharded}}, extra={{"step": 11}})
flat = jax.tree_util.tree_flatten_with_path(params)[0]
np.savez({npz!r}, **{{shd._path_str(p): np.asarray(x) for p, x in flat}})
print("SAVED")
"""


def _equal(tree, want: dict) -> bool:
    return all(torch.equal(shd.full(t), want[p]) for p, t in shd.leaves_with_path(tree))


def _loop(cfg, mesh, ckpt: str):
    """A two-step-per-run TrainLoop on `mesh` from the seed, its state placed
    by the train step's shardings."""
    B, S = TRAIN
    cell = ShapeCell("elastic", S, B, "train")
    bundle = steps.make_train_step(cfg, cell, mesh, batch=B)
    params = shd.place(model_zoo.build(cfg).init(0, device="cpu"), bundle.in_shardings[0])
    opt = shd.place(adam_init(params, steps.default_adam(cfg)), bundle.in_shardings[1])
    data = TokenStream(cfg, cell, batch=B, device="cpu", shardings=bundle.in_shardings[2])
    return TrainLoop(bundle.jitted(), params, opt, data,
                     LoopConfig(ckpt_dir=ckpt, ckpt_every=0, log_every=0, async_save=False),
                     shardings=bundle.in_shardings[:2])


def _rank(rank, store, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD,
                            rank=rank)
    tmp = Path(tmp)
    try:
        res = {}
        mesh22 = lmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        mesh42 = lmesh.make_mesh((4, 2), ("data", "model"), "cpu")
        cfg = get_smoke_config("smollm-360m")
        abstract = model_zoo.build(cfg).init(device="meta")

        # the reference's checkpoint: (2, 2) -> (4, 2) -> saved -> (2, 2)
        ref = {k: torch.as_tensor(v) for k, v in np.load(tmp / "ref.npz").items()}
        on42, extra = reshard_for_mesh(str(tmp / "ref_ckpt"), abstract, mesh42)
        res["ref_42"] = (_equal(on42, ref), extra, str(flatten(on42)[1][0].placements))
        CheckpointManager(tmp / "from42").save(12, {"params": on42}, extra={"step": 12})
        dist.barrier()
        if rank < 4:
            on22, extra = reshard_for_mesh(str(tmp / "from42"), abstract, mesh22)
            res["ref_22"] = (_equal(on22, ref), extra)

        # the port's own: (2, 2) -> (4, 2)
        params = model_zoo.build(cfg).init(3, device="cpu")
        want = {p: t for p, t in shd.leaves_with_path(params)}
        if rank < 4:
            placed = shd.place(params, shd.to_shardings(shd.param_specs(params, mesh22), mesh22))
            CheckpointManager(tmp / "own").save(1, {"params": placed}, extra={"step": 1})
        dist.barrier()
        on42, _ = reshard_for_mesh(str(tmp / "own"), abstract, mesh42)
        res["own_42"] = _equal(on42, want)

        # TrainLoop: two steps on (2, 2), resumed on (4, 2) for steps 3-4
        if rank < 4:
            loop = _loop(cfg, mesh22, str(tmp / "loop"))
            res["first"] = loop.run(2)
            saved = (shd.gather(loop.params), shd.gather(loop.opt_state),
                     loop.data.checkpoint_state())
        dist.barrier()
        loop = _loop(cfg, mesh42, str(tmp / "loop"))
        assert loop.try_resume()
        resumed = (shd.gather(loop.params), shd.gather(loop.opt_state),
                   loop.data.checkpoint_state(), loop.step)
        if rank < 4:
            res["resume_equal"] = (
                all(torch.equal(a, b) for a, b in zip(flatten(resumed[0])[1],
                                                      flatten(saved[0])[1]))
                and all(torch.equal(a, b) for a, b in zip(flatten(resumed[1])[1],
                                                          flatten(saved[1])[1]))
                and resumed[2] == saved[2])
        res["resumed_step"] = resumed[3]
        res["placement42"] = str(flatten(loop.params)[1][0].placements)
        res["later"] = loop.run(4)
        torch.save(res, tmp / f"r{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import repro

    tmp = tmp_path_factory.mktemp("elastic")
    src = str(Path(repro.__file__).resolve().parents[1])
    script = _REF_SAVE.format(src=src, ckpt=str(tmp / "ref_ckpt"), npz=str(tmp / "ref.npz"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": src})
    assert "SAVED" in out.stdout, out.stdout + out.stderr[-3000:]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "store"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} ranks still running after {JOIN_TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(tmp / f"r{r}.pt") for r in range(WORLD)]


def test_reference_checkpoint_restores_bitwise_on_4x2_and_back(runs):
    for r in runs:
        ok, extra, placement = r["ref_42"]
        assert ok and extra == {"step": 11}
        assert placement != "(Replicate(), Replicate())"  # embed/table: placed, not whole
    for r in runs[:4]:
        ok, extra = r["ref_22"]
        assert ok and extra == {"step": 12}


def test_own_checkpoint_restores_bitwise_across_meshes(runs):
    assert all(r["own_42"] for r in runs)


def test_train_loop_resumes_on_another_mesh(runs):
    """Parameters, Adam's moments and the data position bitwise as saved;
    steps 3-4 held to one process's uninterrupted loop."""
    assert all(r["resume_equal"] for r in runs[:4])
    assert all(r["resumed_step"] == 2 for r in runs)
    assert all(r["placement42"] == runs[0]["placement42"] for r in runs)
    single = _single_loop(get_smoke_config("smollm-360m"))
    for r in runs:
        for k in ("loss", "ce"):
            got, want = r["later"][k], single[k]
            assert abs(got - want) <= LOSS_TOL * abs(want), (k, got, want)


def _single_loop(cfg):
    import tempfile

    B, S = TRAIN
    cell = ShapeCell("elastic", S, B, "train")
    mesh = lmesh.make_host_mesh("cpu")
    bundle = steps.make_train_step(cfg, cell, mesh, batch=B)
    params = model_zoo.build(cfg).init(0, device="cpu")
    opt = adam_init(params, steps.default_adam(cfg))
    with tempfile.TemporaryDirectory() as d:
        loop = TrainLoop(bundle.jitted(), params, opt,
                         TokenStream(cfg, cell, batch=B, device="cpu"),
                         LoopConfig(ckpt_dir=d, ckpt_every=0, log_every=0, async_save=False))
        return loop.run(4)
