"""MoE expert parallelism on a (data 2, model 4) mesh of eight spawned gloo
ranks (CPU), against `moe_apply_dense` on one process, as
tests/test_moe.py::test_ep_shard_map_matches_dense_subprocess holds the
reference's: the arctic smoke config at capacity factor 8 (no pair
dropped), float32, the value of sum(y^2) within 1e-2 relative and each
gradient leaf's max error within 1e-3 of its max (the router's and the
input's too, which the reference's test leaves out).

Both paths run at both batch sizes: `moe_apply_ep` (one all-reduce over
the model axis) and `moe_apply_ep_a2a` (an all-to-all there and back);
`moe_apply` dispatches by the reference's rule, the all-reduce path for
(4, 16) tokens (16 a model rank) and the all-to-all path for (4, 128)
(64 a model rank).
"""
import dataclasses
import multiprocessing
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as lmesh
from repro_torch.models import moe
from repro_torch.parallel import sharding as shd

WORLD = 8
SHAPE = (2, 4)
SIZES = {"small": (4, 16), "large": (4, 128)}
ROUTE = {"small": "moe_apply_ep", "large": "moe_apply_ep_a2a"}
LOSS_TOL, LEAF_TOL = 1e-2, 1e-3
JOIN_TIMEOUT_S = 180


def _cfg():
    return dataclasses.replace(get_smoke_config("arctic-480b"), capacity_factor=8.0)


def _inputs(cfg):
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, cfg, "cpu")
    xs = {k: torch.randn((B, S, cfg.d_model), generator=gen) for k, (B, S) in SIZES.items()}
    return params, xs


def _value_and_grads(fn, params, x):
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    xg = x.detach().requires_grad_(True)
    y = fn(leaves, xg).y
    loss = torch.sum(y ** 2)
    grads = torch.autograd.grad(loss, [xg, *leaves.values()])
    return loss, dict(zip(["x", *leaves], grads))


def _rank(rank, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD,
                            rank=rank)
    try:
        cfg = _cfg()
        mesh = lmesh.make_mesh(SHAPE, ("data", "model"), "cpu")
        constrain = shd.make_constrain(mesh)
        params, xs = _inputs(cfg)
        specs = shd.to_shardings(shd.param_specs({"moe": params}, mesh), mesh)["moe"]
        placed = shd.place(params, specs)
        res = {"placements": {n: str(t.placements) for n, t in placed.items()}}
        routes = []
        paths = {"moe_apply_ep": moe.moe_apply_ep, "moe_apply_ep_a2a": moe.moe_apply_ep_a2a}
        for name, fn in paths.items():  # note which path moe_apply takes
            setattr(moe, name, lambda *a, _n=name, _f=fn, **k: (routes.append(_n), _f(*a, **k))[1])
        try:
            with shd.mesh_context(mesh):
                for k, x in xs.items():
                    xd = shd.replicate(x, mesh)
                    for name, fn in [("dispatch", moe.moe_apply), *paths.items()]:
                        del routes[:]
                        loss, grads = _value_and_grads(
                            lambda p, xx, _fn=fn: _fn(p, xx, cfg, constrain), placed, xd)
                        res[k, name] = {"loss": float(shd.full(loss)), "routes": list(routes),
                                        "grads": {n: shd.full(g) for n, g in grads.items()}}
        finally:
            for name, fn in paths.items():
                setattr(moe, name, fn)
        if rank == 0:
            torch.save(res, out / "moe_ep.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(out / "store"), out)) for r in range(WORLD)]
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
    return torch.load(out / "moe_ep.pt")


def _dense(k):
    cfg = _cfg()
    params, xs = _inputs(cfg)
    return _value_and_grads(lambda p, x: moe.moe_apply_dense(p, x, cfg), params, xs[k])


@pytest.mark.parametrize("path", ["moe_apply_ep", "moe_apply_ep_a2a"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_expert_parallel_path_matches_dense(run, size, path):
    want, want_g = _dense(size)
    want = float(want.detach())
    got = run[size, path]
    assert abs(got["loss"] - want) <= LOSS_TOL * abs(want)
    for name, w in want_g.items():
        err = float((got["grads"][name] - w).abs().max() / w.abs().max())
        assert err <= LEAF_TOL, (name, err)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_moe_apply_takes_the_references_route(run, size):
    got = run[size, "dispatch"]
    assert got["routes"] == [ROUTE[size]]
    assert got["loss"] == run[size, ROUTE[size]]["loss"]


def test_experts_shard_over_the_model_axis(run):
    """w_gate / w_up (E, d, f) and w_down (E, f, d): experts over "model",
    d over "data" (FSDP); the router replicated."""
    p = run["placements"]
    assert p["w_gate"] == p["w_up"] == "(Shard(dim=1), Shard(dim=0))"
    assert p["w_down"] == "(Shard(dim=2), Shard(dim=0))"
    assert p["router"] == "(Replicate(), Replicate())"
