"""The port's sharded steps against the reference's on the same (2, 2) mesh.

tests/test_torch_mesh_steps.py holds the port's sharded steps against the
port's own single process. This file holds them against the reference's
sharded steps, so that where the sharded result differs from one process
on purpose it is the reference's difference: the expert-parallel MoE
paths compute their load-balance term on each shard's tokens and average
it over the shards (`repro/models/moe.py:150-151, :261`), and each shard
keeps its own expert capacity, so that which pairs are dropped depends on
the shards (at capacity factor 0.5 pairs are dropped at both of the
all-to-all path's stages and on the all-reduce path).

The smoke config of moonshot-v1-16b-a3b (MoE, 8 experts, top 3) with the
reference's parameters (`convert`) and one numpy batch runs, at once:

* in a subprocess with four host devices, the reference's
  `make_train_step(...).jitted()`, `jax.value_and_grad` of its
  `train_loss` under the mesh's `constrain`, and its prefill and decode
  bundles, on a (data 2, model 2) mesh;
* on four spawned gloo ranks (CPU), the port's bundles on its (2, 2)
  `DeviceMesh`.

The train batch (4 x 64) gives each rank 64 tokens, so both packages take
the all-to-all path; the prefill (2 x 16) and the decode step take the
all-reduce path. Held at the single-process parity tolerances of
tests/test_torch_lm_models.py (float32, relative to the reference's
largest entry): the loss, the CE and the aux term 1e-5; every gradient
leaf, and every leaf of Adam's first moment after the jitted train step,
1e-4; the prefill and decode logits 1e-4.
"""
import multiprocessing
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _lm_parity import assert_trees_close, config_pair, lm_batch, rel_err, to_numpy
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models import model_zoo, moe
from repro_torch.optim import adam_init
from repro_torch.parallel import sharding as shd

ARCH = "moonshot-v1-16b-a3b"
TRAIN = (4, 64)  # batch, sequence: 64 tokens a rank, the all-to-all path
SERVE = (2, 16)  # batch, prompt: the all-reduce path
# low enough that both paths drop pairs at each capacity stage, on each shard
CAPACITY = 0.5
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
LOGITS_TOL = 1e-4
JOIN_TIMEOUT_S = 240

_REF = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_enable_x64", True)
from repro import compat
from repro.configs.base import ModelConfig, ShapeCell
from repro.launch import steps
from repro.models import model_zoo
from repro.optim import adam_init
from repro.parallel import sharding as shd

with open({inp!r}, "rb") as f:
    d = pickle.load(f)
cfg = ModelConfig(**d["cfg"])
model = model_zoo.build(cfg)
mesh = compat.make_mesh((2, 2), ("data", "model"))
params = jax.tree.map(jnp.asarray, d["params"])
batch = {{k: jnp.asarray(v) for k, v in d["batch"].items()}}
prompt = {{k: jnp.asarray(v) for k, v in d["prompt"].items()}}
B, S = d["batch"]["tokens"].shape
Bs, Ss = d["prompt"]["tokens"].shape
train = steps.make_train_step(cfg, ShapeCell("ref", S, B, "train"), mesh, batch=B)
constrain = shd.make_constrain(mesh)
(loss, met), grads = jax.jit(
    jax.value_and_grad(lambda p, b: model.train_loss(p, b, constrain), has_aux=True),
    in_shardings=(train.in_shardings[0], train.in_shardings[2]))(params, batch)
opt = adam_init(params, steps.default_adam(cfg))
_, opt, metrics = train.jitted()(jax.tree.map(jnp.copy, params), opt, batch)
prefill = steps.make_prefill_step(cfg, ShapeCell("ref", Ss, Bs, "prefill"), mesh, batch=Bs)
logits, states = prefill.jitted()(params, prompt)
decode = steps.make_decode_step(cfg, ShapeCell("ref", Ss + 1, Bs, "decode"), mesh, batch=Bs)
logits2, _ = decode.jitted()(params, states, jnp.asarray(d["next"]), jnp.asarray(Ss, jnp.int32))
out = {{"loss": float(loss), "ce": float(met["ce"]), "aux": float(met["aux"]),
        "grads": jax.tree.map(np.asarray, grads), "m": jax.tree.map(np.asarray, opt.m),
        "step": {{k: float(v) for k, v in metrics.items()}},
        "prefill": np.asarray(logits), "decode": np.asarray(logits2)}}
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
print("DONE")
"""


def _rank(rank, store, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=4, rank=rank)
    tmp = Path(tmp)
    try:
        with open(tmp / "inputs.pkl", "rb") as f:
            d = pickle.load(f)
        cfg = ModelConfig(**d["cfg"])
        model = model_zoo.build(cfg)
        mesh = lmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        params = convert.lm_tree_from_numpy(d["params"], device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in d["batch"].items()}
        prompt = {k: torch.as_tensor(v) for k, v in d["prompt"].items()}
        B, S = batch["tokens"].shape
        Bs, Ss = prompt["tokens"].shape
        routes = []
        orig = (moe.moe_apply_ep, moe.moe_apply_ep_a2a)

        def spy(name, fn):
            def run(*a, **k):
                routes.append(name)
                return fn(*a, **k)
            return run

        moe.moe_apply_ep, moe.moe_apply_ep_a2a = spy("ep", orig[0]), spy("a2a", orig[1])
        try:
            train = steps.make_train_step(cfg, ShapeCell("mesh", S, B, "train"), mesh, batch=B)
            P = shd.place(params, train.in_shardings[0])
            D = shd.place(batch, train.in_shardings[2])
            with shd.mesh_context(mesh):
                loss, met, grads = steps._value_and_grad(model, P, D, shd.make_constrain(mesh))
            route_train = list(routes)
            opt = shd.place(adam_init(params, steps.default_adam(cfg)), train.in_shardings[1])
            _, opt, metrics = train.jitted()(P, opt, D)
            del routes[:]
            prefill = steps.make_prefill_step(cfg, ShapeCell("mesh", Ss, Bs, "prefill"), mesh,
                                              batch=Bs)
            logits, states = prefill.jitted()(P, prompt)
            decode = steps.make_decode_step(cfg, ShapeCell("mesh", Ss + 1, Bs, "decode"), mesh,
                                            batch=Bs)
            logits2, _ = decode.jitted()(P, states, torch.as_tensor(d["next"]), Ss)
            route_serve = list(routes)
        finally:
            moe.moe_apply_ep, moe.moe_apply_ep_a2a = orig
        res = {"loss": float(shd.full(loss)), "ce": float(shd.full(met["ce"])),
               "aux": float(shd.full(met["aux"])), "grads": shd.gather(grads),
               "m": shd.gather(opt.m), "step": {k: float(v) for k, v in metrics.items()},
               "prefill": shd.full(logits), "decode": shd.full(logits2),
               "routes": (route_train, route_serve)}
        if rank == 0:
            torch.save(res, tmp / "port.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's), both runs at once."""
    import repro

    tmp = tmp_path_factory.mktemp("mesh_ref")
    jcfg, tcfg = config_pair(get_smoke_config(ARCH), capacity_factor=CAPACITY)
    params = to_numpy(jzoo.build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    inputs = {"cfg": {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__},
              "params": params, "batch": lm_batch(tcfg, *TRAIN, seed=3),
              "prompt": lm_batch(tcfg, *SERVE, seed=4),
              "next": rng.integers(0, tcfg.vocab_size, (SERVE[0], 1)).astype(np.int32)}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    src = str(Path(repro.__file__).resolve().parents[1])
    script = _REF.format(src=src, inp=str(tmp / "inputs.pkl"), out=str(tmp / "ref.pkl"))
    ref = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env={**os.environ, "PYTHONPATH": src})
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "store"), str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        out, err = ref.communicate(timeout=JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        ref.kill()
        out, err = ref.communicate()
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert "DONE" in out, out + err[-3000:]
    assert not hung, f"{len(hung)} ranks still running after {JOIN_TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    return want, torch.load(tmp / "port.pt")


def test_moe_paths_taken(runs):
    _, got = runs
    route_train, route_serve = got["routes"]
    assert route_train == ["a2a"] * get_smoke_config(ARCH).num_layers
    assert route_serve and set(route_serve) == {"ep"}


def test_sharded_loss_ce_and_aux_match_the_reference(runs):
    want, got = runs
    assert want["aux"] > 0
    for k in ("loss", "ce", "aux"):
        assert rel_err(torch.tensor(got[k]), want[k]) <= LOSS_TOL, (k, got[k], want[k])


def test_sharded_gradients_match_the_reference(runs):
    want, got = runs
    assert_trees_close(got["grads"], want["grads"], LEAF_TOL, "gradients")


def test_sharded_train_step_matches_the_reference(runs):
    """Through both packages' `make_train_step(...).jitted()`: the step's
    metrics and Adam's first moment (the clipped gradients)."""
    want, got = runs
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert rel_err(torch.tensor(got["step"][k]), want["step"][k]) <= LOSS_TOL, k
    assert_trees_close(got["m"], want["m"], LEAF_TOL, "first moment")


def test_sharded_prefill_and_decode_match_the_reference(runs):
    want, got = runs
    assert rel_err(got["prefill"], want["prefill"]) <= LOGITS_TOL
    assert rel_err(got["decode"], want["decode"]) <= LOGITS_TOL
