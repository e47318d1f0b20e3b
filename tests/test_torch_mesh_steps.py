"""The LM's train, prefill and decode steps sharded over a device mesh
(`parallel.sharding`, DTensor) on the CPU, against the single process.

Two worlds of spawned gloo ranks (a file store under the test's tmp dir)
run at once in a module fixture that joins them with a timeout of its
own: two ranks hold the (data 1, model 2) and (data 2, model 1) meshes,
four ranks the (2, 2) mesh. On each mesh the smoke configs of smollm-360m,
moonshot-v1-16b-a3b (at capacity factor 8, so that no pair is dropped and
the expert-parallel paths' per-shard capacity keeps every token, as the
reference's EP test runs it) and recurrentgemma-2b go through
`launch.steps` and `launch.serve.generate`. Each rank computes the
single-process results too and writes what it found; the tests compare:

* the loss and every gradient leaf, gathered, within 1e-5 of the single
  process's (float32: the sums only regroup), relative to each leaf's
  largest entry. Where the MoE config takes an expert-parallel path, the
  reference computes the load-balance term on each rank's tokens and
  averages it over the ranks (`repro/models/moe.py:150-151, :261`): the
  single process is then evaluated with that term (`_ep_aux_moe`, the
  dense layer's output and the term's mean over the same token groups);
  the parameters after the jitted train step within 1e-6
  of the single process's Adam step taken on the same (gathered)
  gradients (Adam's first step divides by |g|, so a gradient entry near
  zero turns a 1e-7 difference into one of the step size: the gradients
  are held, and the update applied to them);
* the prefill logits and the last decode step's logits within 1e-5, and
  the greedy tokens equal; the decode states built on the meta device
  only (each rank allocates its own shards, never the whole states);
* at (2, 2) every rank holds at most 35 % of the parameter bytes;
* the same at (2, 2) for rwkv6-7b, whisper-small, internvl2-2b and
  gemma3-4b (RWKV-6's chunks, the encoder and cross-attention, the
  multimodal prefix, a prompt longer than the sliding windows' rings);
* `core.gp_head.head_loss(axis_names=("data",))` over the two ranks of
  the (2, 1) mesh against the single process at 1e-10 (float64).
"""
import dataclasses
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.core import gp_head
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve, steps
from repro_torch.models import encdec, model_zoo, moe, transformer
from repro_torch.optim import adam_init, adam_update
from repro_torch.optim.adam import flatten, unflatten
from repro_torch.parallel import sharding as shd

MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
ARCHS = ("smollm-360m", "moonshot-v1-16b-a3b", "recurrentgemma-2b")
# the other families' hooks (RWKV-6's chunks, whisper's encoder and
# cross-attention, the multimodal prefix, gemma3's sliding windows) on the
# mesh with both axes
ARCHS_2X2 = ("rwkv6-7b", "whisper-small", "internvl2-2b", "gemma3-4b")
TRAIN = (4, 32)  # batch, sequence
SERVE = (2, 16, 3)  # batch, prompt, new tokens
# gemma3's prompt outruns its 16-slot windows: prefill fills the ring
SERVE_OF = {"gemma3-4b": (2, 24, 3)}
RTOL = 1e-5
ADAM_TOL = 1e-6
HEAD_TOL = 1e-10
MAX_LOCAL_SHARE = 0.35
JOIN_TIMEOUT_S = 240


def _cfg(arch):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.num_experts else cfg


def _rel(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def _ep_aux_moe(shape):
    """`moe_apply` as the single process evaluates it for an expert-parallel
    path on a (dp, tp) mesh: the dense layer's output (at capacity factor
    8 no pair is dropped, so the paths agree on it) and the load-balance
    term averaged over the token groups the path routes: the batch's rows
    over dp, and for the all-to-all path the sequence over tp too."""
    dp, tp = shape

    def apply(params, x, cfg, constrain=shd.no_constrain):
        y = moe.moe_apply_dense(params, x, cfg).y
        B, S, d = x.shape
        T_loc = (B // dp) * S
        a2a = T_loc % tp == 0 and T_loc // tp >= 64
        groups = [g for xb in x.chunk(dp, dim=0) for g in (xb.chunk(tp, dim=1) if a2a else [xb])]
        aux = torch.stack([moe._route(params, g.reshape(-1, d), cfg.num_experts,
                                      cfg.num_experts_per_tok)[2] for g in groups]).mean()
        return moe.MoEOut(y, aux.float())

    return apply


def _one(arch: str, mesh) -> dict:
    cfg = _cfg(arch)
    model = model_zoo.build(cfg)
    params = model.init(0, device="cpu")
    B, S = TRAIN
    cell = ShapeCell("mesh", S, B, "train")
    batch = model_zoo.make_batch(torch.Generator().manual_seed(1), cfg, cell, batch=B)
    adam = steps.default_adam(cfg)

    shape = tuple(shd.axis_sizes(mesh).values())
    ep = bool(cfg.num_experts) and shape[1] > 1
    dense_apply = moe.moe_apply
    if ep:
        moe.moe_apply = _ep_aux_moe(shape)
    try:
        loss1, _, grads1 = steps._value_and_grad(model, params, batch, shd.no_constrain)
    finally:
        moe.moe_apply = dense_apply
    bundle = steps.make_train_step(cfg, cell, mesh, batch=B)
    P = shd.place(params, bundle.in_shardings[0])
    O = shd.place(adam_init(params, adam), bundle.in_shardings[1])
    D = shd.place(batch, bundle.in_shardings[2])
    with shd.mesh_context(mesh):
        loss2, _, grads2 = steps._value_and_grad(model, P, D, shd.make_constrain(mesh))
    new, _, metrics = bundle.jitted()(P, O, D)
    paths = flatten(params)[0]
    got_g = [shd.full(g) for g in flatten(grads2)[1]]
    want_p = adam_update(unflatten(params, got_g), adam_init(params, adam), params, adam)[0]
    leaves = flatten(P)[1]
    local = sum(shd.local(t).numel() * t.element_size() for t in leaves)
    total = sum(t.numel() * t.element_size() for t in leaves)

    Bs, Ss, n = SERVE_OF.get(arch, SERVE)
    prompt = model_zoo.make_batch(torch.Generator().manual_seed(2), cfg,
                                  ShapeCell("serve", Ss, Bs, "prefill"), batch=Bs)
    r1 = serve.generate(cfg, params, prompt, n)
    seen = []  # the devices decode states are built on while the mesh serves
    inits = {mod: mod.init_decode_state for mod in (transformer, encdec)}

    def spy(init):
        def run(*a, device="cuda", **k):
            seen.append(str(device))
            return init(*a, device=device, **k)
        return run

    for mod, init in inits.items():
        mod.init_decode_state = spy(init)
    try:
        r2 = serve.generate(cfg, P, prompt, n, mesh=mesh)
    finally:
        for mod, init in inits.items():
            mod.init_decode_state = init
    return {"loss": (float(shd.full(loss2)), float(loss1)),
            "step_loss": float(metrics["loss"]),
            "grad_err": {p: _rel(g, w) for p, g, w in zip(paths, got_g, flatten(grads1)[1])},
            "adam_err": {p: _rel(shd.full(a), w) for p, a, w in
                         zip(paths, flatten(new)[1], flatten(want_p)[1])},
            "local_share": local / total,
            "prefill_err": _rel(r2.prefill_logits, r1.prefill_logits),
            "last_err": _rel(r2.last_logits, r1.last_logits),
            "tokens": (r2.tokens, r1.tokens), "state_devices": sorted(set(seen))}


def _head(mesh) -> dict:
    """head_loss over the mesh's "data" axis: this rank's rows, float64."""
    rng = np.random.default_rng(3)
    feats = torch.as_tensor(rng.normal(size=(40, 5)))
    tgts = torch.as_tensor(np.sin(rng.normal(size=(40,))))
    params = gp_head.init_head(0, 5, M=7, device="cpu")
    params = {"kern": {k: v.double() for k, v in params["kern"].items()},
              "Z": params["Z"].double(), "log_beta": params["log_beta"].double()}

    def value_and_grad(f, x, y, **kw):
        leaves = [t.detach().requires_grad_(True) for t in flatten(params)[1]]
        loss = gp_head.head_loss(unflatten(params, leaves), x, y, **kw)
        return float(loss), torch.autograd.grad(loss, leaves)

    want, want_g = value_and_grad(gp_head.head_loss, feats, tgts)
    r, n = mesh.get_local_rank("data"), mesh.size(0)
    rows = slice(40 * r // n, 40 * (r + 1) // n)
    got, got_g = value_and_grad(gp_head.head_loss, feats[rows], tgts[rows],
                                axis_names=("data",), mesh=mesh)
    return {"loss": (got, want), "grad_err": [_rel(g, w) for g, w in zip(got_g, want_g)]}


def _rank(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank)
    try:
        res = {}
        for shape in MESHES[world]:
            mesh = lmesh.make_mesh(shape, ("data", "model"), "cpu")
            for arch in ARCHS + (ARCHS_2X2 if shape == (2, 2) else ()):
                res[shape, arch] = _one(arch, mesh)
            if shape == (2, 1):
                res["head"] = _head(mesh)
        torch.save(res, out / f"w{world}_r{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's results]}, both worlds run at once."""
    out = tmp_path_factory.mktemp("mesh")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, w, str(out / f"store{w}"), out))
             for w in MESHES for r in range(w)]
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
    return {w: [torch.load(out / f"w{w}_r{r}.pt") for r in range(w)] for w in MESHES}


CELLS = [(w, shape) for w in MESHES for shape in MESHES[w]]


def _results(runs, world, shape, arch):
    ranks = [r[shape, arch] for r in runs[world]]
    for r in ranks[1:]:  # every rank ends with the same gathered values
        assert r["loss"] == ranks[0]["loss"] and r["grad_err"] == ranks[0]["grad_err"]
    return ranks[0]


def _check_train(r):
    got, want = r["loss"]
    assert abs(got - want) <= RTOL * abs(want)
    assert r["step_loss"] == got
    bad = {p: e for p, e in r["grad_err"].items() if not e <= RTOL}
    assert not bad, bad
    bad = {p: e for p, e in r["adam_err"].items() if not e <= ADAM_TOL}
    assert not bad, bad


def _check_serve(r):
    assert r["prefill_err"] <= RTOL and r["last_err"] <= RTOL, (r["prefill_err"], r["last_err"])
    assert torch.equal(*r["tokens"])
    # each rank allocates only its shards of the decode states
    assert r["state_devices"] == ["meta"], r["state_devices"]


def _check_share(runs, arch):
    shares = [r[(2, 2), arch]["local_share"] for r in runs[4]]
    assert max(shares) <= MAX_LOCAL_SHARE, shares


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world,shape", CELLS, ids=[f"{a}x{b}" for _, (a, b) in CELLS])
def test_sharded_train_step_matches_the_single_process(runs, world, shape, arch):
    _check_train(_results(runs, world, shape, arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world,shape", CELLS, ids=[f"{a}x{b}" for _, (a, b) in CELLS])
def test_sharded_prefill_and_decode_match_the_single_process(runs, world, shape, arch):
    _check_serve(_results(runs, world, shape, arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_a_share_of_the_parameters_at_2x2(runs, arch):
    _check_share(runs, arch)


@pytest.mark.parametrize("arch", ARCHS_2X2)
def test_other_families_train_step_at_2x2(runs, arch):
    _check_train(_results(runs, 4, (2, 2), arch))


@pytest.mark.parametrize("arch", ARCHS_2X2)
def test_other_families_prefill_and_decode_at_2x2(runs, arch):
    _check_serve(_results(runs, 4, (2, 2), arch))


@pytest.mark.parametrize("arch", ARCHS_2X2)
def test_other_families_share_of_the_parameters_at_2x2(runs, arch):
    _check_share(runs, arch)


def test_gp_head_statistics_summed_over_the_data_axis(runs):
    for r in runs[2]:
        got, want = r["head"]["loss"]
        assert abs(got - want) <= HEAD_TOL * abs(want)
        assert max(r["head"]["grad_err"]) <= HEAD_TOL, r["head"]["grad_err"]


def test_one_rank_mesh_leaves_plain_tensors():
    """No process group: the host mesh is one rank, every spec places as
    replicated, and nothing becomes a DTensor."""
    mesh = lmesh.make_host_mesh("cpu")
    assert isinstance(mesh, lmesh.LocalMesh) and shd.axis_sizes(mesh) == {"data": 1, "model": 1}
    cfg = get_smoke_config("smollm-360m")
    bundle = steps.make_train_step(cfg, ShapeCell("x", 16, 2, "train"), mesh, batch=2)
    params = model_zoo.build(cfg).init(0, device="cpu")
    placed = shd.place(params, bundle.in_shardings[0])
    assert all(a is b for a, b in zip(flatten(placed)[1], flatten(params)[1]))
    constrain = shd.make_constrain(mesh)
    x = torch.ones(2, 16, cfg.d_model)
    assert constrain(x, "act_embed") is x and constrain.tp == 1
