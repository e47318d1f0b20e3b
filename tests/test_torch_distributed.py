"""The port's data-parallel path (`repro_torch.core.distributed`, `mesh=`)
on the CPU: W ranks, each a spawned process in a gloo group (a file store
under the test's tmp dir, no ports), against the port's single-process
loss, and at W = 1 against `repro.core.distributed` on a one-device mesh.

Every world runs once, all three at the same time, in a module fixture
that joins its ranks with a timeout of its own, so a hang fails the tests
rather than stalling the suite. Each rank writes what it computed; the
tests compare here:

* losses and every gradient leaf, SGPR and GP-LVM, through "jnp",
  "fused" and "pallas", at W = 2 and 3 with N ragged against W: the local
  gradients of every rank put together, the global ones on every rank, to
  the single-process loss at 1e-10 (float64; the sums only regroup);
* at W = 1 the same against the reference's shard_map losses through
  its plain statistics, as tests/test_distributed.py runs them: loss
  1e-10, gradients 1e-8 (the reference's own gradient tolerance);
* three Adam steps through the `mesh=` facades: the global parameters
  bitwise equal on every rank, and the fit and its predictions within
  1e-5 of the single-process facade's (Adam rounds each step to float32,
  as in test_torch_models.py).
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import distributed, gplvm, inference
from repro_torch.gp import BayesianGPLVM, SparseGPRegression
from repro_torch.optim.adam import flatten

WORLDS = (1, 2, 3)
BACKENDS = ("jnp", "fused", "pallas")
MODELS = ("sgpr", "gplvm")
JOIN_TIMEOUT_S = 120
RTOL = 1e-10
FIT_TOL = 1e-5
STEPS = 3
XT = np.linspace(-2.5, 2.5, 7)[:, None]


def _problem(model):
    """(data arrays, float64 params as numpy): N = 53 / 47, ragged against
    W = 2 and 3, inducing points on a grid about a lengthscale apart."""
    rng = np.random.default_rng(0 if model == "sgpr" else 1)
    if model == "sgpr":
        X = rng.uniform(-3.0, 3.0, (53, 1))
        Y = np.hstack([np.sin(X), np.cos(X)]) + 0.1 * rng.normal(size=(53, 2))
        params = {"kern": {"log_variance": np.float64(0.1),
                           "log_lengthscale": np.log([0.9])},
                  "Z": np.linspace(-3.0, 3.0, 7)[:, None],
                  "log_beta": np.float64(2.0)}
        return (X, Y), params
    t = rng.uniform(-2.0, 2.0, (47, 2))
    Y = np.hstack([np.sin(t), t[:, :1] * t[:, 1:]]) + 0.05 * rng.normal(size=(47, 3))
    params = {"kern": {"log_variance": np.float64(0.0),
                       "log_lengthscale": np.log([1.1, 0.9])},
              "Z": rng.uniform(-2.0, 2.0, (6, 2)), "log_beta": np.float64(3.0),
              "q_mu": t + 0.1 * rng.normal(size=t.shape),
              "q_logS": np.log(rng.uniform(0.05, 0.2, t.shape))}
    return (Y,), params


def _facade(model, **kwargs):
    if model == "sgpr":
        return SparseGPRegression(M=7, backend="pallas", device="cpu", **kwargs)
    return BayesianGPLVM(M=6, Q=1, backend="pallas", device="cpu", **kwargs)


def _single_loss(model, backend):
    """The port's single-process loss(params, *data)."""
    if model == "sgpr":
        return SparseGPRegression(M=7, backend=backend, device="cpu")._loss
    return lambda p, Y: gplvm.loss(p, Y, backend=backend)


def _rank(rank, world, store, out):
    """One rank: every loss and gradient, then the facades' fits."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = distributed.make_gp_mesh(device_type="cpu")
        res = {}
        for model in MODELS:
            data, p_np = _problem(model)
            params = distributed.shard_gp_params(
                convert.params_from_numpy(p_np, device="cpu"), mesh)
            local = tuple(distributed.shard(torch.as_tensor(a), mesh) for a in data)
            make = (distributed.sgpr_loss_dist if model == "sgpr"
                    else distributed.gplvm_loss_dist)
            for backend in BACKENDS:
                res[model, backend] = inference.value_and_grad(
                    make(mesh, backend=backend), params, local)
            fitted = _facade(model, mesh=mesh).fit(*data, steps=STEPS, log_every=1)
            res[model, "fit"] = {"history": fitted.history, "params": fitted.params,
                                 "predict": fitted.predict(XT), "elbo": fitted.elbo()}
        torch.save(res, out / f"w{world}_r{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's results]}, every world run at once."""
    out = tmp_path_factory.mktemp("dist")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, w, str(out / f"store{w}"), out))
             for w in WORLDS for r in range(w)]
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
    return {w: [torch.load(out / f"w{w}_r{r}.pt") for r in range(w)] for w in WORLDS}


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) else want
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _gathered_grads(ranks, key) -> dict:
    """Every rank's gradient leaves: locals put together in rank order,
    globals from rank 0 (held equal on every rank)."""
    paths = flatten(ranks[0][key][1])[0]
    per_rank = [flatten(r[key][1])[1] for r in ranks]
    out = {}
    for i, path in enumerate(paths):
        if distributed.PARAM_ROLES[path.split("/")[0]] == "local":
            out[path] = torch.cat([leaves[i] for leaves in per_rank])
        else:
            for leaves in per_rank[1:]:
                assert torch.equal(leaves[i], per_rank[0][i]), path
            out[path] = per_rank[0][i]
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("world", (2, 3))
def test_loss_and_gradients_match_the_single_process(runs, world, model, backend):
    data, p_np = _problem(model)
    want, want_g = inference.value_and_grad(
        _single_loss(model, backend), convert.params_from_numpy(p_np, device="cpu"),
        tuple(torch.as_tensor(a) for a in data))
    ranks = runs[world]
    for r in ranks:
        assert torch.equal(r[model, backend][0], ranks[0][model, backend][0])
    assert _rel(ranks[0][model, backend][0], want) <= RTOL
    got = _gathered_grads(ranks, (model, backend))
    paths, leaves = flatten(want_g)
    assert sorted(got) == sorted(paths)
    for path, w in zip(paths, leaves):
        assert got[path].dtype == torch.float64, path
        assert _rel(got[path], w) <= RTOL, path


@pytest.mark.parametrize("model", MODELS)
def test_one_rank_matches_the_reference_shard_map_loss(runs, model):
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jdist

    data, p_np = _problem(model)
    mesh = jdist.make_gp_mesh()
    make = jdist.sgpr_loss_dist if model == "sgpr" else jdist.gplvm_loss_dist
    want, want_g = jax.jit(jax.value_and_grad(make(mesh)))(
        jax.tree.map(jnp.asarray, p_np), *map(jnp.asarray, data))
    loss, grads = runs[1][0][model, "jnp"]
    assert _rel(loss, want) <= RTOL
    paths, leaves = flatten(grads)
    for path, g, w in zip(paths, leaves, jax.tree.leaves(want_g)):
        assert _rel(g, w) <= 1e-8, path


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("world", (2, 3))
def test_adam_keeps_the_globals_bitwise_equal_on_every_rank(runs, world, model):
    ranks = runs[world]
    fits = [r[model, "fit"] for r in ranks]
    for name in distributed.SGPR_PARAM_NAMES:
        want_paths, want = flatten(fits[0]["params"][name])
        for fit in fits[1:]:
            for path, a, b in zip(want_paths, flatten(fit["params"][name])[1], want):
                assert torch.equal(a, b), f"{name}/{path}"
    for fit in fits[1:]:
        assert fit["history"] == fits[0]["history"]
        for a, b in zip(fit["predict"], fits[0]["predict"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_facade_fit_and_predict_match_the_single_process(runs, world, model):
    data, _ = _problem(model)
    single = _facade(model).fit(*data, steps=STEPS, log_every=1)
    fits = [r[model, "fit"] for r in runs[world]]
    assert len(fits[0]["history"]) == STEPS
    np.testing.assert_allclose(fits[0]["history"], single.history, rtol=FIT_TOL)
    assert abs(fits[0]["elbo"] - single.elbo()) <= FIT_TOL * abs(single.elbo())
    for g, w in zip(fits[0]["predict"], single.predict(XT)):
        assert _rel(g, w) <= FIT_TOL
    paths, want = flatten(single.params)
    for i, path in enumerate(paths):
        leaves = [flatten(f["params"])[1][i] for f in fits]
        got = (torch.cat(leaves) if distributed.PARAM_ROLES[path.split("/")[0]] == "local"
               else leaves[0])
        assert got.dtype == want[i].dtype, path
        assert _rel(got, want[i]) <= FIT_TOL, path


def test_make_gp_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        distributed.make_gp_mesh(device_type="cpu")
