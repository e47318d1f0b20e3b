"""The port's durable serving tier (`repro_torch.serve.persist` and
`GPServer` persistence, budgeting, restart) on the CPU.

The reference's cases of tests/test_serve_persist.py against the port:
kernel-spec round trips, ulp-exact state round trips, corrupt-checkpoint
rejection, LRU eviction/lazy-reload parity and kill-and-restart serving
bit-identical predictions. Then stores crossing between the packages both
ways, for both state kinds, a Sum/Product spec and a schema-1 manifest:
every leaf bitwise equal and predictions within PRED_RTOL (relative to
max|reference|) in float64 — the two packages' predict epilogues round
apart, the stored bits never do.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.gp import get as jget
from repro.gp import suff_stats as jsuff_stats
from repro.gp.stats import ExactBatch as JExactBatch
from repro.serve import StateStore as JStateStore
from repro.temporal.model import TemporalState as JTemporalState
from repro_torch import serve
from repro_torch.gp import ExactBatch, get, suff_stats
from repro_torch.serve import (PERSIST_SCHEMA, CheckpointCorruptError,
                               GPServer, StateStore, TemporalState,
                               kernel_from_spec, kernel_spec, state_kind)
from repro_torch.serve.server import BUDGET_ENV

PRED_RTOL = 1e-12


def _fitted(seed=0, N=160, M=10, Q=1, phase=0.0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3.0, 3.0, (N, Q)), axis=0)
    Y = np.sin(2.0 * X + phase) + 0.1 * rng.normal(size=(N, 1))
    X, Y = torch.as_tensor(X), torch.as_tensor(Y)
    kernel = get("rbf")(Q)
    params = {"kern": kernel.init(1.1, 0.7, device="cpu", dtype=torch.float64),
              "Z": X[:: N // M][:M], "log_beta": torch.tensor(2.0, dtype=torch.float64)}
    stats = suff_stats(kernel, params["kern"], ExactBatch(X, Y, params["Z"]))
    return kernel, serve.build_state(kernel, params, stats), X


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _assert_states_identical(a, b):
    """Every leaf bit-identical AND dtype-identical — persistence must be a
    ulp-exact round trip, not merely allclose."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, f"leaf {i}: {x.dtype} != {y.dtype}"
        assert x.shape == y.shape, f"leaf {i}: {x.shape} != {y.shape}"
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


def _server(**kw):
    return GPServer(device="cpu", **kw)


# ---------------------------------------------------------------------------
# kernel specs
# ---------------------------------------------------------------------------

def _same_kernel(a, b) -> bool:
    if type(a) is not type(b) or a.input_dim != b.input_dim:
        return False
    pa, pb = getattr(a, "parts", None), getattr(b, "parts", None)
    if pa is None or pb is None:
        return pa is pb and a == b  # leaf kernels are frozen dataclasses
    return len(pa) == len(pb) and all(map(_same_kernel, pa, pb))


_SPECS = [
    lambda g: g("rbf")(2),
    lambda g: g("linear")(3),
    lambda g: g("sum")(g("rbf")(2), g("linear")(2)),
    lambda g: g("product")(g("rbf")(1), g("matern32")(1)),
    lambda g: g("sum")(g("product")(g("rbf")(2), g("linear")(2)), g("matern52")(2)),
]


@pytest.mark.parametrize("make", _SPECS)
def test_kernel_spec_round_trips(make):
    kernel = make(get)
    spec = kernel_spec(kernel)
    json.dumps(spec)  # must be JSON-able as-is (it rides the manifest)
    rebuilt = kernel_from_spec(spec)
    assert _same_kernel(rebuilt, kernel)
    assert kernel_spec(rebuilt) == spec
    # the reference writes the same spec for the same kernel
    assert jserve.kernel_spec(make(jget)) == spec


def test_kernel_spec_rejects_garbage():
    with pytest.raises(ValueError, match="malformed"):
        kernel_from_spec({"input_dim": 2})
    with pytest.raises(KeyError):
        kernel_from_spec({"name": "no-such-kernel", "input_dim": 2})


# ---------------------------------------------------------------------------
# StateStore round trip
# ---------------------------------------------------------------------------

def test_store_round_trip_is_ulp_exact(tmp_path):
    kernel, state, _ = _fitted()
    store = StateStore(tmp_path)
    step = store.save("m", kernel, state)
    assert step == 1 and store.has("m") and store.names() == ("m",)
    kernel2, state2 = store.load("m", device="cpu")
    assert kernel2 == kernel
    _assert_states_identical(state2, state)
    for field in ("Z", "log_beta", "L", "LA", "Kuu_inv_mean"):
        assert torch.equal(getattr(state2, field), getattr(state, field)), field
    # the manifest-only byte accounting matches the live state
    assert store.nbytes("m") == state.nbytes
    assert state_kind(state2) == "posterior"


def test_reload_keeps_the_served_layout(tmp_path):
    """Matrix products on the card may round differently for another
    layout, so a reloaded state has the strides of the state the server
    served before the eviction: the Cholesky factors column-major, a
    strided view (Z, every 16th input) contiguous, each in fresh storage."""
    kernel, state, X = _fitted()
    assert state.L.stride() == (1, state.M) and not state.Z.is_contiguous()
    served = serve.persist.as_stored(state)
    assert served.L.stride() == (1, state.M) and served.Z.is_contiguous()
    assert served.Z.data_ptr() != state.Z.data_ptr()
    _assert_states_identical(served, state)
    StateStore(tmp_path / "s").save("m", kernel, state)
    _, loaded = StateStore(tmp_path / "s").load("m", device="cpu")
    assert [t.stride() for t in _leaves(loaded)] == [t.stride() for t in _leaves(served)]
    srv = _server(store=tmp_path / "srv", budget_bytes=state.nbytes + 8)
    srv.register("a", kernel=kernel, state=state)
    before = [t.stride() for t in _leaves(srv.state("a"))]
    srv.register("b", kernel=kernel, state=state)  # evicts a
    assert [t.stride() for t in _leaves(srv.state("a"))] == before  # reloaded
    assert srv.metrics()["lazy_loads"] == 1
    srv.close()


def test_store_versions_and_composite_kernels(tmp_path):
    kernel = get("sum")(get("rbf")(1), get("linear")(1))
    _, state, _ = _fitted()
    state = state._replace(kern=kernel.init(device="cpu", dtype=torch.float64))
    store = StateStore(tmp_path, keep=2)
    assert store.save("m", kernel, state) == 1
    bumped = state._replace(log_beta=state.log_beta + 1.0)
    assert store.save("m", kernel, bumped) == 2
    kernel2, loaded = store.load("m", device="cpu")
    assert _same_kernel(kernel2, kernel)  # composite spec round-tripped
    _assert_states_identical(loaded, bumped)  # newest step wins


def test_store_rejects_unsafe_names(tmp_path):
    kernel, state, _ = _fitted()
    store = StateStore(tmp_path)
    for bad in ("../escape", "a/b", "", ".hidden"):
        with pytest.raises((ValueError, FileNotFoundError)):
            store.save(bad, kernel, state)


def test_load_missing_model_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        StateStore(tmp_path).load("never-saved", device="cpu")


def test_store_delete(tmp_path):
    kernel, state, _ = _fitted()
    store = StateStore(tmp_path)
    store.save("m", kernel, state)
    store.delete("m")
    assert not store.has("m") and store.names() == ()


# ---------------------------------------------------------------------------
# corrupt checkpoints are rejected, loudly
# ---------------------------------------------------------------------------

def _saved_store(tmp_path):
    kernel, state, X = _fitted()
    store = StateStore(tmp_path)
    store.save("m", kernel, state)
    return store, kernel, state, X


def test_truncated_arrays_rejected(tmp_path):
    store, *_ = _saved_store(tmp_path)
    npz = next((tmp_path / "m").glob("step_*/arrays.npz"))
    npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 3])
    with pytest.raises(CheckpointCorruptError):
        store.load("m", device="cpu")


def test_garbage_manifest_rejected(tmp_path):
    store, *_ = _saved_store(tmp_path)
    manifest = next((tmp_path / "m").glob("step_*/manifest.json"))
    manifest.write_text("{not json")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        store.load("m", device="cpu")


def test_wrong_persist_schema_rejected(tmp_path):
    store, *_ = _saved_store(tmp_path)
    manifest = next((tmp_path / "m").glob("step_*/manifest.json"))
    doc = json.loads(manifest.read_text())
    doc["extra"]["persist_schema"] = PERSIST_SCHEMA + 999
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CheckpointCorruptError, match="persist_schema"):
        store.load("m", device="cpu")
    with pytest.raises(CheckpointCorruptError, match="persist_schema"):
        store.load_meta("m")


def test_missing_leaf_rejected(tmp_path):
    store, *_ = _saved_store(tmp_path)
    npz = next((tmp_path / "m").glob("step_*/arrays.npz"))
    arrays = dict(np.load(npz, allow_pickle=False))
    removed = next(k for k in arrays if k.endswith("LA"))
    del arrays[removed]
    np.savez(npz, **arrays)
    with pytest.raises(CheckpointCorruptError, match="LA"):
        store.load("m", device="cpu")


def test_unknown_state_kind_and_missing_spec_rejected(tmp_path):
    store, *_ = _saved_store(tmp_path)
    manifest = next((tmp_path / "m").glob("step_*/manifest.json"))
    doc = json.loads(manifest.read_text())
    doc["extra"]["state_kind"] = "mystery"
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CheckpointCorruptError, match="state_kind"):
        store.load("m", device="cpu")
    del doc["extra"]["kernel"]
    doc["extra"]["state_kind"] = "posterior"
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CheckpointCorruptError, match="kernel spec"):
        store.load_meta("m")


# ---------------------------------------------------------------------------
# budgeted server: evict -> lazy reload -> identical predictions
# ---------------------------------------------------------------------------

def test_eviction_reload_serves_identically(tmp_path):
    models = {f"m{i}": _fitted(seed=i, phase=0.3 * i) for i in range(4)}
    Xt = models["m0"][2][:13]
    reference = _server()
    for name, (kernel, state, _) in models.items():
        reference.register(name, kernel=kernel, state=state)
    expected = {name: reference.predict(name, Xt) for name in models}

    state_bytes = models["m0"][1].nbytes
    budgeted = _server(store=StateStore(tmp_path), budget_bytes=2 * state_bytes + 8)
    for name, (kernel, state, _) in models.items():
        budgeted.register(name, kernel=kernel, state=state)
    # walk all models twice in round-robin: every access past the first two
    # evicts someone and (second lap) lazily reloads the victim
    for _ in range(2):
        for name in models:
            mean, var = budgeted.predict(name, Xt)
            assert torch.equal(mean, expected[name][0]), name
            assert torch.equal(var, expected[name][1]), name
    m = budgeted.metrics()
    assert m["evictions"] > 0 and m["lazy_loads"] > 0
    assert m["peak_resident_bytes"] <= m["budget_bytes"]
    assert m["resident_bytes"] <= m["budget_bytes"]
    assert m["registered"] == 4 and m["resident_models"] <= 2
    assert set(m) == {"registered", "resident_models", "resident_bytes",
                      "peak_resident_bytes", "budget_bytes", "evictions",
                      "lazy_loads", "rejected", "expired"}
    budgeted.close()
    reference.close()


def test_update_on_evicted_state_reloads_then_folds(tmp_path):
    (k0, s0, X0), (k1, s1, _) = _fitted(seed=0), _fitted(seed=1, phase=0.5)
    srv = _server(store=StateStore(tmp_path), budget_bytes=s0.nbytes + 8)
    srv.register("a", kernel=k0, state=s0)
    srv.register("b", kernel=k1, state=s1)  # evicts a (dirty -> persisted)
    assert srv.metrics()["evictions"] == 1
    srv.update("a", X0[:7], torch.sin(2.0 * X0[:7]))  # reloads a, folds, swaps
    assert float(srv.state("a").stats.n) == float(s0.stats.n) + 7
    assert srv.metrics()["lazy_loads"] >= 1
    # the same update on a server that never evicted: bitwise the same state
    plain = _server()
    plain.register("a", kernel=k0, state=s0)
    plain.update("a", X0[:7], torch.sin(2.0 * X0[:7]))
    _assert_states_identical(srv.state("a"), plain.state("a"))
    srv.close()
    plain.close()


def test_budget_requires_store_and_env_knob(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="store"):
        _server(budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="positive"):
        _server(store=StateStore(tmp_path), budget_bytes=0)
    kernel, state, _ = _fitted()
    monkeypatch.setenv(BUDGET_ENV, str(state.nbytes + 8))
    srv = _server(store=StateStore(tmp_path))  # budget picked up from env
    assert srv.budget_bytes == state.nbytes + 8
    srv.register("a", kernel=kernel, state=state)
    srv.register("b", kernel=kernel, state=state)
    assert srv.metrics()["evictions"] == 1
    assert srv.metrics()["resident_bytes"] <= srv.budget_bytes
    srv.close()


def test_save_all_needs_a_store():
    kernel, state, _ = _fitted()
    srv = _server()
    srv.register("a", kernel=kernel, state=state)
    with pytest.raises(ValueError, match="store"):
        srv.save_all()
    srv.close()


# ---------------------------------------------------------------------------
# the acceptance test: kill-and-restart serves bit-identical predictions
# ---------------------------------------------------------------------------

def test_kill_and_restart_is_bit_identical(tmp_path):
    store = StateStore(tmp_path)
    models = {f"m{i}": _fitted(seed=i, phase=0.4 * i) for i in range(3)}
    Xt = models["m0"][2][:9]

    srv = _server(store=store)
    for name, (kernel, state, _) in models.items():
        srv.register(name, kernel=kernel, state=state)
    # mutate one model after registration — save_all must capture the
    # LATEST state, not the registered snapshot
    Xu = models["m1"][2][:11]
    srv.update("m1", Xu, torch.cos(Xu))
    saved = srv.save_all()
    assert set(saved) == set(models)  # all dirty -> all written
    assert srv.save_all() == ()  # second call: everything clean, no writes
    expected = {name: srv.predict(name, Xt) for name in models}
    before = {name: srv.state(name) for name in models}
    srv.close()
    del srv  # the "kill"

    restarted = GPServer.load(store, device="cpu")
    assert restarted.models() == tuple(sorted(models))
    assert restarted.metrics()["resident_bytes"] == 0  # cold start
    for name in models:
        mean, var = restarted.predict(name, Xt)
        assert torch.equal(mean, expected[name][0]), name
        assert torch.equal(var, expected[name][1]), name
        _assert_states_identical(restarted.state(name), before[name])
    fut = restarted.submit("m1", Xt)  # the submit path serves them too
    assert torch.equal(fut.result(timeout=30)[0], expected["m1"][0])
    restarted.close()


def test_restart_under_budget_stays_under_budget(tmp_path):
    store = StateStore(tmp_path)
    models = {f"m{i}": _fitted(seed=i) for i in range(5)}
    srv = _server(store=store)
    for name, (kernel, state, _) in models.items():
        srv.register(name, kernel=kernel, state=state)
    srv.save_all()
    srv.close()

    budget = 2 * models["m0"][1].nbytes + 8
    restarted = GPServer.load(str(tmp_path), budget_bytes=budget, device="cpu")
    assert restarted.metrics()["registered"] == 5
    Xt = models["m0"][2][:5]
    for name in models:  # touch everything: forces evict/reload churn
        restarted.predict(name, Xt)
    m = restarted.metrics()
    assert m["peak_resident_bytes"] <= budget
    assert m["resident_models"] <= 2
    restarted.close()


# ---------------------------------------------------------------------------
# stores cross between the packages, both ways
# ---------------------------------------------------------------------------

def _jax_posterior(seed=0, N=160, M=10, kernel_name="rbf"):
    """A reference PosteriorState (float64, kernel params float32 as the
    reference's init makes them) from numpy data."""
    rng = np.random.default_rng(seed)
    X = jnp.asarray(np.sort(rng.uniform(-3.0, 3.0, (N, 1)), axis=0))
    Y = jnp.sin(2.0 * X) + 0.1 * jnp.asarray(rng.normal(size=(N, 1)))
    kernel = (jget("product")(jget("rbf")(1), jget("rbf")(1))
              if kernel_name == "product" else jget(kernel_name)(1))
    params = {"kern": kernel.init(), "Z": X[:: N // M][:M],
              "log_beta": jnp.asarray(2.0, jnp.float64)}
    stats = jsuff_stats(kernel, params["kern"], JExactBatch(X, Y, params["Z"]))
    return kernel, jserve.build_state(kernel, params, stats), np.asarray(X[:17])


def _temporal_fields(seed=0):
    """A temporal state of Sum(Matern32, Matern12) (d = 3) as float64 numpy
    arrays. (Float32 hyperparameters would put the two libraries' float32
    `exp` an ulp apart, ~3e-8 in the forecast: the float64 comparison is
    the one the stored bits decide.)"""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3, 3))
    return {"kern": {"k0": {"log_variance": np.float64(0.2),
                            "log_lengthscale": np.asarray([-0.3])},
                     "k1": {"log_variance": np.float64(-0.4),
                            "log_lengthscale": np.asarray([0.1])}},
            "log_beta": np.float64(1.5), "t_last": np.float64(2.0),
            "m": rng.normal(size=(3, 2)), "P": A @ A.T + 3.0 * np.eye(3),
            "n": np.float64(40.0)}


def _jax_temporal(fields):
    kernel = jget("sum")(jget("matern32")(1), jget("matern12")(1))
    state = JTemporalState(**{k: jax.tree.map(jnp.asarray, fields[k])
                              for k in JTemporalState._fields})
    return kernel, state


def _to_numpy(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _torch_leaves(state):
    return [t.numpy() for t in _leaves(state)]


def _pred_rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


@pytest.mark.parametrize("kernel_name", ["rbf", "product"])
def test_reference_posterior_store_loads_in_the_port(tmp_path, kernel_name):
    jkernel, jstate, Xt = _jax_posterior(kernel_name=kernel_name)
    JStateStore(tmp_path).save("m", jkernel, jstate)
    kernel, state = StateStore(tmp_path).load("m", device="cpu")
    assert kernel_spec(kernel) == jserve.kernel_spec(jkernel)
    for got, want in zip(_torch_leaves(state), _to_numpy(jstate)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    want = jserve.predict(jkernel, jstate, jnp.asarray(Xt))
    got = serve.predict(kernel, state, torch.as_tensor(np.array(Xt)))
    for g, w in zip(got, want):
        assert _pred_rel(g, w) <= PRED_RTOL


@pytest.mark.parametrize("kernel_name", ["rbf", "product"])
def test_port_posterior_store_loads_in_the_reference(tmp_path, kernel_name):
    jkernel, jstate, Xt = _jax_posterior(seed=2, kernel_name=kernel_name)
    # the port's own state, from the reference's numbers
    kernel = kernel_from_spec(jserve.kernel_spec(jkernel))
    state = serve.PosteriorState(*jax.tree.map(
        lambda x: torch.as_tensor(np.array(x)), tuple(jstate),
        is_leaf=lambda x: isinstance(x, jax.Array)))
    state = state._replace(stats=type(state.stats)(*state.stats))
    StateStore(tmp_path).save("m", kernel, state)
    jkernel2, jstate2 = JStateStore(tmp_path).load("m")
    assert jserve.kernel_spec(jkernel2) == kernel_spec(kernel)
    for got, want in zip(_to_numpy(jstate2), _torch_leaves(state)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    want = serve.predict(kernel, state, torch.as_tensor(np.array(Xt)))
    got = jserve.predict(jkernel2, jstate2, jnp.asarray(Xt))
    for g, w in zip(got, want):
        assert _pred_rel(g, w) <= PRED_RTOL


def test_temporal_stores_cross_both_ways(tmp_path):
    fields = _temporal_fields()
    jkernel, jstate = _jax_temporal(fields)
    t_new = np.asarray([[2.1], [2.5], [3.0]])
    # reference -> port
    JStateStore(tmp_path / "a").save("ts", jkernel, jstate)
    kernel, state = StateStore(tmp_path / "a").load("ts", device="cpu")
    assert isinstance(state, TemporalState) and state_kind(state) == "temporal"
    for got, want in zip(_torch_leaves(state), _to_numpy(jstate)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    want = jserve.predict(jkernel, jstate, jnp.asarray(t_new))
    got = serve.predict(kernel, state, torch.as_tensor(t_new))
    for g, w in zip(got, want):
        assert _pred_rel(g, w) <= PRED_RTOL
    # port -> reference
    StateStore(tmp_path / "b").save("ts", kernel, state)
    manifest = json.loads(next((tmp_path / "b/ts").glob("step_*/manifest.json")).read_text())
    assert manifest["extra"]["state_kind"] == "temporal"
    assert list(manifest["leaves"])[:3] == [".kern/k0/log_lengthscale",
                                            ".kern/k0/log_variance",
                                            ".kern/k1/log_lengthscale"]
    jkernel2, jstate2 = JStateStore(tmp_path / "b").load("ts")
    assert isinstance(jstate2, JTemporalState)
    for got, want in zip(_to_numpy(jstate2), _torch_leaves(state)):
        np.testing.assert_array_equal(got, want)


def test_schema_1_manifest_loads_as_posterior(tmp_path):
    """Schema 1 predates `state_kind`: such a manifest reads as a
    posterior state, in the port as in the reference."""
    kernel, state, _ = _fitted()
    StateStore(tmp_path).save("m", kernel, state)
    manifest = next((tmp_path / "m").glob("step_*/manifest.json"))
    doc = json.loads(manifest.read_text())
    doc["extra"]["persist_schema"] = 1
    del doc["extra"]["state_kind"]
    manifest.write_text(json.dumps(doc))
    _, loaded = StateStore(tmp_path).load("m", device="cpu")
    _assert_states_identical(loaded, state)
    _, jloaded = JStateStore(tmp_path).load("m")
    assert type(jloaded).__name__ == "PosteriorState"
    srv = GPServer.load(tmp_path, device="cpu")
    assert srv.state("m").Z.dtype == torch.float64
    srv.close()


def test_temporal_model_evicts_and_restarts(tmp_path):
    """A temporal state rides the budget and the restart like a posterior
    one: its cold entry takes `kind` from the manifest."""
    from repro_torch import convert

    kernel = get("sum")(get("matern32")(1), get("matern12")(1))
    ts = convert.temporal_state_from_numpy(_temporal_fields(), device="cpu")
    pk, ps, X = _fitted()
    t_new = torch.as_tensor([[2.1], [2.7]], dtype=torch.float64)
    srv = _server(store=tmp_path, budget_bytes=max(ts.nbytes, ps.nbytes) + 8)
    srv.register("ts", kernel=kernel, state=ts)
    want = srv.predict("ts", t_new)
    srv.register("post", kernel=pk, state=ps)  # evicts ts
    assert srv.metrics()["evictions"] == 1
    got = srv.predict("ts", t_new)  # lazy reload
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    srv.save_all()
    srv.close()
    restarted = GPServer.load(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="temporal"):
        restarted.predict("ts", t_new, diag=False)
    got = restarted.predict("ts", t_new)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    restarted.close()
