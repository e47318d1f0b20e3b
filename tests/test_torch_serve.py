"""The port's serving slice (`repro_torch.serve`, `repro_torch.convert`)
on the CPU.

Against the JAX reference: a `SparseGPRegression` and a `BayesianGPLVM`
fitted a few steps by `repro`, their parameters carried across with
`convert.params_from_numpy`; the port's statistics + `build_state` +
`predict` must equal the reference's `export_state()` + `predict` at 1e-10
relative to max|reference|, on both statistics backends.

Torch against torch, the server behaviours of tests/test_serve.py at its
tolerances: bucketed equals unpadded, submit round-trips under
concurrency, update equals a from-scratch build, downdate inverts update,
the downdate guard raises, admission control and deadlines fail only their
own requests, and a closed server refuses work.
"""
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.gp import BayesianGPLVM, SparseGPRegression
from repro.gp import get as jget
from repro_torch import convert
from repro_torch.core.psi_stats import SuffStats
from repro_torch.gp import ExactBatch, ExpectedBatch, get, suff_stats
from repro_torch.serve import (GPServer, QueueFullError, ServerClosedError,
                               build_state, online, predict)
from repro_torch.serve.server import _Request

RTOL = 1e-10


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) / scale


def _f64_params(model):
    """Cast a fitted facade's parameters to float64 (its kernel parameters
    are float32 after Adam) and drop its caches, so both packages evaluate
    the same float64 numbers."""
    model.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), model.params)
    model._posterior_cache = None
    model._stats_value_cache = None
    return jax.tree.map(np.asarray, model.params)


# ---------------------------------------------------------------------------
# the port against the reference's export_state() + predict
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted_gp():
    rng = np.random.default_rng(0)
    # 16 inducing points over a range of ~10 lengthscales keep Kuu
    # well-conditioned, so 1e-10 measures the port, not the conditioning
    X = np.sort(rng.uniform(-8.0, 8.0, (200, 1)), axis=0)
    Y = np.sin(X) + 0.1 * rng.normal(size=(200, 1))
    gp = SparseGPRegression(kernel=jget("rbf")(1), M=16).fit(
        jnp.asarray(X), jnp.asarray(Y), steps=15)
    return gp, _f64_params(gp), X, Y


@pytest.fixture(scope="module")
def fitted_gplvm():
    rng = np.random.default_rng(1)
    t = 3.0 * rng.normal(size=(96, 1))
    Y = np.hstack([np.sin(t), np.cos(t), 0.3 * t]) + 0.05 * rng.normal(size=(96, 3))
    # inducing points on a grid (not drawn from q(X)) keep Kuu
    # well-conditioned, as for the regression above
    init = {"kern": {"log_variance": np.float64(0.0), "log_lengthscale": np.zeros(1)},
            "Z": np.linspace(-6.0, 6.0, 10)[:, None], "log_beta": np.log(100.0),
            "q_mu": t, "q_logS": np.full((96, 1), np.log(0.1))}
    lvm = BayesianGPLVM(kernel=jget("rbf")(1), M=10).fit(
        jnp.asarray(Y), steps=15, lr=5e-2,
        params=jax.tree.map(jnp.asarray, init))
    return lvm, _f64_params(lvm), Y


@pytest.mark.parametrize("diag", (True, False))
@pytest.mark.parametrize("backend", ("jnp", "fused"))
def test_regression_state_predicts_like_jax_export(fitted_gp, backend, diag):
    gp, p_np, X, Y = fitted_gp
    Xt = np.linspace(-9.0, 9.0, 13)[:, None]
    want = jserve.predict(gp.kernel, gp.export_state(), jnp.asarray(Xt), diag=diag)
    params = convert.params_from_numpy(p_np, device="cpu", dtype=torch.float64)
    kernel = get("rbf")(1)
    stats = suff_stats(kernel, params["kern"],
                       ExactBatch(torch.as_tensor(X), torch.as_tensor(Y), params["Z"]),
                       backend=backend)
    got = predict(kernel, build_state(kernel, params, stats),
                  torch.as_tensor(Xt), diag=diag)
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("backend", ("jnp", "fused"))
def test_gplvm_state_predicts_like_jax_export(fitted_gplvm, backend):
    lvm, p_np, Y = fitted_gplvm
    Xt = np.linspace(-7.0, 7.0, 9)[:, None]
    want = jserve.predict(lvm.kernel, lvm.export_state(), jnp.asarray(Xt))
    params = convert.params_from_numpy(p_np, device="cpu", dtype=torch.float64)
    kernel = get("rbf")(1)
    batch = ExpectedBatch(params["q_mu"], torch.exp(params["q_logS"]),
                          torch.as_tensor(Y), params["Z"])
    stats = suff_stats(kernel, params["kern"], batch, backend=backend)
    got = predict(kernel, build_state(kernel, params, stats), torch.as_tensor(Xt))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_state_from_numpy_serves_the_exported_state(fitted_gp):
    gp, _, X, _ = fitted_gp
    st = gp.export_state()
    fields = {**st._asdict(), "stats": st.stats._asdict()}
    fields = jax.tree.map(np.asarray, fields)
    tst = convert.state_from_numpy(fields, device="cpu")
    assert tst.M == 16 and tst.D == 1 and float(tst.stats.n) == X.shape[0]
    assert tst.nbytes == sum(np.asarray(x).nbytes for x in jax.tree.leaves(st))
    want = jserve.predict(gp.kernel, st, jnp.asarray(X[:17]))
    got = predict(get("rbf")(1), tst, torch.as_tensor(X[:17]))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_convert_rejects_incomplete_inputs():
    with pytest.raises(KeyError, match="log_beta"):
        convert.params_from_numpy({"kern": {"log_variance": 0.0,
                                            "log_lengthscale": [0.0]},
                                   "Z": np.zeros((3, 1))}, device="cpu")


# ---------------------------------------------------------------------------
# torch-vs-torch server behaviours (tests/test_serve.py, ported)
# ---------------------------------------------------------------------------

def _data(seed, N, Q=2, D=3, M=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, Q))
    Y = np.sin(X.sum(1))[:, None] * np.arange(1, D + 1) + 0.05 * rng.normal(size=(N, D))
    return torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(X[:: max(N // M, 1)][:M])


def _params(Z, log_beta=2.0):
    kern = get("rbf")(Z.shape[1]).init(1.3, 0.8, device="cpu", dtype=torch.float64)
    return {"kern": kern, "Z": Z, "log_beta": torch.tensor(log_beta, dtype=torch.float64)}


def _state_from(kernel, params, X, Y, **kw):
    stats = suff_stats(kernel, params["kern"], ExactBatch(X, Y, params["Z"]), **kw)
    return build_state(kernel, params, stats)


def _assert_stats_close(a: SuffStats, b: SuffStats, rtol=1e-8, atol=1e-10):
    for x, y, name in zip(a, b, SuffStats._fields):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


def _assert_ulp_equal(a, b):
    # bucket padding must not leak into the real rows; matmuls of other
    # shapes may differ in the last ulp of the accumulated terms
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def served():
    X, Y, Z = _data(7, 300, Q=1, D=1, M=16)
    kernel = get("rbf")(1)
    return kernel, _state_from(kernel, _params(Z), X, Y), X


def test_bucketed_predict_matches_unpadded_exactly(served):
    kernel, st, X = served
    srv = GPServer(buckets=(4, 16, 64), device="cpu")
    srv.register("gp", kernel=kernel, state=st)
    for B in (1, 3, 4, 5, 16, 23, 64, 150):
        mean_u, var_u = predict(kernel, st, X[:B])
        mean_b, var_b = srv.predict("gp", X[:B])  # 150 > 64: bucket slices
        _assert_ulp_equal(mean_b, mean_u)
        _assert_ulp_equal(var_b, var_u)
        if B in srv.buckets:  # no padding at all: bit-identical
            assert torch.equal(mean_b, mean_u)
    mean_f, cov = srv.predict("gp", X[:23], diag=False)
    want_mean, want_cov = predict(kernel, st, X[:23], diag=False)
    _assert_ulp_equal(mean_f, want_mean)
    _assert_ulp_equal(cov, want_cov)
    with pytest.raises(ValueError, match="bucket"):
        srv.predict("gp", X[:150], diag=False)


def test_server_submit_round_trip_and_concurrency(served):
    kernel, st, X = served
    with GPServer(device="cpu") as srv:
        srv.register("gp", kernel=kernel, state=st)
        futs, errs = {}, []

        def client(i):
            try:
                futs[i] = srv.submit("gp", X[3 * i: 3 * i + 3])
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert not errs and len(futs) == 32
        for i, fut in futs.items():
            mean, var = fut.result(timeout=30)
            mean_u, var_u = predict(kernel, st, X[3 * i: 3 * i + 3])
            np.testing.assert_allclose(mean.numpy(), mean_u.numpy(), rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(var.numpy(), var_u.numpy(), rtol=1e-12, atol=1e-14)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit("gp", X[:1])
    with pytest.raises(KeyError, match="registered"):
        srv.predict("nope", X[:1])


def test_malformed_requests_rejected_in_caller_and_worker_survives(served):
    kernel, st, X = served
    with GPServer(device="cpu") as srv:
        srv.register("gp", kernel=kernel, state=st)
        for bad in (X[:, 0], X[0, 0], X[:0]):
            with pytest.raises(ValueError, match="batches"):
                srv.submit("gp", bad)
            with pytest.raises(ValueError, match="batches"):
                srv.predict("gp", bad)
        mean, _ = srv.submit("gp", X[:3]).result(timeout=30)
        assert torch.equal(mean, srv.predict("gp", X[:3])[0])


@pytest.mark.parametrize("backend", ("jnp", "fused"))
def test_update_matches_from_scratch_build(backend):
    n, b = 200, 57  # non-dividing split
    X, Y, Z = _data(2, n + b)
    params, kernel = _params(Z), get("rbf")(2)
    st0 = _state_from(kernel, params, X[:n], Y[:n])
    up = online.update(kernel, st0, X[n:], Y[n:], backend=backend)
    scratch = _state_from(kernel, params, X, Y)
    _assert_stats_close(up.stats, scratch.stats)
    for u, s in zip(predict(kernel, up, X[:9]), predict(kernel, scratch, X[:9])):
        np.testing.assert_allclose(u.numpy(), s.numpy(), rtol=1e-6, atol=1e-8)


def test_update_streams_and_composes():
    X, Y, Z = _data(3, 300)
    params, kernel = _params(Z), get("rbf")(2)
    st0 = _state_from(kernel, params, X[:100], Y[:100])
    one = online.update(kernel, st0, X[100:], Y[100:], chunk=64)
    two = online.update(kernel, online.update(kernel, st0, X[100:200], Y[100:200]),
                        X[200:], Y[200:])
    _assert_stats_close(one.stats, two.stats, rtol=1e-10)
    _assert_stats_close(one.stats, _state_from(kernel, params, X, Y).stats)


@pytest.mark.parametrize("via_server", (False, True))
def test_downdate_inverts_update(via_server):
    X, Y, Z = _data(4, 260)
    params, kernel = _params(Z), get("rbf")(2)
    st0 = _state_from(kernel, params, X[:200], Y[:200])
    if via_server:
        srv = GPServer(device="cpu")
        srv.register("m", kernel=kernel, state=st0)
        before = srv.predict("m", X[:9])
        srv.update("m", X[200:].numpy(), Y[200:].numpy(), backend="fused")
        assert float(srv.state("m").stats.n) == 260
        assert not torch.allclose(srv.predict("m", X[:9])[1], before[1])
        srv.downdate("m", X[200:], Y[200:], backend="fused")
        round_trip = srv.state("m")
    else:
        round_trip = online.downdate(
            kernel, online.update(kernel, st0, X[200:], Y[200:]), X[200:], Y[200:])
    _assert_stats_close(round_trip.stats, st0.stats)
    for r, s in zip(predict(kernel, round_trip, X[:9]), predict(kernel, st0, X[:9])):
        np.testing.assert_allclose(r.numpy(), s.numpy(), rtol=1e-6, atol=1e-8)


def test_downdate_guard_raises_on_indefinite_statistics():
    """Subtracting statistics that were never added drives Kuu + beta Psi2
    indefinite; the guard escalates jitter, fails to repair it, and raises
    rather than serving NaN."""
    X, Y, Z = _data(5, 120)
    params, kernel = _params(Z), get("rbf")(2)
    st = _state_from(kernel, params, X[:40], Y[:40])
    with pytest.raises(FloatingPointError, match="indefinite"):
        online.downdate(kernel, st, X, 10.0 * Y)


def _gate(srv, name):
    """Block the worker inside the named model's device call until
    `release.set()`; `started` flags that the worker has dequeued."""
    entry = srv._models[name]
    orig = dict(entry.fns)
    started, release = threading.Event(), threading.Event()

    def gated(state, X):
        started.set()
        assert release.wait(30), "test gate never released"
        return orig[True](state, X)

    entry.fns = {True: gated, False: orig[False]}
    return started, release


def test_admission_control_rejects_at_max_pending(served):
    kernel, st, X = served
    with GPServer(max_pending=2, device="cpu") as srv:
        srv.register("gp", kernel=kernel, state=st)
        started, release = _gate(srv, "gp")
        first = srv.submit("gp", X[:2])
        assert started.wait(30)
        accepted = [srv.submit("gp", X[:2]) for _ in range(2)]
        with pytest.raises(QueueFullError, match="max_pending"):
            srv.submit("gp", X[:2])
        assert srv.metrics()["rejected"] == 1
        release.set()
        for fut in (first, *accepted):
            mean, var = fut.result(timeout=30)
            assert mean.shape == (2, 1) and var.shape == (2,)


def test_expired_and_cancelled_requests_fail_only_themselves(served):
    kernel, st, X = served
    with GPServer(device="cpu") as srv:
        srv.register("gp", kernel=kernel, state=st)
        # queue by hand before the worker exists: the next submit starts it
        # and it drains all of these as one group
        expired, cancelled = Future(), Future()
        with srv._cv:
            srv._queue.append(_Request("gp", X[:2], True, expired, deadline=-1.0))
            srv._queue.append(_Request("gp", X[:2], True, cancelled))
        assert cancelled.cancel()
        live = [srv.submit("gp", X[3 * i: 3 * i + 3]) for i in range(3)]
        for i, fut in enumerate(live):
            mean, _ = fut.result(timeout=30)
            want, _ = srv.predict("gp", X[3 * i: 3 * i + 3])
            np.testing.assert_allclose(mean.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
        with pytest.raises(TimeoutError, match="deadline"):
            expired.result(timeout=30)
        assert cancelled.cancelled()
        assert srv.metrics()["expired"] == 1
        srv.submit("gp", X[:2]).result(timeout=30)  # the queue is not wedged


def test_default_timeout_applies_to_submits(served):
    kernel, st, X = served
    with GPServer(default_timeout=0.05, device="cpu") as srv:
        srv.register("gp", kernel=kernel, state=st)
        started, release = _gate(srv, "gp")
        first = srv.submit("gp", X[:2], timeout=30.0)
        assert started.wait(30)
        doomed = srv.submit("gp", X[:2])
        time.sleep(0.2)
        release.set()
        first.result(timeout=30)
        with pytest.raises(TimeoutError, match="deadline"):
            doomed.result(timeout=30)


def test_close_drains_inflight_submits_and_refuses_more(served):
    kernel, st, X = served
    srv = GPServer(device="cpu")
    srv.register("gp", kernel=kernel, state=st)
    started, release = _gate(srv, "gp")
    first = srv.submit("gp", X[:2])
    assert started.wait(30)
    queued = [srv.submit("gp", X[:3]) for _ in range(8)]
    closer = threading.Thread(target=srv.close)
    closer.start()
    release.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    for fut in (first, *queued):
        mean, _ = fut.result(timeout=30)
        assert bool(torch.isfinite(mean).all())
    srv.close()  # idempotent
    with pytest.raises(ServerClosedError, match="closed"):
        srv.submit("gp", X[:2])
    with pytest.raises(ServerClosedError, match="closed"):
        srv.register("gp2", kernel=kernel, state=st)


def test_unported_server_features_raise(served, tmp_path):
    """Every server feature is ported now: persistence and the byte budget
    (tests/test_torch_serve_persist.py) refuse only misuse, as the
    reference's do."""
    kernel, st, _ = served
    GPServer(store=tmp_path / "states", device="cpu").close()
    with pytest.raises(ValueError, match="store"):
        GPServer(budget_bytes=1 << 20, device="cpu")
    srv = GPServer(device="cpu")
    # a facade together with an explicit pair is ambiguous and refused
    with pytest.raises(ValueError, match="not both"):
        srv.register("m", object(), kernel=kernel, state=st)
    srv.register("m", kernel=kernel, state=st)
    with pytest.raises(ValueError, match="store"):
        srv.save_all()
    assert GPServer.load(tmp_path / "states", device="cpu").models() == ()
    with pytest.raises(ValueError, match="ascending"):
        GPServer(buckets=(4, 2), device="cpu")
