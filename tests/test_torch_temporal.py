"""The port's temporal backend (`repro_torch.temporal`) against the JAX
reference (`repro.temporal`) on the same float64 series, drawn with numpy.

Oracles and tolerances (float64):
* the SDEs (F, H, Pinf, Qc, L) 1e-12 relative; k(tau) = H expm(F tau)
  Pinf H^T reproduces `Kernel.K` to 1e-9 (the reference's own bar);
* `discretize`: `torch.linalg.matrix_exp` is not JAX's Pade `expm`; A
  within 1e-12 of max|A| and Q within 1e-12 of max|Pinf| (observed:
  <= 2e-15 and <= 2e-15);
* `associative_scan` runs `jax.lax.associative_scan`'s recursion: a
  float32 sum (rounding depends on the bracketing) comes out bit for bit;
* filters and smoothers: the port's parallel and sequential paths against
  each other and against the reference's parallel and sequential paths,
  1e-10 absolute (the reference's own bar for parallel vs sequential);
* the lml against the dense O(N^3) `exact_gp_log_marginal`, 1e-8 relative
  (1e-7 for Matern-1/2, whose dense diagonal carries the expanded form's
  ~1e-8, see tests/test_torch_kernel_family.py);
* a 3-step fit against the reference's 1e-5 (Adam rounds to float32 in
  both packages), predictions 1e-10 against the reference's at the same
  parameters, and 1e-6 against the dense GP;
* the streamed state against a one-shot sequential filter over the
  concatenated series, 1e-10: `update` is the sequential filter carried on
  from the stored state, by definition.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import temporal as jt
from repro.core.svgp import exact_gp_log_marginal as j_exact_lml
from repro.gp import kernels as jk
from repro.temporal import pskf as jpskf
from repro_torch import convert, serve
from repro_torch.core.svgp import exact_gp_log_marginal
from repro_torch.gp import kernels as tk
from repro_torch.gp import regression
from repro_torch.serve import GPServer, online
from repro_torch.temporal import (TemporalGPRegression, TemporalState,
                                  discretize, forecast, kalman_filter,
                                  rts_smoother, update_state)
from repro_torch.temporal import pskf

TOL = 1e-10


def _rel(got, want) -> float:
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _abs(got, want) -> float:
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    return float(np.abs(got - np.asarray(want, np.float64)).max())


def _matern(var, ls):
    return {"log_variance": np.log(var), "log_lengthscale": np.full(1, np.log(ls))}


SDE_CASES = {
    "matern12": ("matern12", _matern(1.3, 0.7)),
    "matern32": ("matern32", _matern(0.8, 1.4)),
    "matern52": ("matern52", _matern(2.1, 0.5)),
    "sum": (("sum", "matern32", "matern12"),
            {"k0": _matern(0.9, 1.1), "k1": _matern(0.4, 2.3)}),
    "product": (("product", "matern32", "matern52"),
                {"k0": _matern(1.2, 0.9), "k1": _matern(0.7, 1.6)}),
}


def _pair(spec):
    if isinstance(spec, str):
        return tk.get(spec)(1), jk.get(spec)(1)
    name, *parts = spec
    pairs = [_pair(p) for p in parts]
    return (tk.get(name)(*(t for t, _ in pairs)),
            jk.get(name)(*(j for _, j in pairs)))


def _t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.asarray(a, np.float64)), tree)


def _j(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _series(n, d_out=1, seed=0, lo=0.0, hi=10.0):
    """Non-uniform timestamps and smooth noisy outputs (the reference
    tests' series, from numpy)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(lo, hi, n))
    f = np.stack([np.sin((k + 1) * t) for k in range(d_out)], axis=1)
    return t, f + 0.1 * rng.standard_normal((n, d_out))


def _gaps(t):
    return np.concatenate([[0.0], np.diff(t)])


# ---------------------------------------------------------------------------
# kernel <-> SDE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SDE_CASES, ids=str)
def test_sde_matches_the_reference_and_reproduces_K(case):
    spec, params = SDE_CASES[case]
    tkern, jkern = _pair(spec)
    got, want = tkern.to_sde(_t(params)), jkern.to_sde(_j(params))
    for name in ("F", "H", "Pinf", "Qc"):
        assert _rel(getattr(got, name), getattr(want, name)) <= 1e-12, name
    assert (got.L is None) == (want.L is None)
    if want.L is not None:
        assert _rel(got.L, want.L) <= 1e-12
    assert got.d == want.d
    # stationarity: F Pinf + Pinf F^T + Qc = 0
    resid = got.F @ got.Pinf + got.Pinf @ got.F.T + got.Qc
    assert float(resid.abs().max()) <= 1e-10
    taus = [0.0, 0.05, 0.3, 1.0, 2.7, 6.0]
    k_sde = [float(got.H @ torch.linalg.matrix_exp(got.F * tau) @ got.Pinf @ got.H)
             for tau in taus]
    X = torch.zeros(1, 1, dtype=torch.float64)
    k_ref = [float(tkern.K(_t(params), X, X + tau)[0, 0]) for tau in taus]
    np.testing.assert_allclose(k_sde, k_ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", SDE_CASES, ids=str)
def test_discretize_matches_the_reference(case):
    spec, params = SDE_CASES[case]
    tkern, jkern = _pair(spec)
    dt = np.concatenate([[0.0, 1e-9, 1e-4, 0.02, 0.5, 3.0, 40.0],
                         np.random.default_rng(1).uniform(0, 2, 25)])
    model = tkern.to_sde(_t(params))
    A, Q = discretize(model, torch.as_tensor(dt))
    jA, jQ = jt.discretize(jkern.to_sde(_j(params)), jnp.asarray(dt))
    assert A.dtype == Q.dtype == torch.float64
    assert _rel(A, jA) <= 1e-12
    assert _abs(Q, jQ) <= 1e-12 * float(model.Pinf.abs().max())
    assert float((A[0] - torch.eye(model.d, dtype=A.dtype)).abs().max()) <= 1e-14
    assert float(Q[0].abs().max()) <= 1e-14
    for k in range(len(dt)):  # Q_k = Pinf - A Pinf A^T is PSD
        assert float(torch.linalg.eigvalsh(Q[k]).min()) > -1e-10
    # float32 hyperparameters with float64 gaps: promoted before the
    # arithmetic, as the reference does
    p32 = jax.tree.map(lambda a: torch.as_tensor(np.asarray(a, np.float32)), params)
    A32, Q32 = discretize(tkern.to_sde(p32), torch.as_tensor(dt))
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    jA32, jQ32 = jt.discretize(jkern.to_sde(jp32), jnp.asarray(dt))
    assert A32.dtype == torch.float64 and jA32.dtype == jnp.float64
    # the same float32 model in float64: the promotion comes first, bit for bit
    m32 = tkern.to_sde(p32)
    A64, _ = discretize(m32._replace(F=m32.F.double(), Pinf=m32.Pinf.double()),
                        torch.as_tensor(dt))
    assert torch.equal(A32, A64)
    # the two libraries' float32 exp may round the hyperparameters apart by
    # an ulp, so against the reference: float32's 1e-6
    assert _rel(A32, jA32) <= 1e-6


def test_capabilities_and_sde_errors():
    assert tk.capabilities("matern32") == {"exact": True, "psi": False, "sde": True}
    assert tk.capabilities("matern52", input_dim=2)["sde"] is False
    assert tk.capabilities(tk.Sum(tk.Matern32(1), tk.RBF(1)))["sde"] is False
    with pytest.raises(NotImplementedError, match="1-D"):
        tk.Matern32(3).to_sde(tk.Matern32(3).init(device="cpu"))
    with pytest.raises(NotImplementedError, match="matern"):
        tk.RBF(1).to_sde(tk.RBF(1).init(device="cpu"))
    with pytest.raises(NotImplementedError, match="temporal"):
        tk.Matern32(1).psi0(tk.Matern32(1).init(device="cpu"),
                            torch.zeros(4, 1), torch.ones(4, 1))


# ---------------------------------------------------------------------------
# the associative scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", (False, True))
def test_associative_scan_brackets_like_jax(reverse):
    """Float32 sums round by their bracketing: the same bits as
    `jax.lax.associative_scan` means the same recursion, at every length
    (odd and even levels)."""
    rng = np.random.default_rng(2)
    for n in (1, 2, 3, 5, 8, 13, 64, 100, 257):
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-4, 5, n)).astype(np.float32)
        y = rng.standard_normal((n, 2)).astype(np.float32)
        got = pskf.associative_scan(lambda a, b: [a[0] + b[0], a[1] * 0.5 + b[1]],
                                    [torch.as_tensor(x), torch.as_tensor(y)],
                                    reverse=reverse)
        want = jax.lax.associative_scan(lambda a, b: [a[0] + b[0], a[1] * 0.5 + b[1]],
                                        [jnp.asarray(x), jnp.asarray(y)],
                                        reverse=reverse)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_associative_scan_composes_non_commuting_elements_in_order():
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.standard_normal((11, 3, 3)))
    (prefix,) = pskf.associative_scan(lambda a, b: [b[0] @ a[0]], [M])
    (suffix,) = pskf.associative_scan(lambda a, b: [b[0] @ a[0]], [M], reverse=True)
    want_p, want_s = [M[0]], [M[-1]]
    for k in range(1, 11):
        want_p.append(M[k] @ want_p[-1])
        want_s.append(M[10 - k] @ want_s[-1])
    assert _rel(prefix, torch.stack(want_p).numpy()) <= 1e-13
    assert _rel(suffix, torch.stack(want_s[::-1]).numpy()) <= 1e-13


# ---------------------------------------------------------------------------
# filters and smoothers
# ---------------------------------------------------------------------------

def _filter_inputs(case, n, d_out, masked, seed):
    spec, params = SDE_CASES[case]
    tkern, jkern = _pair(spec)
    t, y = _series(n, d_out=d_out, seed=seed)
    tm, jm = tkern.to_sde(_t(params)), jkern.to_sde(_j(params))
    A, Q = discretize(tm, torch.as_tensor(_gaps(t)))
    jA, jQ = jt.discretize(jm, jnp.asarray(_gaps(t)))
    mask = None
    if masked:
        mask = np.random.default_rng(0).uniform(size=n) < 0.7
    return (tm, A, Q, jm, jA, jQ, y, mask)


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("d_out", (1, 3))
@pytest.mark.parametrize("case", ("matern52", "sum", "product"))
def test_filters_and_smoothers_match_each_other_and_the_reference(case, d_out, masked):
    tm, A, Q, jm, jA, jQ, y, mask = _filter_inputs(case, 257, d_out, masked, seed=3)
    R = 0.01
    out = {}
    for parallel in (True, False):
        res = kalman_filter(A, Q, tm.H, torch.tensor(R, dtype=torch.float64),
                            torch.as_tensor(y), torch.zeros(tm.d, d_out, dtype=torch.float64),
                            tm.Pinf, mask=None if mask is None else torch.as_tensor(mask),
                            parallel=parallel)
        jres = jt.kalman_filter(jA, jQ, jm.H, jnp.asarray(R), jnp.asarray(y),
                                jnp.zeros((jm.d, d_out)), jm.Pinf,
                                mask=None if mask is None else jnp.asarray(mask),
                                parallel=parallel)
        sm = rts_smoother(A, Q, res.means, res.covs, parallel=parallel)
        jsm = jt.rts_smoother(jA, jQ, jres.means, jres.covs, parallel=parallel)
        # each path against the reference's same path
        for g, w in ((res.means, jres.means), (res.covs, jres.covs),
                     (sm[0], jsm[0]), (sm[1], jsm[1])):
            assert _abs(g, w) <= TOL
        assert _abs(res.lml, jres.lml) <= TOL * max(1.0, abs(float(jres.lml)))
        out[parallel] = (res, sm)
    (par, spar), (seq, sseq) = out[True], out[False]
    for g, w in ((par.means, seq.means), (par.covs, seq.covs), (spar[0], sseq[0]),
                 (spar[1], sseq[1])):
        assert _abs(g, w) <= TOL
    assert _abs(par.lml, seq.lml) <= TOL * max(1.0, abs(float(seq.lml)))


@pytest.mark.parametrize("parallel", (True, False))
@pytest.mark.parametrize("case", SDE_CASES, ids=str)
def test_lml_matches_the_dense_marginal(case, parallel):
    spec, params = SDE_CASES[case]
    tkern, _ = _pair(spec)
    t, y = _series(129, seed=5)
    beta = torch.tensor(25.0, dtype=torch.float64)
    model = tkern.to_sde(_t(params))
    A, Q = discretize(model, torch.as_tensor(_gaps(t)))
    res = kalman_filter(A, Q, model.H, 1.0 / beta, torch.as_tensor(y),
                        torch.zeros(model.d, 1, dtype=torch.float64), model.Pinf,
                        parallel=parallel)
    Kff = tkern.K(_t(params), torch.as_tensor(t)[:, None])
    dense = exact_gp_log_marginal(Kff, torch.as_tensor(y), beta, jitter=0.0)
    tol = 1e-7 if "matern12" in str(spec) else 1e-8
    assert abs(float(res.lml) - float(dense)) <= tol * abs(float(dense))
    jdense = j_exact_lml(jnp.asarray(Kff.numpy()), jnp.asarray(y), jnp.asarray(25.0),
                         jitter=0.0)
    assert abs(float(dense) - float(jdense)) <= TOL * abs(float(jdense))


def test_autograd_saves_o_n_state_not_o_n2():
    """What the parallel loss saves for its backward pass grows linearly
    in N (O(N d^2)), and no saved tensor reaches N^2 elements."""
    saved = {}
    for n in (512, 2048):
        t, y = _series(n, seed=6, hi=n / 50)
        m = TemporalGPRegression(tk.Matern52(1), device="cpu")
        params = m.init_params(t[:, None])
        params = jax.tree.map(lambda p: p.detach().double().requires_grad_(True), params)
        sizes = []

        def pack(x):
            sizes.append(x.numel())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss = m._loss(params, torch.as_tensor(t), torch.as_tensor(y))
        loss.backward()
        assert max(sizes) < n * n / 8
        saved[n] = sum(sizes)
    assert saved[2048] / saved[512] < 4 * 1.25


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def _fit_pair(n=300, steps=3, seed=7, kernel="matern32", parallel=True):
    tkern, jkern = _pair(kernel)
    t, y = _series(n, seed=seed)
    p_np = {"kern": {"log_variance": np.log(0.9), "log_lengthscale": np.log([0.8])},
            "log_beta": np.float64(2.0)}
    jm = jt.TemporalGPRegression(jkern, parallel=parallel).fit(
        jnp.asarray(t)[:, None], jnp.asarray(y), steps=steps, lr=5e-2, log_every=1,
        params=_j(p_np))
    tm = TemporalGPRegression(tkern, parallel=parallel, device="cpu").fit(
        t[:, None], y, steps=steps, lr=5e-2, log_every=1,
        params=convert.params_from_numpy(p_np, device="cpu"))
    return t, y, tm, jm


@pytest.fixture(scope="module")
def fitted():
    """One fit of each package on the parallel path, shared (the
    reference's jit of the parallel loss dominates these tests' time)."""
    return _fit_pair(n=256, steps=3)


@pytest.mark.parametrize("parallel", (True, False))
def test_three_step_fit_matches_the_reference(parallel, fitted):
    t, y, tm, jm = fitted if parallel else _fit_pair(n=256, parallel=False)
    assert len(tm.history) == 3
    np.testing.assert_allclose(tm.history, jm.history, rtol=1e-5)
    for g, w in zip(jax.tree.leaves(tm.params), jax.tree.leaves(jm.params)):
        assert _rel(g, w) <= 1e-5
    assert tm.history[-1] < tm.history[0]
    assert abs(tm.lml() - jm.lml()) <= 1e-5 * abs(jm.lml())
    assert tm.elbo() == tm.lml()


def test_predict_and_posterior_match_the_reference_and_the_dense_gp(fitted):
    t, y, tm, _ = fitted
    p_np = jax.tree.map(lambda a: a.detach().numpy(), tm.params)
    jm = jt.TemporalGPRegression(jk.Matern32(1))
    jm.params, jm._data = _j(p_np), (jnp.asarray(t), jnp.asarray(y))
    rng = np.random.default_rng(8)
    Xt = np.concatenate([rng.uniform(-0.5, 10.5, 40), t[[3, 100]]])[:, None]  # unsorted
    got, want = tm.predict(Xt), jm.predict(jnp.asarray(Xt))
    for g, w in zip(got, want):
        assert _abs(g, w) <= TOL
    for par in (False,):
        for g, w in zip(tm.predict(Xt, parallel=par), got):
            assert _abs(g, w) <= TOL
    for g, w in zip(tm.posterior(), jm.posterior()):
        assert _abs(g, w) <= TOL
    # the dense GP at the fitted parameters
    kern, p = tm.kernel, tm.params["kern"]
    X = torch.as_tensor(t)[:, None]
    beta = float(torch.exp(tm.params["log_beta"]))
    Kff = kern.K(p, X).double()
    Kxt = kern.K(p, X, torch.as_tensor(Xt)).double()
    Afac = Kff + torch.eye(len(t), dtype=torch.float64) / beta
    mean_d = Kxt.T @ torch.linalg.solve(Afac, torch.as_tensor(y))
    var_d = kern.Kdiag(p, torch.as_tensor(Xt)).double() - (
        Kxt * torch.linalg.solve(Afac, Kxt)).sum(0)
    assert _abs(got[0], mean_d) <= 1e-6
    assert _abs(got[1], var_d) <= 1e-6


def test_dispatch_and_validation_fail_as_the_reference():
    t, y = _series(64)
    X, Y = t[:, None], y[:, 0]
    m = regression(tk.Matern32(1), backend="temporal", device="cpu")
    assert isinstance(m, TemporalGPRegression)
    jm = jt.TemporalGPRegression(jk.Matern32(1))
    bad = [((X[::-1], Y), ValueError), ((np.concatenate([X[:1], X]),
                                         np.concatenate([Y[:1], Y])), ValueError),
           ((np.zeros((8, 2)), Y[:8]), ValueError), ((X, Y[:-3]), ValueError)]
    for args, exc in bad:
        with pytest.raises(exc) as et:
            m.fit(*args)
        with pytest.raises(exc) as ej:
            jm.fit(*(jnp.asarray(a) for a in args))
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as et:
        regression(tk.RBF(1), backend="temporal", device="cpu")
    with pytest.raises(ValueError) as ej:
        jt.TemporalGPRegression(jk.RBF(1))
    assert str(et.value) == str(ej.value)
    with pytest.raises(RuntimeError, match="not fitted"):
        m.predict(X)
    with pytest.raises(ValueError, match="optimizer"):
        m.fit(X, Y, optimizer="sgd")
    m.fit(X, Y, steps=2)
    assert m.predict(X[:4])[0].shape == (4, 1)
    m.fit(X, Y, optimizer="lbfgs", steps=3)  # the L-BFGS path drives too
    assert len(m.history) == 1 and np.isfinite(m.history[0])


# ---------------------------------------------------------------------------
# streaming and serving
# ---------------------------------------------------------------------------

def _one_shot_sequential(kern, params, t, y):
    model = kern.to_sde(params["kern"])
    A, Q = discretize(model, torch.as_tensor(_gaps(t)))
    return kalman_filter(A, Q, model.H, torch.exp(-params["log_beta"]),
                         torch.as_tensor(y),
                         torch.zeros(model.d, y.shape[1], dtype=torch.float64),
                         model.Pinf, parallel=False)


@pytest.mark.parametrize("case", ("matern52", "sum"))
def test_streamed_update_equals_a_one_shot_sequential_filter(case):
    spec, params = SDE_CASES[case]
    kern, _ = _pair(spec)
    t, y = _series(300, seed=11)
    p = {"kern": _t(params), "log_beta": torch.tensor(3.0, dtype=torch.float64)}
    first = TemporalGPRegression(kern, parallel=False, device="cpu")
    first.fit(t[:100, None], y[:100], steps=0, params=p)
    st = first.export_state()
    # the rest in two uneven chunks, through the serving layer's entry
    st = online.update(kern, st, t[100:230, None], y[100:230])
    st = update_state(kern, st, t[230:, None], y[230:])
    full = _one_shot_sequential(kern, p, t, y)
    assert _abs(st.m, full.means[-1]) <= TOL
    assert _abs(st.P, full.covs[-1]) <= TOL
    assert float(st.t_last) == t[-1] and float(st.n) == 300
    with pytest.raises(ValueError, match="strictly after"):
        update_state(kern, st, t[:5, None], y[:5])
    with pytest.raises(ValueError, match="output column"):
        update_state(kern, st, t[-1:, None] + 1.0, np.zeros((1, 3)))
    with pytest.raises(ValueError, match="sorted ascending"):
        update_state(kern, st, t[::-1, None] + 20.0, y)


def test_state_and_forecast_match_the_reference(fitted):
    t, y, tm, jm = fitted
    jstate = jm.export_state()
    fields = jax.tree.map(np.asarray, jstate._asdict())
    tstate = convert.temporal_state_from_numpy(fields, device="cpu")
    own = tm.export_state()
    for name in TemporalState._fields:
        for g, w in zip(jax.tree.leaves(getattr(own, name)),
                        jax.tree.leaves(getattr(jstate, name))):
            assert _rel(g, w) <= 1e-5, name  # fitted in both packages
    assert tstate.nbytes == jstate.nbytes and tstate.d == 2 and tstate.D == 1
    Xf = np.linspace(9.0, 12.0, 9)[:, None]  # past the origin and before it
    got, want = forecast(tm.kernel, tstate, Xf), jt.forecast(jm.kernel, jstate,
                                                             jnp.asarray(Xf))
    for g, w in zip(got, want):
        assert _abs(g, w) <= TOL
    # update from the reference's state equals the reference's update
    new_t = t[-1] + np.cumsum(np.full(20, 0.03))
    new_y = np.sin(new_t)[:, None]
    got = update_state(tm.kernel, tstate, new_t[:, None], new_y)
    want = jt.update_state(jm.kernel, jstate, jnp.asarray(new_t)[:, None],
                           jnp.asarray(new_y))
    assert _abs(got.m, want.m) <= TOL and _abs(got.P, want.P) <= TOL
    assert float(got.n) == float(want.n) == 276


def test_server_serves_and_streams_a_temporal_model(fitted):
    t, y, tm, _ = fitted
    with GPServer(device="cpu") as srv:
        srv.register("ts", tm)
        Xf = np.linspace(10.2, 12.0, 9)[:, None]
        fm, fv = forecast(tm.kernel, tm.export_state(), Xf)
        mean, var = srv.predict("ts", Xf)
        assert torch.equal(mean, fm) and torch.equal(var, fv)
        pm, pv = serve.predict(tm.kernel, tm.export_state(), torch.as_tensor(Xf))
        assert torch.equal(pm, fm) and torch.equal(pv, fv)
        with pytest.raises(ValueError, match="diag=False"):
            srv.predict("ts", Xf, diag=False)
        with pytest.raises(ValueError, match="diag=False"):
            serve.predict(tm.kernel, tm.export_state(), torch.as_tensor(Xf), diag=False)
        # coalesced submits, and a diag=False request fails on its own future
        futs = [srv.submit("ts", Xf[i:i + 3]) for i in range(0, 9, 3)]
        bad = srv.submit("ts", Xf[:2], diag=False)
        for i, f in enumerate(futs):
            m, v = f.result(timeout=30)
            assert _abs(m, fm[3 * i:3 * i + 3]) <= 1e-14
        with pytest.raises(ValueError, match="diag=False"):
            bad.result(timeout=30)
        # B = 1 and an oversized batch through the buckets
        big = np.linspace(10.0, 20.0, 300)[:, None]
        bm, _ = srv.predict("ts", big)
        assert _abs(bm, forecast(tm.kernel, tm.export_state(), big)[0]) <= 1e-14
        assert srv.predict("ts", Xf[:1])[0].shape == (1, 1)
        # update filters forward, as update_state does
        new_t = t[-1] + np.cumsum(np.full(25, 0.05))
        new_y = np.cos(new_t)[:, None]
        want = update_state(tm.kernel, tm.export_state(), new_t[:, None], new_y)
        srv.update("ts", new_t[:, None], new_y)
        st = srv.state("ts")
        assert torch.equal(st.m, want.m) and torch.equal(st.P, want.P)
        assert float(st.n) == 281
        with pytest.raises(TypeError, match="downdate"):
            srv.downdate("ts", new_t[:, None], new_y)
        with pytest.raises(TypeError, match="refit"):
            srv.refit("ts")
        assert srv.metrics()["registered"] == 1


def test_entry_points_take_the_device():
    t, y = _series(40)
    m = TemporalGPRegression(device="cpu").fit(t, y, steps=1)
    assert m.params["log_beta"].device.type == "cpu"
    assert isinstance(m.kernel, tk.Matern32)
    state = m.export_state()
    assert state.m.shape == (2, 1) and state.P.shape == (2, 2)
    assert state.nbytes == sum(x.numel() * x.element_size()
                               for x in jax.tree.leaves(tuple(state)))
