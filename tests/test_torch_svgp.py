"""The port's collapsed-bound epilogue (`repro_torch.core.svgp`) against
`repro.core.svgp` on the same float64 statistics, at 1e-10 relative to
max|reference|, plus the dtype-aware jitter and the NaN signal of a failed
factorization that the serving guard relies on."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import psi_stats as jps
from repro.core import svgp as jsvgp
from repro.gp import kernels as jkernels
from repro_torch.core import psi_stats as tps
from repro_torch.core import svgp as tsvgp
from repro_torch.gp import kernels as tkernels

RTOL = 1e-10


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) / scale


@pytest.fixture(scope="module")
def problem():
    """Statistics of 120 points (M=12, Q=2, D=3) computed by the reference,
    handed to both packages as the same float64 arrays."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(120, 2))
    Y = np.sin(X.sum(1))[:, None] * np.arange(1, 4) + 0.05 * rng.normal(size=(120, 3))
    Z = X[::10][:12]
    kern = {"log_variance": np.log(1.3), "log_lengthscale": np.log([0.8, 1.1])}
    jk = {k: jnp.asarray(v) for k, v in kern.items()}
    jstats = jps.exact_stats_rbf(jk, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z))
    Kuu = jkernels.get("rbf")(2).K(jk, jnp.asarray(Z))
    beta = np.exp(2.0)
    tstats = tps.SuffStats(*(torch.as_tensor(np.array(s)) for s in jstats))
    tk = {k: torch.as_tensor(v) for k, v in kern.items()}
    Xt = rng.normal(size=(9, 2))
    return {
        "jax": (Kuu, jstats, jnp.asarray(beta), jnp.asarray(Xt), jk, jnp.asarray(Z)),
        "torch": (torch.as_tensor(np.array(Kuu)), tstats,
                  torch.as_tensor(beta), torch.as_tensor(Xt), tk,
                  torch.as_tensor(Z)),
    }


def test_posterior_factors_match_jax(problem):
    Kj, sj, bj, *_ = problem["jax"]
    Kt, st, bt, *_ = problem["torch"]
    want = jsvgp.posterior_factors(Kj, sj, bj)
    got = tsvgp.posterior_factors(Kt, st, bt)
    for g, w, name in zip(got, want, ("L", "LA", "c")):
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("term", jsvgp.BoundTerms._fields)
def test_collapsed_bound_terms_match_jax(problem, term):
    Kj, sj, bj, *_ = problem["jax"]
    Kt, st, bt, *_ = problem["torch"]
    want = getattr(jsvgp.collapsed_bound(Kj, sj, bj, 3), term)
    got = getattr(tsvgp.collapsed_bound(Kt, st, bt, 3), term)
    assert _rel(got, want) <= RTOL


def test_optimal_qu_matches_jax(problem):
    Kj, sj, bj, *_ = problem["jax"]
    Kt, st, bt, *_ = problem["torch"]
    want = jsvgp.optimal_qu(jsvgp.posterior_factors(Kj, sj, bj), bj)
    got = tsvgp.optimal_qu(tsvgp.posterior_factors(Kt, st, bt), bt)
    for g, w, name in zip(got, want, jsvgp.Posterior._fields):
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("full", (False, True))
def test_predict_matches_jax(problem, full):
    Kj, sj, bj, Xj, kj, Zj = problem["jax"]
    Kt, st, bt, Xt, kt, Zt = problem["torch"]
    jr, tr = jkernels.get("rbf")(2), tkernels.get("rbf")(2)
    post_j = jsvgp.optimal_qu(jsvgp.posterior_factors(Kj, sj, bj), bj)
    post_t = tsvgp.optimal_qu(tsvgp.posterior_factors(Kt, st, bt), bt)
    Ksu_j, Ksu_t = jr.K(kj, Xj, Zj), tr.K(kt, Xt, Zt)
    if full:
        want = jsvgp.predict_f_full(post_j, Ksu_j, jr.K(kj, Xj))
        got = tsvgp.predict_f_full(post_t, Ksu_t, tr.K(kt, Xt))
    else:
        want = jsvgp.predict_f(post_j, Ksu_j, jr.Kdiag(kj, Xj))
        got = tsvgp.predict_f(post_t, Ksu_t, tr.Kdiag(kt, Xt))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_float32_jitter_is_boosted_100x(problem):
    Kt = problem["torch"][0]
    j64 = tsvgp._jitter_eff(Kt, 1e-6)
    j32 = tsvgp._jitter_eff(Kt.float(), 1e-6)
    assert float(j32) == pytest.approx(100.0 * float(j64), rel=1e-6)
    # and the same as the reference's in each dtype
    Kj = problem["jax"][0]
    assert float(j64) == pytest.approx(float(jsvgp._jitter_eff(Kj, 1e-6)), rel=1e-12)
    assert float(j32) == pytest.approx(
        float(jsvgp._jitter_eff(Kj.astype(jnp.float32), 1e-6)), rel=1e-6)


def test_float32_epilogue_matches_jax_float32(problem):
    """In float32 both packages boost the jitter alike, so their bounds
    agree to float32 roundoff (not to the float64 bound: the jitter moves
    the model)."""
    Kj, sj, bj, *_ = problem["jax"]
    Kt, st, bt, *_ = problem["torch"]
    want = jsvgp.collapsed_bound(Kj.astype(jnp.float32),
                                 jps.SuffStats(*(s.astype(jnp.float32) for s in sj)),
                                 bj.astype(jnp.float32), 3)
    got = tsvgp.collapsed_bound(Kt.float(), tps.SuffStats(*(s.float() for s in st)),
                                bt.float(), 3)
    assert got.bound.dtype == torch.float32
    assert bool(torch.isfinite(got.LA).all())
    assert _rel(got.bound, want.bound) <= 1e-5


def test_failed_factorization_is_nan_like_the_reference(problem):
    Kt, st, bt, *_ = problem["torch"]
    bad = st._replace(psi2=-10.0 * st.psi2)  # drives Kuu + beta Psi2 indefinite
    LA = tsvgp.posterior_factors(Kt, bad, bt).LA
    assert bool(torch.isnan(LA).all())
    Kj, sj, bj, *_ = problem["jax"]
    LAj = jsvgp.posterior_factors(Kj, sj._replace(psi2=-10.0 * sj.psi2), bj).LA
    assert bool(jnp.isnan(LAj).any())
