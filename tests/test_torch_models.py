"""The port's training path on the CPU against the JAX reference:
`core.gplvm` (init, loss and its gradients), the `SparseGPRegression` and
`BayesianGPLVM` facades (five Adam steps on backend="fused"), and a fitted
facade served by `GPServer` and touched up with `refit`.

Inputs are made with numpy from seeds; parameters cross between the
packages as numpy arrays (`convert.params_from_numpy` keeps each array's
own dtype). Inducing points sit on a grid about a lengthscale apart, so
cond(Kuu) stays small and the tolerances measure the port.

Tolerances, and why:
* float64 parameters: loss 1e-10 and gradients 1e-8 relative to
  max|reference| (the reference's own gradient tests use 1e-8).
* The reference's mixed dtypes (float32 kernel, noise and q_logS leaves):
  the plain ("jnp") statistics then compute partly in float32, where two
  libraries round differently, so float32 gradients are held to 1e-4.
* Fits: Adam rounds each parameter to float32 before its step, so two
  correct implementations whose gradients differ in their last bits can
  land one float32 ulp apart (the reference's jitted step fuses its float32
  arithmetic), and Adam's sign-like first steps carry such a difference on:
  losses to 1e-5 and parameters to 1e-5 relative (measured: 1.1e-6 on the
  GP-LVM loss after five steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import gplvm as jgplvm
from repro.gp import BayesianGPLVM as JBayesianGPLVM
from repro.gp import SparseGPRegression as JSparseGPRegression
from repro.gp import get as jget
from repro_torch import convert
from repro_torch.core import gplvm
from repro_torch.gp import BayesianGPLVM, SparseGPRegression, get, regression
from repro_torch.optim.adam import flatten
from repro_torch.serve import GPServer, online

M, STEPS = 8, 5
FIT_TOL = {"loss": 1e-5, "params": 1e-5}


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _lvm_data(N=64, seed=0):
    rng = np.random.default_rng(seed)
    t = 2.0 * rng.normal(size=(N, 1))
    return np.hstack([np.sin(t), np.cos(t), 0.3 * t]) + 0.05 * rng.normal(size=(N, 3))


def _lvm_params(Y, *, f64=False):
    """The reference's init (PCA means, its dtypes), with Z on a grid."""
    p = jax.tree.map(np.asarray, jgplvm.init_params(jax.random.PRNGKey(0),
                                                    jnp.asarray(Y), 1, M))
    p["Z"] = np.linspace(-2.5, 2.5, M)[:, None]
    return jax.tree.map(lambda a: a.astype(np.float64), p) if f64 else p


def _sgpr_data(N=64, seed=1):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-4.0, 4.0, (N, 1)), axis=0)
    return X, np.sin(X) + 0.1 * rng.normal(size=(N, 1))


def _assert_params_close(got: dict, want, tol: float):
    paths, leaves = flatten(got)
    for path, g, w in zip(paths, leaves, jax.tree.leaves(want)):
        assert str(g.dtype).removeprefix("torch.") == np.asarray(w).dtype.name, path
        assert _rel(g, w) <= tol, path


# ---------------------------------------------------------------------------
# core.gplvm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", ("float64", "mixed"))
@pytest.mark.parametrize("backend", ("fused", "jnp"))
def test_gplvm_loss_and_grads_match_jax(backend, dtypes):
    Y = _lvm_data()
    p_np = _lvm_params(Y, f64=dtypes == "float64")
    want, want_g = jax.value_and_grad(lambda p: jgplvm.loss(
        p, jnp.asarray(Y), kernel=jget("rbf")(1), backend=backend))(
        jax.tree.map(jnp.asarray, p_np))
    params = convert.params_from_numpy(p_np, device="cpu")
    paths, leaves = flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = gplvm.loss(params, torch.as_tensor(Y), backend=backend)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel(loss, want) <= 1e-10
    for path, g, leaf, w in zip(paths, grads, leaves, jax.tree.leaves(want_g)):
        assert g.dtype == leaf.dtype, path
        assert _rel(g, w) <= (1e-8 if g.dtype == torch.float64 else 1e-4), path


def test_init_params_matches_jax_up_to_column_signs():
    Y = _lvm_data(N=40)
    want = jgplvm.init_params(jax.random.PRNGKey(0), jnp.asarray(Y), 2, M)
    got = gplvm.init_params(torch.Generator().manual_seed(0), torch.as_tensor(Y),
                            2, M)
    for key in ("log_beta", "q_logS"):
        assert got[key].dtype == torch.float32
        assert _rel(got[key], want[key]) <= 1e-7
    assert {k: v.dtype for k, v in got["kern"].items()} == {
        "log_variance": torch.float32, "log_lengthscale": torch.float32}
    q_mu, want_mu = got["q_mu"].numpy(), np.asarray(want["q_mu"])
    signs = np.sign(np.sum(q_mu * want_mu, axis=0))
    assert np.max(np.abs(q_mu * signs - want_mu)) <= 1e-10 * np.max(np.abs(want_mu))
    # Z: M distinct rows of the latent means (drawn by another generator)
    Z = got["Z"].numpy()
    assert Z.shape == (M, 2)
    rows = [int(np.argmin(np.abs(q_mu - z).sum(1))) for z in Z]
    assert len(set(rows)) == M
    assert all(np.array_equal(q_mu[i], z) for i, z in zip(rows, Z))


# ---------------------------------------------------------------------------
# the facades
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted_pair():
    """Both packages' GP-LVMs fitted five steps from the same parameters."""
    Y = _lvm_data()
    p_np = _lvm_params(Y)
    jm = JBayesianGPLVM(kernel=jget("rbf")(1), M=M, backend="fused").fit(
        jnp.asarray(Y), steps=STEPS, params=jax.tree.map(jnp.asarray, p_np))
    tm = BayesianGPLVM(M=M, backend="fused", device="cpu").fit(
        Y, steps=STEPS, params=convert.params_from_numpy(p_np, device="cpu"))
    return jm, tm


def _fit_both(model_cls, jmodel_cls, data, params_np):
    """Both packages' facades fitted STEPS Adam steps from the same
    parameters, logging every step's loss."""
    jm = jmodel_cls(kernel=jget("rbf")(1), M=M, backend="fused").fit(
        *map(jnp.asarray, data), steps=STEPS, log_every=1,
        params=jax.tree.map(jnp.asarray, params_np))
    tm = model_cls(M=M, backend="fused", device="cpu").fit(
        *data, steps=STEPS, log_every=1,
        params=convert.params_from_numpy(params_np, device="cpu"))
    return jm, tm, jm.history, tm.history


@pytest.mark.parametrize("model", ("gplvm", "sgpr"))
def test_facade_fit_matches_jax(model):
    if model == "gplvm":
        Y = _lvm_data()
        jm, tm, jh, th = _fit_both(BayesianGPLVM, JBayesianGPLVM, (Y,),
                                   _lvm_params(Y))
    else:
        X, Y = _sgpr_data()
        p_np = {"kern": {"log_variance": np.float32(0.0),
                         "log_lengthscale": np.zeros(1, np.float32)},
                "Z": np.linspace(-3.5, 3.5, M)[:, None], "log_beta": np.float64(2.0)}
        jm, tm, jh, th = _fit_both(SparseGPRegression, JSparseGPRegression,
                                   (X, Y), p_np)
    assert len(th) == len(jh) == STEPS
    assert th[-1] < th[0]
    np.testing.assert_allclose(th, jh, rtol=FIT_TOL["loss"])
    _assert_params_close(tm.params, jm.params, FIT_TOL["params"])
    Xt = np.linspace(-3.0, 3.0, 7)[:, None]
    for g, w in zip(tm.predict(Xt), jm.predict(jnp.asarray(Xt))):
        assert _rel(g, w) <= FIT_TOL["params"]
    assert abs(tm.elbo() - jm.elbo()) <= FIT_TOL["loss"] * abs(jm.elbo())


def test_facade_fit_keeps_the_reference_history_and_dtypes(fitted_pair):
    jm, tm = fitted_pair
    assert len(tm.history) == len(jm.history) == 1  # the last step's loss
    np.testing.assert_allclose(tm.history, jm.history, rtol=FIT_TOL["loss"])
    _assert_params_close(tm.params, jm.params, FIT_TOL["params"])
    q_mu, q_S = tm.latent()
    assert q_mu.dtype == torch.float64 and q_S.dtype == torch.float32


def test_facade_default_init_runs_and_lowers_the_loss():
    Y = _lvm_data(N=48)
    tm = BayesianGPLVM(M=M, backend="fused", device="cpu").fit(Y, steps=8, lr=5e-2)
    first = float(gplvm.loss(tm.init_params(Y), torch.as_tensor(Y), backend="fused"))
    assert np.isfinite(tm.history).all() and tm.history[-1] < first
    mean, var = tm.predict(np.zeros((3, 1)))
    assert mean.shape == (3, 3) and var.shape == (3,)


def test_facades_refuse_unported_options():
    with pytest.raises(NotImplementedError, match="distributed"):
        SparseGPRegression(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="distributed"):
        BayesianGPLVM(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="temporal"):
        regression(get("rbf")(1), backend="temporal")
    with pytest.raises(ValueError, match="backend"):
        regression(backend="bogus")
    assert isinstance(regression(M=4, stats_backend="fused", device="cpu"),
                      SparseGPRegression)
    with pytest.raises(RuntimeError, match="not fitted"):
        BayesianGPLVM(device="cpu").predict(np.zeros((1, 1)))
    with pytest.raises(ValueError, match="optimizer"):
        X, Y = _sgpr_data(N=8)
        SparseGPRegression(M=4, device="cpu").fit(X, Y, optimizer="sgd", steps=1)
    with pytest.raises(ValueError, match="conflicts"):
        BayesianGPLVM(kernel=get("rbf")(2), Q=1, device="cpu")


# ---------------------------------------------------------------------------
# serving a fitted facade
# ---------------------------------------------------------------------------

def test_register_serves_the_fitted_facade(fitted_pair):
    _, tm = fitted_pair
    Xt = torch.linspace(-2.0, 2.0, 5, dtype=torch.float64)[:, None]
    with GPServer(device="cpu") as srv:
        srv.register("lvm", tm)
        got = srv.predict("lvm", Xt)
    for g, w in zip(got, tm.predict(Xt)):
        assert _rel(g, w) <= 1e-12


def test_refit_matches_jax(fitted_pair):
    jm, _ = fitted_pair
    jstate = jm.export_state()
    fields = {k: jax.tree.map(np.asarray, getattr(jstate, k))
              for k in ("kern", "Z", "log_beta", "L", "LA", "Kuu_inv_mean")}
    fields["stats"] = {k: np.asarray(v) for k, v in jstate.stats._asdict().items()}
    new_j, want = jserve.online.refit(jm.kernel, jstate, steps=20)
    state = convert.state_from_numpy(fields, device="cpu")
    kernel = get("rbf")(1)
    new_t, got = online.refit(kernel, state, steps=20)
    # the served value's loss leads, then the last step's
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=FIT_TOL["loss"])
    assert all(b <= a + 1e-12 for a, b in zip(got, got[1:]))
    assert _rel(new_t.log_beta, new_j.log_beta) <= FIT_TOL["params"]
    with GPServer(device="cpu") as srv:
        srv.register("lvm", kernel=kernel, state=state)
        history = srv.refit("lvm", steps=20)
        np.testing.assert_allclose(history, got, rtol=1e-12)
        assert torch.equal(srv.state("lvm").log_beta, new_t.log_beta)
