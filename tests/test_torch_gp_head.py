"""The port's GP readout head (`repro_torch.core.gp_head`) against the
reference: `head_loss`, its gradients (the features' included, which is
what carries the head's signal into a backbone) and `head_predict` on the
same numpy parameters, features and targets; then the counterpart of
tests/test_distributed.py's head test (it trains, and its variance is
larger off the data than on it).

Tolerances, relative to the reference's largest entry: float32 within
1e-4 (loss), 1e-3 (gradients, prediction): Cholesky factors of a 32 x 32
Kuu in another order. Float64 parameters within 1e-6: both packages round
the features to float32 first, but the reference then evaluates parts of
the exact statistics on the float32 features before its arithmetic
promotes them, where the port promotes them first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import assert_trees_close, rel_err
from repro.core import gp_head as jhead
from repro_torch import convert
from repro_torch.core import gp_head as thead
from repro_torch.core.inference import fit_adam
from repro_torch.optim.adam import flatten, unflatten

N, F, M = 256, 16, 32
TOL = {"float32": (1e-4, 1e-3), "float64": (1e-6, 1e-6)}


def _problem(dtype, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, F))
    targets = np.sin(feats[:, 0]) + 0.05 * rng.normal(size=N)
    jp = jax.tree.map(lambda x: np.asarray(x, dtype),
                      jhead.init_head(jax.random.PRNGKey(seed), F, M=M))
    tp = convert.lm_tree_from_numpy(jp, device="cpu")
    return feats.astype(dtype), targets.astype(dtype), jp, tp


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_head_loss_and_gradients_match(dtype):
    feats, targets, jp, tp = _problem(dtype)
    loss_tol, grad_tol = TOL[dtype]
    want, (jg, jgf) = jax.jit(jax.value_and_grad(jhead.head_loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(feats), jnp.asarray(targets))
    leaves = [t.clone().requires_grad_() for t in flatten(tp)[1]]
    tf = torch.as_tensor(feats).requires_grad_()
    got = thead.head_loss(unflatten(tp, leaves), tf, torch.as_tensor(targets))
    grads = torch.autograd.grad(got, leaves + [tf])
    assert rel_err(got, want) <= loss_tol
    assert_trees_close(unflatten(tp, list(grads[:-1])), jg, grad_tol, "params")
    assert rel_err(grads[-1], jgf) <= grad_tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_head_predict_matches(dtype):
    feats, targets, jp, tp = _problem(dtype, seed=1)
    test = np.random.default_rng(5).normal(size=(9, F)).astype(dtype) * 2.0
    want = jax.jit(jhead.head_predict)(jax.tree.map(jnp.asarray, jp), jnp.asarray(feats),
                              jnp.asarray(targets), jnp.asarray(test))
    got = thead.head_predict(tp, torch.as_tensor(feats), torch.as_tensor(targets),
                             torch.as_tensor(test))
    assert isinstance(got, thead.HeadPrediction)
    assert rel_err(got.mean, want.mean) <= TOL[dtype][1]
    assert rel_err(got.var, want.var) <= TOL[dtype][1]


def test_head_over_mesh_axes_waits_for_sharding():
    """Summed over mesh axes, the statistics need the mesh whose groups they
    are summed over (tests/test_torch_mesh_steps.py runs it on two ranks);
    with no axes the mesh is not needed."""
    feats, targets, _, tp = _problem("float32")
    with pytest.raises(ValueError, match="needs the mesh"):
        thead.head_loss(tp, torch.as_tensor(feats), torch.as_tensor(targets),
                        axis_names=("data",))
    assert torch.equal(thead.head_loss(tp, torch.as_tensor(feats), torch.as_tensor(targets),
                                       axis_names=(), mesh=None),
                       thead.head_loss(tp, torch.as_tensor(feats), torch.as_tensor(targets)))


def test_gp_head_trains_and_calibrates():
    """Deep-kernel head on synthetic features: the loss decreases, and the
    predictive variance is higher off the data than on it."""
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(N, F, generator=g, dtype=torch.float64)
    targets = torch.sin(feats[:, 0]) + 0.05 * torch.randn(N, generator=g, dtype=torch.float64)
    params = thead.init_head(2, F, M=32, device="cpu")
    params = unflatten(params, [t.double() for t in flatten(params)[1]])
    l0 = float(thead.head_loss(params, feats, targets))
    params, hist = fit_adam(thead.head_loss, params, (feats, targets), steps=100, lr=3e-2)
    assert hist[-1] < l0
    pred = thead.head_predict(params, feats, targets, feats[:8])
    far = 20.0 + torch.randn(8, F, generator=g, dtype=torch.float64)
    pred_far = thead.head_predict(params, feats, targets, far)
    assert float(pred_far.var.mean()) > float(pred.var.mean())
