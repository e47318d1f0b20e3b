"""The port's single-device MoE (`repro_torch.models.moe`) against the
reference: the reference's own properties of `tests/test_moe.py` held by
the port (the dense gather path equals a naive per-token loop when
capacity is unconstrained, tight capacity only drops rows, the aux loss
lies in [0, E], the permutation's backward is an exact gather) and each
compared with the reference on the same parameters and inputs; the
router's tie-breaking; the expert-parallel paths' refusal.

Tolerances: the reference test's 1e-4 relative / 1e-5 absolute for
outputs (the expert FFN runs in the config's float32 compute dtype),
1e-12 for the permutation's gradient in float64, 1e-5 for the aux loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from _lm_parity import config_pair, to_torch
from repro.models import moe as jmoe
from repro_torch.parallel.sharding import no_constrain
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
# the reference's dense path, compiled once per shape (the config is static)
J_MOE = jax.jit(jmoe.moe_apply_dense, static_argnums=2)


def _cfgs(cf=8.0, arch="arctic-480b"):
    return config_pair(get_smoke_config(arch), capacity_factor=cf)


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def naive_reference(params, x, cfg):
    """Per-token loop over the top-k experts (no capacity), in torch."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt @ params["router"], -1)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.num_experts_per_tok):
            e = int(top_e[t, j])
            h = torch.nn.functional.silu(xt[t] @ params["w_gate"][e]) * (xt[t] @ params["w_up"][e])
            out[t] += top_p[t, j] * (h @ params["w_down"][e])
    return out.reshape(B, S, d)


@pytest.mark.parametrize("arch", ["arctic-480b", "moonshot-v1-16b-a3b"])
def test_dense_path_matches_naive_loop(arch):
    jcfg, cfg = _cfgs(arch=arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float64), jmoe.moe_init(jax.random.PRNGKey(0), jcfg))
    params = to_torch(jp)
    x = _x((2, 8, cfg.d_model), 1, np.float64)
    got = tmoe.moe_apply_dense(params, torch.as_tensor(x), cfg).y
    np.testing.assert_allclose(got.numpy(), naive_reference(params, torch.as_tensor(x), cfg).numpy(),
                               **OUT_TOL)
    want = J_MOE(jp, jnp.asarray(x), jcfg).y
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_capacity_drops_reduce_output_norm_only():
    """With tight capacity the outputs are a masked version of the uncapped
    ones (dropped pairs contribute zero rows), the reference's the same."""
    jlo, lo = _cfgs(cf=0.25)
    jhi, hi = _cfgs(cf=8.0)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jlo)
    params = to_torch(jp)
    x = _x((2, 32, lo.d_model), 2)
    y_lo = tmoe.moe_apply_dense(params, torch.as_tensor(x), lo).y
    y_hi = tmoe.moe_apply_dense(params, torch.as_tensor(x), hi).y
    assert bool(torch.isfinite(y_lo).all())
    assert float(y_lo.norm()) <= float(y_hi.norm()) * 1.25 + 1e-3
    assert bool((y_lo != y_hi).any())  # capacity 0.25 drops pairs
    np.testing.assert_allclose(y_lo.numpy(), np.asarray(J_MOE(jp, jnp.asarray(x), jlo).y),
                               **OUT_TOL)
    np.testing.assert_allclose(y_hi.numpy(), np.asarray(J_MOE(jp, jnp.asarray(x), jhi).y),
                               **OUT_TOL)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16), T=st.integers(2, 16))
def test_aux_loss_bounds(seed, T):
    """The Switch load-balance loss lies in [0, E], and is the reference's."""
    jcfg, cfg = _cfgs()
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = _x((1, T, cfg.d_model), seed)
    aux = float(tmoe.moe_apply_dense(to_torch(jp), torch.as_tensor(x), cfg).aux_loss)
    assert 0.0 <= aux <= cfg.num_experts
    want = float(J_MOE(jp, jnp.asarray(x), jcfg).aux_loss)
    assert abs(aux - want) <= 1e-5 * max(abs(want), 1e-30)


def test_permute_rows_backward_is_gather_exact():
    n_in, n_out, d = 10, 7, 4
    x = torch.as_tensor(_x((n_in, d), 2, np.float64), dtype=torch.float64).requires_grad_()
    fwd = torch.tensor([3, 9, 0, n_in, 5, 1, n_in])  # sentinels = n_in
    inv = torch.full((n_in,), n_out)
    for j, i in enumerate(fwd.tolist()):
        if i < n_in:
            inv[i] = j
    w = torch.arange(n_out * d, dtype=torch.float64).reshape(n_out, d)
    out = tmoe.permute_rows(x, fwd, inv, n_out)
    assert bool((out[3] == 0).all()) and bool((out[6] == 0).all())
    (g,) = torch.autograd.grad(torch.sum(out * w), x)
    onehot = (fwd[:, None] == torch.arange(n_in)[None, :]).double()
    np.testing.assert_allclose(g.numpy(), (onehot.T @ w).numpy(), rtol=1e-12)
    jg = jax.grad(lambda a: jnp.sum(jmoe.permute_rows(a, jnp.asarray(fwd.numpy()),
                                                      jnp.asarray(inv.numpy()), n_out)
                                    * jnp.asarray(w.numpy())))(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12)


def test_router_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities pick the lower expert id first, as
    `lax.top_k` does, in both packages."""
    probs = np.asarray([[0.1, 0.3, 0.3, 0.2, 0.1], [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    for k in (1, 2, 3):
        _, te = tmoe._top_k(torch.as_tensor(probs), k)
        _, je = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_routing_slots_match_reference():
    """Dispatch end to end at a tight capacity: the same tokens land in the
    same slots, so the outputs and the router's gradient agree."""
    jcfg, cfg = _cfgs(cf=1.0, arch="moonshot-v1-16b-a3b")
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    x = _x((2, 24, cfg.d_model), 3)
    w = _x((2, 24, cfg.d_model), 4)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jmoe.moe_apply_dense(p, jnp.asarray(x), jcfg).y
                                            * w)))(jp)
    params = {k: v.clone().requires_grad_() for k, v in to_torch(jp).items()}
    out = tmoe.moe_apply_dense(params, torch.as_tensor(x), cfg)
    torch.sum(out.y * torch.as_tensor(w)).backward()
    for k in ("router", "w_gate", "w_up", "w_down"):
        ref = np.asarray(jg[k])
        scale = float(np.max(np.abs(ref)))
        np.testing.assert_allclose(params[k].grad.numpy() / scale, ref / scale, **OUT_TOL)


@pytest.mark.parametrize("path", ["moe_apply_ep", "moe_apply_ep_a2a"])
def test_expert_parallel_paths_wait_for_sharding(path):
    """The expert-parallel paths run on a device mesh of more than one rank
    (tests/test_torch_moe_ep.py); off it they refuse, and moe_apply takes
    the dense path."""
    cfg = get_smoke_config("arctic-480b")
    with pytest.raises(ValueError, match="device mesh of more than one rank"):
        getattr(tmoe, path)({}, torch.zeros(1, 2, cfg.d_model), cfg, no_constrain)
    # without a mesh, moe_apply is the dense path
    params = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.as_tensor(_x((1, 4, cfg.d_model), 5))
    assert torch.equal(tmoe.moe_apply(params, x, cfg).y, tmoe.moe_apply_dense(params, x, cfg).y)
