"""The port's Adam (`repro_torch.optim`) and optimizer loops
(`repro_torch.core.inference`) against the reference's, on the CPU.

The same gradient sequence (numpy, seeded) drives both optimizers for five
steps over a nested parameter dict with float32 and float64 leaves. The
update is computed in float32 in both (the parameter is rounded to float32
before each step), so the parameters agree to a few float32 ulps: 1e-6
relative to max|reference| (the float32 ulp is 1.2e-7; `pow` and `sqrt`
may round their last bit differently in XLA and in torch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as jinference
from repro.optim import adam as jadam
from repro_torch.core import inference
from repro_torch.optim import AdamConfig, adam_init, adam_update, global_norm
from repro_torch.optim.adam import flatten, unflatten

RTOL = 1e-6
STEPS = 5


def _params(rng):
    return {"kern": {"log_variance": np.float32(0.3),
                     "log_lengthscale": rng.normal(size=2).astype(np.float32)},
            "Z": rng.normal(size=(4, 2)),
            "log_beta": np.float32(1.5),
            "q_mu": rng.normal(size=(6, 2))}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.as_tensor(np.array(v))
            for k, v in tree.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _assert_trees_close(got, want, rtol=RTOL):
    paths, leaves = flatten(got)
    want_leaves = jax.tree.leaves(want)  # sorted-key order, as `flatten`
    assert len(leaves) == len(want_leaves)
    for path, g, w in zip(paths, leaves, want_leaves):
        assert str(g.dtype).removeprefix("torch.") == np.asarray(w).dtype.name, path
        assert _rel(g.double(), np.asarray(w, np.float64)) <= rtol, path


CONFIGS = {
    "plain": dict(clip_norm=None),
    "clip": dict(clip_norm=0.5),
    "decay_masked": dict(weight_decay=0.1,
                         decay_mask=lambda name: not name.startswith("kern")),
    "bf16_state": dict(state_dtype="bfloat16"),
    "schedule": dict(lr=lambda step: 1e-2 / step),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_adam_update_matches_jax_over_five_steps(name):
    rng = np.random.default_rng(0)
    p_np = _params(rng)
    kwargs = {"lr": 3e-2, **CONFIGS[name]}
    t_cfg = AdamConfig(**kwargs)
    j_cfg = jadam.AdamConfig(**kwargs)
    tp, jp = _to_torch(p_np), _to_jax(p_np)
    ts, js = adam_init(tp, t_cfg), jadam.adam_init(jp, j_cfg)
    for _ in range(STEPS):
        g_np = jax.tree.map(lambda a: (3.0 * rng.normal(size=np.shape(a))).astype(
            np.asarray(a).dtype), p_np)
        tp, ts, tn = adam_update(_to_torch(g_np), ts, tp, t_cfg)
        jp, js, jn = jadam.adam_update(_to_jax(g_np), js, jp, j_cfg)
        assert _rel(tn, jn) <= RTOL
        _assert_trees_close(tp, jp)
    assert int(ts.step) == STEPS
    _assert_trees_close(ts.m, js.m, rtol=1e-2 if name == "bf16_state" else RTOL)


def test_global_norm_is_float32():
    tree = _to_torch(_params(np.random.default_rng(1)))
    n = global_norm(tree)
    assert n.dtype == torch.float32
    want = np.sqrt(sum(float((np.asarray(x, np.float32) ** 2).sum())
                       for x in flatten(tree)[1]))
    assert abs(float(n) - want) <= 1e-6 * want


def test_flatten_round_trips_in_sorted_key_order():
    tree = _to_torch(_params(np.random.default_rng(2)))
    paths, leaves = flatten(tree)
    assert paths == ["Z", "kern/log_lengthscale", "kern/log_variance",
                     "log_beta", "q_mu"]
    back = unflatten(tree, leaves)
    assert flatten(back)[0] == paths


def _quadratic(params, A, b):
    x = params["x"]
    return 0.5 * (x * (A @ x)).sum() - (b * x).sum() + params["s"] ** 2


@pytest.mark.parametrize("steps,log_every", ((0, 0), (1, 0), (7, 0), (7, 3), (7, 2)))
def test_fit_adam_history_rule_matches_jax(steps, log_every):
    """The history ends with the loss the final step computed; steps=0
    gives []; log_every logs every k-th step without repeating the last."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(3, 3))
    A = A @ A.T + 3 * np.eye(3)
    b = rng.normal(size=3)
    p0 = {"x": np.zeros(3), "s": np.float32(0.7)}

    def jloss(p, A, b):
        x = p["x"]
        return 0.5 * jnp.sum(x * (A @ x)) - jnp.sum(b * x) + p["s"] ** 2

    jp, jh = jinference.fit_adam(jloss, _to_jax(p0), (jnp.asarray(A), jnp.asarray(b)),
                                 steps=steps, lr=0.1, log_every=log_every)
    tp, th = inference.fit_adam(_quadratic, _to_torch(p0),
                                (torch.as_tensor(A), torch.as_tensor(b)),
                                steps=steps, lr=0.1, log_every=log_every)
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=RTOL)
    _assert_trees_close(tp, jp)


def test_fit_lbfgs_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(3, 3))
    A = A @ A.T + 3 * np.eye(3)
    b = rng.normal(size=3)
    p0 = {"x": np.zeros(3), "s": np.float64(0.7)}

    def jloss(p, A, b):
        x = p["x"]
        return 0.5 * jnp.sum(x * (A @ x)) - jnp.sum(b * x) + p["s"] ** 2

    jp, jf = jinference.fit_lbfgs(jloss, _to_jax(p0), (jnp.asarray(A), jnp.asarray(b)))
    tp, tf = inference.fit_lbfgs(_quadratic, _to_torch(p0),
                                 (torch.as_tensor(A), torch.as_tensor(b)))
    assert abs(tf - jf) <= 1e-10 * abs(jf)
    assert _rel(tp["x"], jp["x"]) <= 1e-8
    assert tp["x"].dtype == torch.float64


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ratio", [0.05, 0.2, 0.5])
def test_topk_compression_error_feedback_conserves_signal(seed, ratio):
    """The reference's property (`tests/test_optim.py`): over six steps, the
    compressed gradients sent plus the final residual sum to the raw
    gradients, each step sends at most ratio * n (+1 on a tie) nonzeros,
    and each step's output and residual are the reference's."""
    from repro.optim import compression as jcomp
    from repro_torch.optim import compression_init, topk_compress_decompress

    rng = np.random.RandomState(seed)
    grads = [{"w": rng.randn(64).astype(np.float32), "b": {"m": rng.randn(3, 5).astype(np.float32)}}
             for _ in range(6)]
    state = compression_init({"w": torch.zeros(64), "b": {"m": torch.zeros(3, 5)}})
    jstate = jcomp.compression_init(jax.tree.map(jnp.asarray, grads[0]))
    sent_total = np.zeros(64, np.float32)
    for g in grads:
        sent, state = topk_compress_decompress(jax.tree.map(torch.as_tensor, g), state,
                                               ratio=ratio)
        jsent, jstate = jcomp.topk_compress_decompress(jax.tree.map(jnp.asarray, g), jstate,
                                                       ratio=ratio)
        for got, want in zip(flatten(sent)[1] + flatten(state.residual)[1],
                             jax.tree.leaves(jsent) + jax.tree.leaves(jstate.residual)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        sent_total += sent["w"].numpy()
        assert int((sent["w"] != 0).sum()) <= max(1, int(ratio * 64)) + 1
    raw_total = sum(g["w"] for g in grads)
    np.testing.assert_allclose(sent_total + state.residual["w"].numpy(), raw_total,
                               rtol=1e-4, atol=1e-5)
