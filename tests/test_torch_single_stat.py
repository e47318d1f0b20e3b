"""The port's single-statistic ops (`backend="pallas"`: psi1 and psi2, each
with its reverse pass) on the CPU against the JAX reference.

The plain versions (`psi1_plain`, `psi2_plain`, `psi1_vjp_plain`,
`psi2_vjp_plain`) against the reference's Pallas kernels in interpret mode
(as its own tests run them) and its jnp reverse passes, on float64 inputs
from numpy seeds, at 1e-10 relative to max|reference| per output. The ops
(`ops.psi1`, `ops.psi2`) for gradient parity with the facades' mixed dtypes
(float64 leaves to 1e-10; float32 leaves get the float64 cotangent rounded
to float32, so 1e-6), their `bwd_backend` dispatch, and the statistics and
the GP-LVM facade through `backend="pallas"`. The CUDA kernels run only on
the card (tests/test_torch_cuda.py, `-m cuda`); here their wrappers are
checked to refuse CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import psi_stats as jps
from repro.gp import get as jget
from repro.kernels import ops as jops
from repro.kernels.psi1 import psi1_pallas
from repro.kernels.psi2 import psi2_pallas
from repro.kernels.suffstats import (psi1_bwd_pallas, psi1_vjp_jnp,
                                     psi2_bwd_pallas, psi2_vjp_jnp)
from repro_torch.core import psi_stats as tps
from repro_torch.gp import (BayesianGPLVM, ExpectedBatch, get,
                            streaming_suff_stats, suff_stats)
from repro_torch.kernels import ops
from repro_torch.kernels import psi1 as tpsi1
from repro_torch.kernels import psi2 as tpsi2
from repro_torch.kernels import suffstats as tss
from repro_torch.serve import GPServer

RTOL = 1e-10

# (N, M, Q, S > 0): M = 130 spans two of the reference's 128-wide tiles with
# a ragged second one; N ragged against its 32- and 256-row tiles and the
# plain passes' chunks (and N = 1); Q in {1, 3}; S = 0 (psi1 is then K_fu)
CASES = [(37, 130, 3, True), (70, 130, 1, True), (1, 5, 1, True),
         (37, 13, 1, False), (50, 16, 3, False)]
OUTPUTS = ("dmu", "dS", "dZ", "dvariance", "dlengthscale")


def _inputs(N, M, Q, pos_S, seed=0):
    """(mu, S, Z, variance, lengthscale, g (N, M), g2 (M, M))."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(N, Q))
    S = rng.uniform(0.05, 0.6, (N, Q)) if pos_S else np.zeros((N, Q))
    return (mu, S, 1.2 * rng.normal(size=(M, Q)), np.float64(1.3),
            rng.uniform(0.6, 1.4, Q), rng.normal(size=(N, M)),
            rng.normal(size=(M, M)))


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _case_id(c):
    return f"N{c[0]}-M{c[1]}-Q{c[2]}-{'S' if c[3] else 'S0'}"


# ---------------------------------------------------------------------------
# the plain versions against the reference's kernels and jnp passes
# ---------------------------------------------------------------------------

FORWARDS = {
    "psi1": (tpsi1.psi1_plain, lambda *a: psi1_pallas(*a, interpret=True)),
    "psi2": (tpsi2.psi2_plain, lambda *a: psi2_pallas(*a, interpret=True)),
}
REVERSES = {
    ("psi1", "pallas_interpret"): lambda *a: psi1_bwd_pallas(*a, interpret=True),
    ("psi1", "vjp_jnp"): psi1_vjp_jnp,
    ("psi2", "pallas_interpret"): lambda *a: psi2_bwd_pallas(*a, interpret=True),
    ("psi2", "vjp_jnp"): psi2_vjp_jnp,
}
PLAIN_VJP = {"psi1": tss.psi1_vjp_plain, "psi2": tss.psi2_vjp_plain}


def _cotangent(stat, arrs):
    return arrs[5] if stat == "psi1" else arrs[6]


@pytest.mark.parametrize("stat", sorted(FORWARDS))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_forward_matches_the_interpret_kernel(case, stat):
    arrs = _inputs(*case)[:5]
    plain, kernel = FORWARDS[stat]
    got = plain(*map(torch.as_tensor, arrs))
    assert got.dtype == torch.float64
    assert _rel(got, kernel(*map(jnp.asarray, arrs))) <= RTOL


@pytest.mark.parametrize("stat,jax_fn", sorted(REVERSES),
                         ids=[f"{s}-{f}" for s, f in sorted(REVERSES)])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_vjp_matches_jax(case, stat, jax_fn):
    arrs = _inputs(*case)
    args = (*arrs[:5], _cotangent(stat, arrs))
    want = REVERSES[stat, jax_fn](*map(jnp.asarray, args))
    got = PLAIN_VJP[stat](*map(torch.as_tensor, args))
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == torch.float64, name
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("stat", sorted(FORWARDS))
@pytest.mark.parametrize("case", CASES[1:4], ids=_case_id)
def test_plain_vjp_matches_autograd_of_the_plain_forward(case, stat):
    arrs = [torch.as_tensor(a) for a in _inputs(*case)]
    leaves = [a.clone().requires_grad_(True) for a in arrs[:5]]
    g = _cotangent(stat, arrs)
    want = torch.autograd.grad((FORWARDS[stat][0](*leaves) * g).sum(), leaves)
    got = PLAIN_VJP[stat](*arrs[:5], g)
    for name, a, w in zip(OUTPUTS, got, want):
        assert _rel(a, w) <= RTOL, name


@pytest.mark.parametrize("stat", sorted(FORWARDS))
@pytest.mark.parametrize("chunk", (1, 7, 64))
def test_plain_vjp_is_chunk_independent(stat, chunk):
    arrs = [torch.as_tensor(a) for a in _inputs(50, 16, 2, True)]
    args = (*arrs[:5], _cotangent(stat, arrs))
    base = PLAIN_VJP[stat](*args)
    for g, w in zip(PLAIN_VJP[stat](*args, chunk=chunk), base):
        assert _rel(g, w) <= RTOL


def test_psi1_vjp_at_zero_variance_is_the_kfu_reverse_pass():
    """At S = 0 the psi1 reverse pass is K_fu's (the reference's
    kfu_vjp_jnp, and the port's kfu reverse): dX, dZ, dv, dl."""
    from repro.kernels.suffstats import kfu_vjp_jnp

    mu, S, Z, v, l, g, _ = _inputs(37, 13, 2, False)
    want = kfu_vjp_jnp(*map(jnp.asarray, (mu, Z, v, l, g)))
    got = tss.psi1_vjp_plain(*map(torch.as_tensor, (mu, S, Z, v, l, g)))
    for a, w in zip((got[0], *got[2:]), want):
        assert _rel(a, w) <= RTOL


# ---------------------------------------------------------------------------
# the differentiable ops
# ---------------------------------------------------------------------------

OPS = {"psi1": (ops.psi1, jops.psi1), "psi2": (ops.psi2, jops.psi2)}


@pytest.mark.parametrize("stat", sorted(OPS))
def test_ops_gradients_match_jax_with_mixed_dtypes(stat):
    """The GP-LVM facade's mix: float64 mu and Z; float32 S, variance and
    lengthscale. Both packages compute in mu's dtype and hand each
    cotangent back in its own input's dtype."""
    arrs = _inputs(37, 13, 3, True)
    mixed = [a if i in (0, 2) else np.asarray(a, np.float32)
             for i, a in enumerate(arrs[:5])]
    g = _cotangent(stat, arrs)
    op, jop = OPS[stat]
    want_val, vjp = jax.vjp(lambda *x: jop(*x), *map(jnp.asarray, mixed))
    want = vjp(jnp.asarray(g))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in mixed]
    val = op(*leaves)
    assert val.dtype == torch.float64
    assert _rel(val, want_val) <= RTOL
    grads = torch.autograd.grad((val * torch.as_tensor(g)).sum(), leaves)
    for name, a, leaf, w in zip(OUTPUTS, grads, leaves, want):
        assert a.dtype == leaf.dtype, name
        assert _rel(a, w) <= (RTOL if a.dtype == torch.float64 else 1e-6), name


@pytest.mark.parametrize("stat", sorted(OPS))
@pytest.mark.parametrize("bwd_backend", ("auto", "jnp"))
def test_ops_backward_on_cpu_is_the_plain_reverse_pass(stat, bwd_backend):
    arrs = [torch.as_tensor(a) for a in _inputs(37, 13, 1, True)]
    leaves = [a.clone().requires_grad_(True) for a in arrs[:5]]
    g = _cotangent(stat, arrs)
    counts = (tss.PSI1_BWD_LAUNCHES, tss.PSI2_BWD_LAUNCHES,
              tpsi1.LAUNCHES, tpsi2.LAUNCHES)
    grads = torch.autograd.grad(
        (OPS[stat][0](*leaves, bwd_backend=bwd_backend) * g).sum(), leaves)
    for a, w in zip(grads, PLAIN_VJP[stat](*arrs[:5], g)):
        assert torch.equal(a, w)
    assert counts == (tss.PSI1_BWD_LAUNCHES, tss.PSI2_BWD_LAUNCHES,
                      tpsi1.LAUNCHES, tpsi2.LAUNCHES)  # no kernel involved


@pytest.mark.parametrize("stat", sorted(OPS))
def test_ops_validate_bwd_backend_and_refuse_the_kernel_on_cpu(stat):
    """No fallback: bwd_backend="pallas" means the reverse kernel, which
    has no CPU mode, and every kernel wrapper takes CUDA tensors or
    raises."""
    arrs = [torch.as_tensor(a) for a in _inputs(37, 13, 1, True)]
    op = OPS[stat][0]
    with pytest.raises(ValueError, match="bwd_backend"):
        op(*arrs[:5], bwd_backend="triton")
    mu = arrs[0].clone().requires_grad_(True)
    out = op(mu, *arrs[1:5], bwd_backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        out.sum().backward()
    with pytest.raises(ValueError, match="CUDA"):
        (tpsi1.psi1_cuda if stat == "psi1" else tpsi2.psi2_cuda)(*arrs[:5])
    with pytest.raises(ValueError, match="CUDA"):
        (tss.psi1_bwd_cuda if stat == "psi1" else tss.psi2_bwd_cuda)(
            *arrs[:5], _cotangent(stat, arrs))


@pytest.mark.parametrize("shape", ((1_000_000, 100), (100_003, 256), (1, 5)))
def test_psi1_bwd_splits_depend_on_shape_only(shape):
    N, M = shape
    P = tss.psi1_bwd_splits(N, M)
    assert P == tss.psi1_bwd_splits(N, M) and P >= 1
    assert P == 1 or N // P >= tss.PSI1_BWD_RUN
    tiles = -(-M // tss.PSI1_BWD_LANES)
    assert tiles * P < tss.TARGET_BLOCKS + tiles  # about TARGET_BLOCKS blocks


# ---------------------------------------------------------------------------
# statistics, the streaming engine and the facades through backend="pallas"
# ---------------------------------------------------------------------------

def _stats_data(N=53, M=11, Q=2, D=3, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(N, Q)), rng.uniform(0.05, 0.5, (N, Q)),
            rng.normal(size=(N, D)), 1.1 * rng.normal(size=(M, Q)))
    kern = {"log_variance": np.log(1.3),
            "log_lengthscale": np.log(rng.uniform(0.6, 1.4, Q))}
    return arrs, kern


def test_expected_stats_through_pallas_match_jax_and_the_fused_op():
    arrs, kern = _stats_data()
    want = jps.expected_stats_rbf({k: jnp.asarray(v) for k, v in kern.items()},
                                  *map(jnp.asarray, arrs), backend="pallas")
    tk = {k: torch.as_tensor(v) for k, v in kern.items()}
    got = tps.expected_stats_rbf(tk, *map(torch.as_tensor, arrs), backend="pallas")
    fused = tps.expected_stats_rbf(tk, *map(torch.as_tensor, arrs), backend="fused")
    for name, g, w, f in zip(tps.SuffStats._fields, got, want, fused):
        assert _rel(g, w) <= RTOL, name
        assert _rel(g, f) <= RTOL, name


def test_streaming_pallas_chunks_are_checkpointed(monkeypatch):
    """Each pallas chunk is checkpointed: its forward runs again in the
    backward pass, and the gradients equal the one-shot ops'."""
    arrs, kern = _stats_data(N=300, M=9, Q=1)
    mu, S, Y, Z = (torch.as_tensor(a).requires_grad_(i != 2)
                   for i, a in enumerate(arrs))
    chunk = 64
    calls = [0]
    plain = ops.psi1_plain

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "psi1_plain", counted)
    params = {k: torch.as_tensor(v).requires_grad_(True) for k, v in kern.items()}

    def objective(c):
        st = (streaming_suff_stats(get("rbf")(1), params, ExpectedBatch(mu, S, Y, Z),
                                   backend="pallas", chunk=c) if c
              else suff_stats(get("rbf")(1), params, ExpectedBatch(mu, S, Y, Z),
                              backend="pallas"))
        return st.psi2.sum() + (st.psiY ** 2).sum()

    leaves = (mu, S, Z, *params.values())
    grads = torch.autograd.grad(objective(chunk), leaves)
    assert calls[0] == 2 * -(-mu.shape[0] // chunk)
    want = torch.autograd.grad(objective(None), leaves)
    for a, b in zip(grads, want):
        assert _rel(a, b) <= RTOL


def test_gplvm_pallas_fit_matches_jax_and_serves():
    """Three Adam steps of both packages' GP-LVM facades through
    backend="pallas" from the same parameters (losses and parameters to
    1e-5, as the fused fits in test_torch_models.py), then the fitted model
    registered and served."""
    from repro.core import gplvm as jgplvm
    from repro.gp import BayesianGPLVM as JBayesianGPLVM
    from repro_torch import convert
    from repro_torch.optim.adam import flatten

    rng = np.random.default_rng(0)
    t = 2.0 * rng.normal(size=(64, 1))
    Y = np.hstack([np.sin(t), np.cos(t), 0.3 * t]) + 0.05 * rng.normal(size=(64, 3))
    p = jax.tree.map(np.asarray, jgplvm.init_params(jax.random.PRNGKey(0),
                                                    jnp.asarray(Y), 1, 8))
    p["Z"] = np.linspace(-2.5, 2.5, 8)[:, None]
    jm = JBayesianGPLVM(kernel=jget("rbf")(1), M=8, backend="pallas").fit(
        jnp.asarray(Y), steps=3, log_every=1, params=jax.tree.map(jnp.asarray, p))
    tm = BayesianGPLVM(M=8, backend="pallas", device="cpu").fit(
        Y, steps=3, log_every=1, params=convert.params_from_numpy(p, device="cpu"))
    assert len(tm.history) == 3 and tm.history[-1] < tm.history[0]
    np.testing.assert_allclose(tm.history, jm.history, rtol=1e-5)
    paths, leaves = flatten(tm.params)
    for path, g, w in zip(paths, leaves, jax.tree.leaves(jm.params)):
        assert _rel(g, w) <= 1e-5, path
    Xt = torch.linspace(-2.0, 2.0, 5, dtype=torch.float64)[:, None]
    with GPServer(device="cpu") as srv:
        srv.register("lvm", tm)
        got = srv.predict("lvm", Xt)
    for g, w in zip(got, tm.predict(Xt)):
        assert _rel(g, w) <= 1e-12

