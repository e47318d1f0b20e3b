"""The port's K_fu path (`SparseGPRegression(backend="pallas")`) on the CPU
against the JAX reference.

`kfu_plain` against the reference's Pallas kernel `kfu_pallas` in
interpret mode (as its own tests run it) and its oracle `ref.kfu_rbf`;
`kfu_vjp_plain` against `kfu_vjp_jnp` and `kfu_bwd_pallas` in interpret
mode; all on float64 inputs from numpy seeds, at 1e-10 relative to
max|reference| per output. The op `ops.kfu` for gradient parity with the
regression facade's mixed dtypes (float64 leaves to 1e-10; float32 leaves
get the float64 cotangent rounded to float32, so 1e-6) and its
`bwd_backend` dispatch; the exact statistics through backend="pallas", one
shot and streamed; and three Adam steps of both packages' facades. The CUDA
kernel runs only on the card (tests/test_torch_cuda.py, `-m cuda`); here
its wrapper is checked to refuse CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import psi_stats as jps
from repro.gp import ExactBatch as JExactBatch
from repro.gp import SparseGPRegression as JSparseGPRegression
from repro.gp import get as jget
from repro.gp import suff_stats as jsuff_stats
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.kfu import kfu_pallas
from repro.kernels.suffstats import kfu_bwd_pallas, kfu_vjp_jnp
from repro_torch import convert
from repro_torch.core import psi_stats as tps
from repro_torch.gp import (ExactBatch, SparseGPRegression, get,
                            streaming_suff_stats, suff_stats)
from repro_torch.kernels import kfu as tkfu
from repro_torch.kernels import ops
from repro_torch.kernels import psi1 as tpsi1
from repro_torch.kernels import suffstats as tss
from repro_torch.optim.adam import flatten
from repro_torch.serve import GPServer

RTOL = 1e-10

# (N, M, Q): M = 130 spans two of the reference's 128-wide tiles with a
# ragged second one; N ragged against its 256-row tiles and the plain
# reverse pass's 512-point chunks (and N = 1); Q in {1, 3}
CASES = [(37, 130, 3), (70, 130, 1), (1, 5, 1), (300, 13, 3), (600, 9, 1)]
OUTPUTS = ("dX", "dZ", "dvariance", "dlengthscale")


def _inputs(N, M, Q, seed=0):
    """(X, Z, variance, lengthscale, g (N, M))."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, Q)), 1.2 * rng.normal(size=(M, Q)),
            np.float64(1.3), rng.uniform(0.6, 1.4, Q), rng.normal(size=(N, M)))


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _case_id(c):
    return f"N{c[0]}-M{c[1]}-Q{c[2]}"


# ---------------------------------------------------------------------------
# the plain versions against the reference's kernels and jnp passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("want", ("pallas_interpret", "oracle"))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kfu_plain_matches_the_reference(case, want):
    arrs = _inputs(*case)[:4]
    got = tkfu.kfu_plain(*map(torch.as_tensor, arrs))
    assert got.dtype == torch.float64
    jarrs = map(jnp.asarray, arrs)
    ref = (kfu_pallas(*jarrs, interpret=True) if want == "pallas_interpret"
           else jref.kfu_rbf(*jarrs))
    assert _rel(got, ref) <= RTOL


REVERSES = {"pallas_interpret": lambda *a: kfu_bwd_pallas(*a, interpret=True),
            "vjp_jnp": kfu_vjp_jnp}


@pytest.mark.parametrize("jax_fn", sorted(REVERSES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kfu_vjp_plain_matches_jax(case, jax_fn):
    arrs = _inputs(*case)
    want = REVERSES[jax_fn](*map(jnp.asarray, arrs))
    got = tss.kfu_vjp_plain(*map(torch.as_tensor, arrs))
    assert len(got) == len(want) == 4
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == torch.float64, name
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("case", CASES[:2], ids=_case_id)
def test_kfu_vjp_plain_matches_autograd_of_the_plain_forward(case):
    arrs = [torch.as_tensor(a) for a in _inputs(*case)]
    leaves = [a.clone().requires_grad_(True) for a in arrs[:4]]
    want = torch.autograd.grad((tkfu.kfu_plain(*leaves) * arrs[4]).sum(), leaves)
    for name, a, w in zip(OUTPUTS, tss.kfu_vjp_plain(*arrs), want):
        assert _rel(a, w) <= RTOL, name


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

def test_ops_kfu_gradients_match_jax_with_mixed_dtypes():
    """The regression facade's mix: float64 X and Z; float32 variance and
    lengthscale. Both packages compute in X's dtype and hand each cotangent
    back in its own input's dtype."""
    arrs = _inputs(37, 13, 3)
    mixed = [a if i in (0, 1) else np.asarray(a, np.float32)
             for i, a in enumerate(arrs[:4])]
    want_val, vjp = jax.vjp(lambda *x: jops.kfu(*x), *map(jnp.asarray, mixed))
    want = vjp(jnp.asarray(arrs[4]))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in mixed]
    val = ops.kfu(*leaves)
    assert val.dtype == torch.float64
    assert _rel(val, want_val) <= RTOL
    grads = torch.autograd.grad((val * torch.as_tensor(arrs[4])).sum(), leaves)
    for name, a, leaf, w in zip(OUTPUTS, grads, leaves, want):
        assert a.dtype == leaf.dtype, name
        assert _rel(a, w) <= (RTOL if a.dtype == torch.float64 else 1e-6), name


@pytest.mark.parametrize("bwd_backend", ("auto", "jnp"))
def test_ops_kfu_backward_on_cpu_is_the_plain_reverse_pass(bwd_backend):
    arrs = [torch.as_tensor(a) for a in _inputs(37, 13, 1)]
    leaves = [a.clone().requires_grad_(True) for a in arrs[:4]]
    counts = (tkfu.LAUNCHES, tss.PSI1_BWD_LAUNCHES, tpsi1.LAUNCHES)
    out = ops.kfu(*leaves, bwd_backend=bwd_backend)
    assert torch.equal(out, tkfu.kfu_plain(*arrs[:4]))
    grads = torch.autograd.grad((out * arrs[4]).sum(), leaves)
    for a, w in zip(grads, tss.kfu_vjp_plain(*arrs)):
        assert torch.equal(a, w)
    assert counts == (tkfu.LAUNCHES, tss.PSI1_BWD_LAUNCHES, tpsi1.LAUNCHES)


def test_ops_kfu_validates_bwd_backend_and_refuses_the_kernel_on_cpu():
    """No fallback: bwd_backend="pallas" means the reverse kernel, which
    has no CPU mode, and both kernel wrappers take CUDA tensors or raise."""
    arrs = [torch.as_tensor(a) for a in _inputs(37, 13, 1)]
    with pytest.raises(ValueError, match="bwd_backend"):
        ops.kfu(*arrs[:4], bwd_backend="triton")
    X = arrs[0].clone().requires_grad_(True)
    out = ops.kfu(X, *arrs[1:4], bwd_backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        out.sum().backward()
    with pytest.raises(ValueError, match="CUDA"):
        tkfu.kfu_cuda(*arrs[:4])
    with pytest.raises(ValueError, match="CUDA"):
        tss.kfu_bwd_cuda(*arrs)


# ---------------------------------------------------------------------------
# the exact statistics, the streaming engine and the facade
# ---------------------------------------------------------------------------

def _stats_data(N=53, M=11, Q=2, D=3, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(N, Q)), rng.normal(size=(N, D)),
            1.1 * rng.normal(size=(M, Q)))
    kern = {"log_variance": np.log(1.3),
            "log_lengthscale": np.log(rng.uniform(0.6, 1.4, Q))}
    return arrs, kern


@pytest.mark.parametrize("chunk", (None, 16))
def test_exact_stats_through_pallas_match_jax_and_the_fused_op(chunk):
    arrs, kern = _stats_data()
    jk = {k: jnp.asarray(v) for k, v in kern.items()}
    want = (jps.exact_stats_rbf(jk, *map(jnp.asarray, arrs), backend="pallas")
            if chunk is None else
            jsuff_stats(jget("rbf")(2), jk, JExactBatch(*map(jnp.asarray, arrs)),
                        backend="pallas", chunk=chunk))
    tk = {k: torch.as_tensor(v) for k, v in kern.items()}
    targs = tuple(map(torch.as_tensor, arrs))
    got = suff_stats(get("rbf")(2), tk, ExactBatch(*targs), backend="pallas",
                     chunk=chunk)
    fused = tps.exact_stats_rbf(tk, *targs, backend="fused")
    for name, g, w, f in zip(tps.SuffStats._fields, got, want, fused):
        assert g.dtype == torch.float64, name
        assert _rel(g, w) <= RTOL, name
        assert _rel(g, f) <= RTOL, name


def test_streaming_exact_pallas_chunks_are_checkpointed(monkeypatch):
    """Each pallas chunk is checkpointed: its K_fu forward runs again in the
    backward pass, and the gradients equal the one-shot op's."""
    arrs, kern = _stats_data(N=300, M=9, Q=1)
    X, Y, Z = (torch.as_tensor(a).requires_grad_(i != 1) for i, a in enumerate(arrs))
    chunk = 64
    calls = [0]
    plain = ops.kfu_plain

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "kfu_plain", counted)
    params = {k: torch.as_tensor(v).requires_grad_(True) for k, v in kern.items()}

    def objective(c):
        st = (streaming_suff_stats(get("rbf")(1), params, ExactBatch(X, Y, Z),
                                   backend="pallas", chunk=c) if c
              else suff_stats(get("rbf")(1), params, ExactBatch(X, Y, Z),
                              backend="pallas"))
        return st.psi2.sum() + (st.psiY ** 2).sum()

    leaves = (X, Z, *params.values())
    grads = torch.autograd.grad(objective(chunk), leaves)
    assert calls[0] == 2 * -(-X.shape[0] // chunk)
    want = torch.autograd.grad(objective(None), leaves)
    for a, b in zip(grads, want):
        assert _rel(a, b) <= RTOL


def _sgpr_data(N=64, seed=1):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-4.0, 4.0, (N, 1)), axis=0)
    return X, np.sin(X) + 0.1 * rng.normal(size=(N, 1))


def test_sgpr_pallas_fit_matches_jax_and_serves():
    """Three Adam steps of both packages' regression facades through
    backend="pallas" from the same parameters (the reference's mixed
    dtypes: float32 kernel leaves; losses and parameters to 1e-5, as the
    fused fits in test_torch_models.py), then the fitted model registered
    and served."""
    X, Y = _sgpr_data()
    p = {"kern": {"log_variance": np.float32(0.0),
                  "log_lengthscale": np.zeros(1, np.float32)},
         "Z": np.linspace(-3.5, 3.5, 8)[:, None], "log_beta": np.float64(2.0)}
    jm = JSparseGPRegression(kernel=jget("rbf")(1), M=8, backend="pallas").fit(
        jnp.asarray(X), jnp.asarray(Y), steps=3, log_every=1,
        params=jax.tree.map(jnp.asarray, p))
    tm = SparseGPRegression(M=8, backend="pallas", device="cpu").fit(
        X, Y, steps=3, log_every=1, params=convert.params_from_numpy(p, device="cpu"))
    assert len(tm.history) == 3 and tm.history[-1] < tm.history[0]
    np.testing.assert_allclose(tm.history, jm.history, rtol=1e-5)
    paths, leaves = flatten(tm.params)
    for path, g, w in zip(paths, leaves, jax.tree.leaves(jm.params)):
        assert str(g.dtype).removeprefix("torch.") == np.asarray(w).dtype.name, path
        assert _rel(g, w) <= 1e-5, path
    Xt = np.linspace(-3.0, 3.0, 7)[:, None]
    for g, w in zip(tm.predict(Xt), jm.predict(jnp.asarray(Xt))):
        assert _rel(g, w) <= 1e-5
    with GPServer(device="cpu") as srv:
        srv.register("sgpr", tm)
        got = srv.predict("sgpr", torch.as_tensor(Xt))
    for g, w in zip(got, tm.predict(Xt)):
        assert _rel(g, w) <= 1e-12
