"""The port's reverse pass of the fused statistics (`suffstats_vjp_plain`,
the op's backward) and the checkpointed chunk loops, on the CPU.

Against the JAX reference: the plain reverse pass vs `suffstats_vjp_jnp`
and vs the reverse Pallas kernel in interpret mode (as the reference's own
tests run it), and vs torch autograd of the plain forward. Inputs are
float64 from numpy seeds, held to 1e-10 relative to max|reference| per
output. The CUDA reverse kernel runs only on the card
(tests/test_torch_cuda.py, `-m cuda`); here its wrapper and the op's
kernel-only backend are checked to refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks

from repro.kernels.suffstats import suffstats_bwd_pallas, suffstats_vjp_jnp
from repro_torch.core import psi_stats as tps
from repro_torch.gp import (ExactBatch, ExpectedBatch, get, streaming_suff_stats,
                            suff_stats)
from repro_torch.kernels import ops
from repro_torch.kernels import suffstats as tss

RTOL = 1e-10

# (N, M, Q, S > 0): N ragged against the reference's 32-row tile and the
# plain pass's 512-point chunk (and N = 1), M ragged, Q in {1, 3}, S = 0
# (the exact path) and S > 0; N <= 64 keeps the interpret-mode kernel short
CASES = [(1, 5, 1, True), (37, 13, 3, True), (37, 16, 1, False),
         (64, 7, 3, False), (50, 16, 1, True)]
OUTPUTS = ("dmu", "dS", "dY", "dZ", "dvariance", "dlengthscale")


def _inputs(N, M, Q, pos_S, D=3, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(N, Q))
    S = rng.uniform(0.05, 0.6, (N, Q)) if pos_S else np.zeros((N, Q))
    return (mu, S, rng.normal(size=(N, D)), 1.2 * rng.normal(size=(M, Q)),
            np.float64(1.3), rng.uniform(0.6, 1.4, Q),
            rng.normal(size=(M, M)), rng.normal(size=(M, D)))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _case_id(c):
    return f"N{c[0]}-M{c[1]}-Q{c[2]}-{'S' if c[3] else 'S0'}"


JAX_FNS = {
    "vjp_jnp": suffstats_vjp_jnp,
    "pallas_interpret": lambda *a: suffstats_bwd_pallas(*a, interpret=True),
}


@pytest.mark.parametrize("jax_fn", sorted(JAX_FNS))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_vjp_matches_jax(case, jax_fn):
    arrs = _inputs(*case)
    want = JAX_FNS[jax_fn](*map(jnp.asarray, arrs))
    got = tss.suffstats_vjp_plain(*map(torch.as_tensor, arrs))
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == torch.float64, name
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("case", CASES[1:3], ids=_case_id)
def test_plain_vjp_matches_autograd_of_the_plain_forward(case):
    arrs = [torch.as_tensor(a) for a in _inputs(*case)]
    leaves = [a.clone().requires_grad_(True) for a in arrs[:6]]
    psi2, psiY = tss.suffstats_fused_plain(*leaves)
    want = torch.autograd.grad((psi2 * arrs[6]).sum() + (psiY * arrs[7]).sum(),
                               leaves)
    got = tss.suffstats_vjp_plain(*arrs)
    for name, g, w in zip(OUTPUTS, got, want):
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("chunk", (1, 7, 64))
def test_plain_vjp_is_chunk_independent(chunk):
    arrs = [torch.as_tensor(a) for a in _inputs(50, 16, 1, True)]
    base = tss.suffstats_vjp_plain(*arrs)
    for g, w in zip(tss.suffstats_vjp_plain(*arrs, chunk=chunk), base):
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("bwd_backend", ("auto", "jnp"))
def test_ops_backward_on_cpu_is_the_plain_reverse_pass(bwd_backend):
    arrs = [torch.as_tensor(a) for a in _inputs(37, 13, 3, True)]
    leaves = [a.clone().requires_grad_(True) for a in arrs[:6]]
    before = tss.BWD_LAUNCHES
    psi2, psiY = ops.suffstats(*leaves, bwd_backend=bwd_backend)
    grads = torch.autograd.grad((psi2 * arrs[6]).sum() + (psiY * arrs[7]).sum(),
                                leaves)
    for g, w in zip(grads, tss.suffstats_vjp_plain(*arrs)):
        assert torch.equal(g, w)
    assert tss.BWD_LAUNCHES == before  # the kernel was not involved


def test_ops_backward_returns_none_for_inputs_without_grad():
    arrs = [torch.as_tensor(a) for a in _inputs(37, 13, 1, False)]
    mu = arrs[0].clone().requires_grad_(True)
    psi2, psiY = ops.suffstats(mu, *arrs[1:6])
    (g,) = torch.autograd.grad((psi2 * arrs[6]).sum() + (psiY * arrs[7]).sum(), mu)
    assert _rel(g, tss.suffstats_vjp_plain(*arrs)[0]) <= RTOL


def test_kernel_only_backward_refuses_cpu_tensors():
    """No fallback: bwd_backend="pallas" means the reverse kernel, which
    has no CPU mode, and its wrapper takes CUDA tensors or raises."""
    arrs = [torch.as_tensor(a) for a in _inputs(37, 13, 1, True)]
    mu = arrs[0].clone().requires_grad_(True)
    psi2, _ = ops.suffstats(mu, *arrs[1:6], bwd_backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        psi2.sum().backward()
    before = tss.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tss.suffstats_bwd_cuda(*arrs)
    assert tss.BWD_LAUNCHES == before


@pytest.mark.parametrize("shape", ((1_000_000, 100), (100_003, 256), (1, 5)))
def test_bwd_splits_depend_on_shape_only(shape):
    N, M = shape
    geo = tss.Geometry(pairs_per_block=1024, blocks_per_sm=2, run=32, group=4)
    P2, PZ = tss.bwd_splits(N, M, geo, 132)
    assert (P2, PZ) == tss.bwd_splits(N, M, geo, 132) and P2 >= 1 and PZ >= 1
    assert P2 == 1 or N // P2 >= geo.run
    assert PZ == 1 or N // PZ >= tss.Z_STAGE


# ---------------------------------------------------------------------------
# checkpointed chunk loops: same values and gradients, O(chunk) saved
# ---------------------------------------------------------------------------

def _saved_bytes(fn):
    """(result, total bytes autograd saves for backward outside any
    checkpointed region)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


def _lvm_leaves(N=2048, M=16, Q=1, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a).requires_grad_(True) for a in
            (rng.normal(size=(N, Q)), rng.uniform(0.05, 0.5, (N, Q)),
             1.5 * rng.normal(size=(M, Q)), np.float64(0.9),
             rng.uniform(0.7, 1.3, Q))]


def test_chunked_psi2_gradients_match_and_save_o_chunk():
    mu, S, Z, v, l = _lvm_leaves()
    N, M, chunk = mu.shape[0], Z.shape[0], 128
    g = torch.as_tensor(np.random.default_rng(4).normal(size=(M, M)))

    def run(c):
        psi2 = tps._psi2_rbf_chunked(mu, S, Z, v, l, chunk=c)
        return psi2, (psi2 * g).sum()

    (psi2, obj), saved = _saved_bytes(lambda: run(chunk))
    grads = torch.autograd.grad(obj, (mu, S, Z, v, l))
    want_psi2, want_obj = run(N)  # one chunk: the unchunked evaluation
    want = torch.autograd.grad(want_obj, (mu, S, Z, v, l))
    assert _rel(psi2.detach(), want_psi2.detach()) <= RTOL
    for a, b in zip(grads, want):
        assert _rel(a, b) <= RTOL
    # the chunks' (chunk, M, M) intermediates are recomputed, not kept
    assert saved < 8 * N * M * M / 16
    assert saved <= 8 * (4 * chunk * M * M + 16 * N + 64 * M * M)


@pytest.mark.parametrize("kind", ("exact", "expected"))
def test_streaming_stats_gradients_match_and_save_o_chunk(kind):
    mu, S, Z, v, l = _lvm_leaves(N=1000)
    N, M, chunk = mu.shape[0], Z.shape[0], 96
    Y = torch.as_tensor(np.random.default_rng(5).normal(size=(N, 2)))
    kern = get("rbf")(1)
    batch = (ExactBatch(mu, Y, Z) if kind == "exact"
             else ExpectedBatch(mu, S, Y, Z))

    def objective(c):
        params = {"log_variance": torch.log(v), "log_lengthscale": torch.log(l)}
        st = suff_stats(kern, params, batch, chunk=c)
        return st.psi0 + st.psi2.sum() + (st.psiY ** 2).sum()

    obj, saved = _saved_bytes(lambda: objective(chunk))
    leaves = (mu, S, Z, v, l) if kind == "expected" else (mu, Z, v, l)
    grads = torch.autograd.grad(obj, leaves)
    want = torch.autograd.grad(objective(None), leaves)
    for a, b in zip(grads, want):
        assert _rel(a, b) <= RTOL
    assert saved <= 8 * (4 * chunk * M * M + 16 * N + 64 * M * M)


def test_streaming_fused_stats_run_the_op_once_per_chunk(monkeypatch):
    """The fused op saves only its inputs, so its chunks are not
    checkpointed: forward and backward run its forward once per chunk, and
    the gradients equal the one-shot op's."""
    mu, S, Z, v, l = _lvm_leaves(N=1000)
    N, chunk = mu.shape[0], 96
    Y = torch.as_tensor(np.random.default_rng(5).normal(size=(N, 2)))
    kern = get("rbf")(1)
    calls = [0]
    plain = ops.suffstats_fused_plain

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "suffstats_fused_plain", counted)

    def objective(stream):
        params = {"log_variance": torch.log(v), "log_lengthscale": torch.log(l)}
        batch = ExpectedBatch(mu, S, Y, Z)
        st = (streaming_suff_stats(kern, params, batch, backend="fused", chunk=chunk)
              if stream else suff_stats(kern, params, batch, backend="fused"))
        return st.psi2.sum() + (st.psiY ** 2).sum()

    leaves = (mu, S, Z, v, l)
    grads = torch.autograd.grad(objective(True), leaves)
    assert calls[0] == -(-N // chunk)
    want = torch.autograd.grad(objective(False), leaves)
    for a, b in zip(grads, want):
        assert _rel(a, b) <= RTOL
