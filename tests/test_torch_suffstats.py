"""The port's fused statistics op (`repro_torch.kernels`) against the JAX
reference: the plain version vs the reference's Pallas kernel (interpret
mode, as the reference's own tests run it) and its streaming jnp twin,
the torch oracles vs the JAX oracles, the op's device dispatch and its
differentiable contract. Inputs come from numpy seeds; everything is
float64 and held to 1e-10 relative to max|reference| (a float32 cotangent
of a mixed-dtype call to 1e-6: it is the float64 value rounded).

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
`-m cuda`); here its wrapper is checked to refuse CPU tensors rather than
fall back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ops as jops
from repro.kernels.suffstats import (suffstats_fused_jnp, suffstats_pallas,
                                     suffstats_vjp_jnp)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import suffstats as tss

RTOL = 1e-10

# (N, M, Q, S > 0): each of N in {1, 37, 300} (ragged against the 32-row
# tile), M in {5, 130} (130 crosses a 128 tile), Q in {1, 3} and S = 0 /
# S > 0 appears, pairwise with the others
CASES = [
    (1, 5, 1, False), (1, 130, 3, True), (37, 5, 3, True),
    (37, 130, 1, False), (300, 5, 1, True), (300, 130, 3, False),
    (300, 130, 1, True), (37, 130, 3, True),
]
JAX_FNS = {
    "pallas_interpret": lambda *a: suffstats_pallas(*a, interpret=True),
    "fused_jnp": suffstats_fused_jnp,
}


def _inputs(N, M, Q, pos_S, D=3, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(N, Q))
    S = rng.uniform(0.05, 0.6, (N, Q)) if pos_S else np.zeros((N, Q))
    Y = rng.normal(size=(N, D))
    Z = 1.2 * rng.normal(size=(M, Q))
    return mu, S, Y, Z, np.float64(1.3), rng.uniform(0.6, 1.4, Q)


def _torch(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _case_id(c):
    return f"N{c[0]}-M{c[1]}-Q{c[2]}-{'S' if c[3] else 'S0'}"


@pytest.mark.parametrize("jax_fn", sorted(JAX_FNS))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_fused_matches_jax(case, jax_fn):
    arrs = _inputs(*case)
    want = JAX_FNS[jax_fn](*map(jnp.asarray, arrs))
    got = tss.suffstats_fused_plain(*_torch(arrs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("chunk", (1, 7, 64, 4096))
def test_plain_fused_is_chunk_independent(chunk):
    arrs = _torch(_inputs(300, 130, 3, True))
    base = tss.suffstats_fused_plain(*arrs)
    got = tss.suffstats_fused_plain(*arrs, chunk=chunk)
    for g, w in zip(got, base):
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("pos_S", (False, True))
def test_plain_fused_matches_torch_oracles(pos_S):
    mu, S, Y, Z, v, l = _torch(_inputs(37, 130, 3, pos_S))
    psi2, psiY = tss.suffstats_fused_plain(mu, S, Y, Z, v, l)
    assert _rel(psi2, tref.psi2_rbf(mu, S, Z, v, l)) <= RTOL
    assert _rel(psiY, tref.psi1_rbf(mu, S, Z, v, l).T @ Y) <= RTOL


@pytest.mark.parametrize("name", ("kfu", "psi0", "psi1", "psi2_n", "psi2"))
def test_torch_oracles_match_jax_oracles(name):
    mu, S, _, Z, v, l = _inputs(37, 13, 3, True)
    args = {"kfu": (mu, Z, v, l), "psi0": (mu, S, v, l)}.get(
        name, (mu, S, Z, v, l))
    want = getattr(jref, f"{name}_rbf")(*map(jnp.asarray, args))
    got = getattr(tref, f"{name}_rbf")(*_torch(args))
    assert _rel(got, want) <= RTOL


def test_ops_suffstats_runs_the_plain_version_on_cpu():
    arrs = _torch(_inputs(300, 130, 3, True))
    before = tss.LAUNCHES
    got = ops.suffstats(*arrs)
    want = tss.suffstats_fused_plain(*arrs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tss.LAUNCHES == before  # the kernel was not involved


def _cotangents(M, D=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(M, M)), rng.normal(size=(M, D))


def test_ops_suffstats_backward_matches_jax_vjp():
    """The op's backward on the CPU (the plain reverse pass) against the
    reference's streaming reverse pass."""
    arrs = _inputs(37, 13, 3, True)
    g2, gY = _cotangents(13)
    want = suffstats_vjp_jnp(*map(jnp.asarray, (*arrs, g2, gY)))
    leaves = [a.requires_grad_(True) for a in _torch(arrs)]
    psi2, psiY = ops.suffstats(*leaves)
    ((psi2 * torch.as_tensor(g2)).sum() + (psiY * torch.as_tensor(gY)).sum()).backward()
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= RTOL


def test_ops_suffstats_takes_mixed_dtypes():
    """The GP-LVM facade's mix (float64 mu, Y, Z; float32 S, variance,
    lengthscale) goes through: the op computes in mu's dtype, like the
    reference, and returns each cotangent in its own input's dtype."""
    mu, S, Y, Z, v, l = _inputs(37, 13, 1, True)
    mixed = (mu, S.astype(np.float32), Y, Z, np.float32(v), l.astype(np.float32))
    g2, gY = _cotangents(13)

    def scalar(*x):
        psi2, psiY = jops.suffstats(*x)
        return jnp.sum(psi2 * g2) + jnp.sum(psiY * gY)

    want_out = suffstats_pallas(*map(jnp.asarray, mixed), interpret=True)
    want = jax.grad(scalar, argnums=tuple(range(6)))(*map(jnp.asarray, mixed))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in mixed]
    out = ops.suffstats(*leaves)
    for o, w in zip(out, want_out):
        assert o.dtype == torch.float64 and _rel(o.detach(), w) <= RTOL
    grads = torch.autograd.grad((out[0] * torch.as_tensor(g2)).sum()
                                + (out[1] * torch.as_tensor(gY)).sum(), leaves)
    for g, leaf, w in zip(grads, leaves, want):
        assert g.dtype == leaf.dtype == torch.from_numpy(np.array(w)).dtype
        assert _rel(g.double(), w) <= (RTOL if g.dtype == torch.float64 else 1e-6)


def test_ops_suffstats_validates_bwd_backend():
    with pytest.raises(ValueError, match="bwd_backend"):
        ops.suffstats(*_torch(_inputs(1, 5, 1, False)), bwd_backend="xla")


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper takes CUDA tensors or raises."""
    before = tss.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tss.suffstats_cuda(*_torch(_inputs(37, 5, 1, True)))
    assert tss.LAUNCHES == before


@pytest.mark.parametrize("shape", ((1_000_000, 100, 3), (100_003, 256, 5),
                                   (37, 5, 3), (0, 130, 1)))
def test_splits_fill_the_card_and_depend_on_shape_only(shape):
    """The psi2 N-splits keep the pair blocks in one wave of the resident
    blocks (here 4 a multiprocessor on 132), at least 2 a multiprocessor at
    the paper's shape; the psiY splits about TARGET_BLOCKS blocks."""
    N, M, D = shape
    geo = tss.Geometry(pairs_per_block=1024, blocks_per_sm=4, run=128, group=1)
    P2, PY = tss.splits(N, M, D, geo, 132)
    assert P2 >= 1 and PY >= 1
    assert tss.splits(N, M, D, geo, 132) == (P2, PY)
    blocks2 = tss.pair_blocks(M, geo.pairs_per_block) * P2
    assert P2 == 1 or blocks2 <= 4 * 132  # one wave
    if N >= 1_000_000:  # the paper's shape: at least 2 blocks per SM
        assert blocks2 >= 2 * 132
    # no N-split shorter than one staging run (except a lone one)
    assert P2 == 1 or N // P2 >= geo.run
    assert PY == 1 or N // PY >= tss.Y_STAGE


def test_build_key_covers_the_source_and_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is rebuilt when its source or a shared header
    changes, and its name is the same while neither does."""
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    source, header = csrc / "k.cu", csrc / "common.cuh"
    source.write_text('#include "common.cuh"\n')
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {"k": source})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._target("k")
    assert _build._target("k") == first
    header.write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    source.write_text('#include "common.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)
