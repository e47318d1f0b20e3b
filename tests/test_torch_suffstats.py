"""The port's fused statistics op (`repro_torch.kernels`) against the JAX
reference: the plain version vs the reference's Pallas kernel (interpret
mode, as the reference's own tests run it) and its streaming jnp twin,
the torch oracles vs the JAX oracles, the op's device dispatch and its
forward-only contract. Inputs come from numpy seeds; everything is
float64 and held to 1e-10 relative to max|reference|.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
`-m cuda`); here its wrapper is checked to refuse CPU tensors rather than
fall back.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.suffstats import suffstats_fused_jnp, suffstats_pallas
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


def test_ops_suffstats_is_forward_only():
    mu, S, Y, Z, v, l = _torch(_inputs(37, 5, 1, True))
    mu.requires_grad_(True)
    psi2, psiY = ops.suffstats(mu, S, Y, Z, v, l)
    with pytest.raises(NotImplementedError, match="training slice"):
        (psi2.sum() + psiY.sum()).backward()


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
    N, M, D = shape
    P2, PY = tss.splits(N, M, D)
    assert P2 >= 1 and PY >= 1
    assert tss.splits(N, M, D) == (P2, PY)
    tiles = -(-M // tss.TILE)
    blocks2 = tiles * (tiles + 1) // 2 * P2
    if N >= 1_000_000:  # the paper's shape: at least 2 blocks per SM
        assert blocks2 >= 2 * 132
    # no N-split shorter than one staging run (except a lone one)
    assert P2 == 1 or N // P2 >= tss.STAGE
    assert PY == 1 or N // PY >= tss.Y_STAGE
