"""Card-only tests of the port's CUDA kernels (marker `cuda`): each kernel
against its plain PyTorch version on the card. Imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which such a machine
need not have.)

Elsewhere every test skips. Float64 kernel within 1e-10 and float32 within
1e-4 of the float64 plain version, relative to max|plain| per output
(float32 sums ~1e4 terms per thread in another order). Both kernels are
held to be bitwise reproducible.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import suffstats as ss

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# (N, M, Q, D, S > 0): ragged N and M, every compile-time Q (1..4) and the
# run-time-Q instance (Q = 7), a D that spans two psiY column tiles
CASES = [(1, 5, 1, 3, False), (37, 130, 3, 3, True), (300, 33, 2, 9, True),
         (4099, 100, 1, 3, True), (4099, 100, 1, 3, False),
         (2050, 64, 4, 5, True), (513, 70, 7, 2, True)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(N, M, Q, D, pos_S, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(N, Q))
    S = rng.uniform(0.05, 0.6, (N, Q)) if pos_S else np.zeros((N, Q))
    return [torch.as_tensor(a) for a in
            (mu, S, rng.normal(size=(N, D)), 1.2 * rng.normal(size=(M, Q)),
             np.float64(1.3), rng.uniform(0.6, 1.4, Q))]


def _rel(got, want) -> float:
    return float((got.double().cpu() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_suffstats_kernel_matches_plain(card, case, dtype):
    arrs = _inputs(*case)
    want = ss.suffstats_fused_plain(*arrs)
    dev = [a.to(card, dtype) for a in arrs]
    before = ss.LAUNCHES
    got = ss.suffstats_cuda(*dev)
    again = ss.suffstats_cuda(*dev)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # bitwise reproducible
        assert _rel(g, w) <= TOL[dtype]


def test_ops_routes_cuda_tensors_to_the_kernel(card):
    dev = [a.to(card) for a in _inputs(300, 33, 2, 3, True)]
    before = ss.LAUNCHES
    ops.suffstats(*dev)
    assert ss.LAUNCHES == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    mu, S, Y, Z, v, l = [a.to(card) for a in _inputs(37, 5, 1, 3, True)]
    with pytest.raises(ValueError, match="float32 or float64"):
        ss.suffstats_cuda(mu.half(), S.half(), Y.half(), Z.half(), v.half(), l.half())
    with pytest.raises(ValueError, match="contiguous"):
        ss.suffstats_cuda(mu, S, Y.T.contiguous().T, Z, v, l)
    with pytest.raises(ValueError, match="shape"):
        ss.suffstats_cuda(mu, S[:-1], Y, Z, v, l)
    with pytest.raises(ValueError, match="float64 on"):
        ss.suffstats_cuda(mu, S, Y, Z.cpu(), v, l)


def _cotangents(M, D, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a) for a in (rng.normal(size=(M, M)),
                                         rng.normal(size=(M, D)))]


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_suffstats_bwd_kernel_matches_plain(card, case, dtype):
    arrs = _inputs(*case) + _cotangents(case[1], case[3])
    want = ss.suffstats_vjp_plain(*arrs)
    dev = [a.to(card, dtype) for a in arrs]
    before = ss.BWD_LAUNCHES
    got = ss.suffstats_bwd_cuda(*dev)
    again = ss.suffstats_bwd_cuda(*dev)
    torch.cuda.synchronize()
    assert ss.BWD_LAUNCHES == before + 2
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.equal(g, a)  # bitwise reproducible
        assert _rel(g, w) <= TOL[dtype]


def test_ops_backward_runs_the_kernel_with_mixed_dtypes(card):
    """The GP-LVM facade's mix: float64 mu, Y, Z; float32 S, variance and
    lengthscale. The op computes in mu's dtype, backward through the
    kernel, and hands each cotangent back in its own input's dtype."""
    mu, S, Y, Z, v, l = _inputs(300, 33, 2, 3, True)
    g2, gY = _cotangents(33, 3)
    want = ss.suffstats_vjp_plain(mu, S.float().double(), Y, Z,
                                  v.float().double(), l.float().double(), g2, gY)
    leaves = [a.to(card).requires_grad_(True) for a in
              (mu, S.float(), Y, Z, v.float(), l.float())]
    before = (ss.LAUNCHES, ss.BWD_LAUNCHES)
    psi2, psiY = ops.suffstats(*leaves)
    grads = torch.autograd.grad((psi2 * g2.to(card)).sum()
                                + (psiY * gY.to(card)).sum(), leaves)
    torch.cuda.synchronize()
    assert (ss.LAUNCHES, ss.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for g, leaf, w in zip(grads, leaves, want):
        assert g.dtype == leaf.dtype
        assert _rel(g, w) <= TOL[leaf.dtype]


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(card):
    arrs = [a.to(card) for a in _inputs(37, 5, 1, 3, True) + _cotangents(5, 3)]
    with pytest.raises(ValueError, match="shape"):
        ss.suffstats_bwd_cuda(*arrs[:6], arrs[6][:, :4], arrs[7])
    with pytest.raises(ValueError, match="float64 on"):
        ss.suffstats_bwd_cuda(*arrs[:7], arrs[7].float())
    with pytest.raises(ValueError, match="CUDA"):
        ss.suffstats_bwd_cuda(*(a.cpu() for a in arrs))
