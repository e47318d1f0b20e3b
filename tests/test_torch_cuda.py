"""Card-only tests of the port's CUDA kernels (marker `cuda`): each kernel
(the fused forward and reverse, psi1 and psi2 and their reverses, K_fu and
its reverse through the psi1 reverse kernel) against its plain PyTorch
version on the card. Imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which such a machine
need not have.)

Elsewhere every test skips. Float64 kernel within 1e-10 and float32 within
1e-4 of the float64 plain version, relative to max|plain| per output
(float32 sums ~1e4 terms per thread in another order). Every kernel is
held to be bitwise reproducible.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kfu as kf
from repro_torch.kernels import ops
from repro_torch.kernels import psi1 as p1
from repro_torch.kernels import psi2 as p2
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


# ---------------------------------------------------------------------------
# the single-statistic kernels: psi1, psi2 and their reverse passes
# ---------------------------------------------------------------------------

def _single(case, seed=2):
    """(mu, S, Z, variance, lengthscale, g (N, M), g2 (M, M)) for `case`."""
    N, M, Q, _, pos_S = case
    mu, S, _, Z, v, l = _inputs(N, M, Q, 1, pos_S)
    rng = np.random.default_rng(seed)
    return [mu, S, Z, v, l, torch.as_tensor(rng.normal(size=(N, M))),
            torch.as_tensor(rng.normal(size=(M, M)))]


SINGLE = {  # name: (kernel wrapper, plain version, cotangent index or None, counter)
    "psi1": (p1.psi1_cuda, p1.psi1_plain, None, (p1, "LAUNCHES")),
    "psi2": (p2.psi2_cuda, p2.psi2_plain, None, (p2, "LAUNCHES")),
    "psi1_bwd": (ss.psi1_bwd_cuda, ss.psi1_vjp_plain, 5, (ss, "PSI1_BWD_LAUNCHES")),
    "psi2_bwd": (ss.psi2_bwd_cuda, ss.psi2_vjp_plain, 6, (ss, "PSI2_BWD_LAUNCHES")),
}


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_stat_kernel_matches_plain(card, name, case, dtype):
    kernel, plain, gi, (module, counter) = SINGLE[name]
    arrs = _single(case)
    args = arrs[:5] + ([] if gi is None else [arrs[gi]])
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    dev = [a.to(card, dtype) for a in args]
    before = getattr(module, counter)
    got, again = kernel(*dev), kernel(*dev)
    torch.cuda.synchronize()
    assert getattr(module, counter) == before + 2
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.equal(g, a)  # bitwise reproducible
        assert _rel(g, w) <= TOL[dtype]


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_stat_wrappers_refuse_what_the_kernel_does_not_take(card, name):
    kernel, _, gi, (module, counter) = SINGLE[name]
    arrs = [a.to(card) for a in _single((37, 5, 2, 3, True))]
    args = arrs[:5] + ([] if gi is None else [arrs[gi]])
    before = getattr(module, counter)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernel(*(a.half() for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        kernel(args[0].T.contiguous().T, *args[1:])
    with pytest.raises(ValueError, match="shape"):
        kernel(args[0], args[1][:-1], *args[2:])
    with pytest.raises(ValueError, match="float64 on"):
        kernel(*args[:2], args[2].cpu(), *args[3:])
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*(a.cpu() for a in args))
    if gi is not None:
        with pytest.raises(ValueError, match="shape"):
            kernel(*args[:5], args[5][:, :-1])
    assert getattr(module, counter) == before


@pytest.mark.parametrize("stat", ("psi1", "psi2"))
def test_single_stat_ops_route_cuda_tensors_to_the_kernels(card, stat):
    """The GP-LVM facade's mix (float64 mu and Z; float32 S, variance and
    lengthscale): forward and reverse through the kernels, each cotangent
    in its own input's dtype, against the plain reverse pass."""
    arrs = _single((300, 33, 2, 3, True))
    g = arrs[5] if stat == "psi1" else arrs[6]
    op = ops.psi1 if stat == "psi1" else ops.psi2
    fwd = (p1, "LAUNCHES") if stat == "psi1" else (p2, "LAUNCHES")
    bwd = "PSI1_BWD_LAUNCHES" if stat == "psi1" else "PSI2_BWD_LAUNCHES"
    plain = ss.psi1_vjp_plain if stat == "psi1" else ss.psi2_vjp_plain
    mu, S, Z, v, l = arrs[:5]
    want = plain(mu, S.float().double(), Z, v.float().double(), l.float().double(), g)
    leaves = [a.to(card).requires_grad_(True) for a in
              (mu, S.float(), Z, v.float(), l.float())]
    before = (getattr(*fwd), getattr(ss, bwd))
    out = op(*leaves)
    grads = torch.autograd.grad((out * g.to(card)).sum(), leaves)
    torch.cuda.synchronize()
    assert (getattr(*fwd), getattr(ss, bwd)) == (before[0] + 1, before[1] + 1)
    for a, leaf, w in zip(grads, leaves, want):
        assert a.dtype == leaf.dtype
        assert _rel(a, w) <= TOL[leaf.dtype]


# ---------------------------------------------------------------------------
# K_fu (B7) and its reverse pass (B6 at S = 0)
# ---------------------------------------------------------------------------

def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _kfu_args(case):
    """(X, Z, variance, lengthscale, g (N, M)) for `case`."""
    X, _, Z, v, l, g, _ = _single(case)
    return [X, Z, v, l, g]


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("direction", ("fwd", "bwd"))
def test_kfu_kernel_matches_plain(card, direction, case, dtype):
    args = _kfu_args(case)
    if direction == "fwd":
        args, kernel, plain, counter = args[:4], kf.kfu_cuda, kf.kfu_plain, (kf, "LAUNCHES")
    else:
        kernel, plain, counter = ss.kfu_bwd_cuda, ss.kfu_vjp_plain, (ss, "PSI1_BWD_LAUNCHES")
    want = _as_tuple(plain(*args))
    dev = [a.to(card, dtype) for a in args]
    before = getattr(*counter)
    got, again = _as_tuple(kernel(*dev)), _as_tuple(kernel(*dev))
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 2
    assert len(got) == len(want)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.equal(g, a)  # bitwise reproducible
        assert _rel(g, w) <= TOL[dtype]



def test_kfu_wrapper_refuses_what_the_kernel_does_not_take(card):
    X, Z, v, l, g = [a.to(card) for a in _kfu_args((37, 5, 2, 3, False))]
    before = kf.LAUNCHES
    with pytest.raises(ValueError, match="float32 or float64"):
        kf.kfu_cuda(X.half(), Z.half(), v.half(), l.half())
    with pytest.raises(ValueError, match="contiguous"):
        kf.kfu_cuda(X.T.contiguous().T, Z, v, l)
    with pytest.raises(ValueError, match="shape"):
        kf.kfu_cuda(X, Z[:, :1], v, l)
    with pytest.raises(ValueError, match="float64 on"):
        kf.kfu_cuda(X, Z.cpu(), v, l)
    with pytest.raises(ValueError, match="CUDA"):
        kf.kfu_cuda(*(a.cpu() for a in (X, Z, v, l)))
    with pytest.raises(ValueError, match="shape"):
        ss.kfu_bwd_cuda(X, Z, v, l, g[:, :-1])
    assert kf.LAUNCHES == before


def test_ops_kfu_routes_cuda_tensors_to_the_kernels(card):
    """The regression facade's mix (float64 X and Z; float32 variance and
    lengthscale): forward through B7 and reverse through B6, one launch
    each, each cotangent in its own input's dtype, against the plain
    reverse pass."""
    X, Z, v, l, g = _kfu_args((300, 33, 2, 3, False))
    want = ss.kfu_vjp_plain(X, Z, v.float().double(), l.float().double(), g)
    leaves = [a.to(card).requires_grad_(True) for a in (X, Z, v.float(), l.float())]
    before = (kf.LAUNCHES, ss.PSI1_BWD_LAUNCHES, p1.LAUNCHES)
    out = ops.kfu(*leaves)
    grads = torch.autograd.grad((out * g.to(card)).sum(), leaves)
    torch.cuda.synchronize()
    assert (kf.LAUNCHES, ss.PSI1_BWD_LAUNCHES, p1.LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    for a, leaf, w in zip(grads, leaves, want):
        assert a.dtype == leaf.dtype
        assert _rel(a, w) <= TOL[leaf.dtype]

