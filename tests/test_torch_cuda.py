"""Card-only tests of the port's CUDA kernels (marker `cuda`): each kernel
(the fused forward and reverse, psi1 and psi2 and their reverses, K_fu and
its reverse through the psi1 reverse kernel) against its plain PyTorch
version on the card, and a Product of RBFs through the fused and pallas
statistics (one launch of each kernel per forward and backward); each
kernel at every wave count the tuner may pick, `ops` launching a pinned
`block=` / `bwd_block=`, the tuner on the card, and a budgeted `GPServer`
that evicts and reloads. Imports no JAX, so it runs on a machine that has
only PyTorch:

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


@pytest.fixture(autouse=True)
def untuned(tmp_path, monkeypatch):
    """Every launch at the untuned geometry (one wave) unless a test turns
    the tuner on: tuning off, over a cache file of the test's own."""
    from repro_torch import tune
    from repro_torch.tune import autotune

    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setattr(autotune, "_ENABLED_OVERRIDE", False)
    tune.clear_memo()
    yield
    tune.clear_memo()


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


# (N, M, Q, D): the dry run's M and the second kernel shape's (M, Q), where
# the per-(pair block, point) sums over all of N once grew to within 4x of
# an (N, M) buffer; N ragged, several chunks of the reverse passes
C6_CASES = [(20_011, 128, 1, 3), (20_011, 256, 4, 5)]


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", C6_CASES, ids=str)
@pytest.mark.parametrize("name", ["suffstats_bwd", "psi2_bwd"])
def test_reverse_scratch_has_no_pair_block_factor(card, monkeypatch, name, case, dtype):
    """B2 and B4 allocate no buffer of pair blocks x N elements (one chunk's
    per-point sums, about N (1 + 3Q)), run over several chunks, match their
    plain versions at phase 3's tolerances and repeat bitwise."""
    N, M, Q, D = case
    arrs = _inputs(N, M, Q, D, True) + _cotangents(M, D)
    kernel, plain = ((ss.suffstats_bwd_cuda, ss.suffstats_vjp_plain) if name == "suffstats_bwd"
                     else (ss.psi2_bwd_cuda, ss.psi2_vjp_plain))
    if name == "psi2_bwd":
        arrs = arrs[:2] + arrs[3:7]  # mu, S, Z, variance, lengthscale, g2
    want = plain(*arrs)
    dev = [a.to(card, dtype) for a in arrs]
    shapes, real = [], ss.launch

    def launch(lib, tensors, ints):
        shapes.extend(tuple(t.shape) for t in tensors)
        return real(lib, tensors, ints)

    monkeypatch.setattr(ss, "launch", launch)
    got, again = kernel(*dev), kernel(*dev)
    torch.cuda.synchronize()
    geo, _ = ss.card_geometry(name, dev[0])
    blocks = ss.pair_blocks(M, geo.pairs_per_block)
    chunk = ss.point_chunk(N, M, geo.pairs_per_block)
    assert blocks > 1 and len(ss.chunk_bounds(N, chunk)) > 1
    # the only buffers with a per-point axis are the (N, Q) / (N, D) inputs
    # and cotangents and one chunk's (pair blocks, 1 + 3Q, chunk) sums
    assert (blocks, 1 + 3 * Q, chunk) in shapes and chunk < N
    for shape in shapes:
        if N in shape:
            assert len(shape) == 2 and shape[1] <= max(Q, D), shape
    for g, a, w in zip(got, again, want):
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



# ---------------------------------------------------------------------------
# B1-B4 across the packed pair layout: M on both sides of a pair-block edge
# (1, 33, 100, 257), the compile-time Q classes (1; 4) and the run-time-Q
# instance (5), N from one point to many N-splits, S = 0 and S > 0. The
# plain versions run in float64 on the card.
# ---------------------------------------------------------------------------

PSI2_CASES = [(1, 1, 1, 3, True), (127, 1, 1, 3, False), (100_003, 1, 4, 3, False),
              (127, 33, 4, 3, False), (100_003, 33, 5, 2, True), (1, 100, 5, 3, True),
              (127, 100, 5, 3, False), (100_003, 100, 1, 3, True),
              (100_003, 100, 1, 3, False), (1, 257, 4, 3, False), (127, 257, 5, 2, True),
              (100_003, 257, 4, 5, True)]
PSI2_KERNELS = {  # name: (kernel, plain, arguments of (mu, S, Y, Z, v, l, g2, gY), counter)
    "suffstats_fwd": (ss.suffstats_cuda, ss.suffstats_fused_plain, (0, 1, 2, 3, 4, 5),
                      (ss, "LAUNCHES")),
    "suffstats_bwd": (ss.suffstats_bwd_cuda, ss.suffstats_vjp_plain,
                      (0, 1, 2, 3, 4, 5, 6, 7), (ss, "BWD_LAUNCHES")),
    "psi2_fwd": (p2.psi2_cuda, p2.psi2_plain, (0, 1, 3, 4, 5), (p2, "LAUNCHES")),
    "psi2_bwd": (ss.psi2_bwd_cuda, ss.psi2_vjp_plain, (0, 1, 3, 4, 5, 6),
                 (ss, "PSI2_BWD_LAUNCHES")),
}


def _psi2_args(case, device):
    N, M, _, D, _ = case
    return [a.to(device) for a in _inputs(*case) + _cotangents(M, D)]


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", PSI2_CASES, ids=str)
@pytest.mark.parametrize("name", sorted(PSI2_KERNELS))
def test_psi2_kernels_match_plain_across_the_pair_layout(card, name, case, dtype):
    kernel, plain, idx, (module, counter) = PSI2_KERNELS[name]
    arrs = _psi2_args(case, card)
    args = [arrs[i] for i in idx]
    want = _as_tuple(plain(*args))
    dev = [a.to(dtype) for a in args]
    before = getattr(module, counter)
    got, again = _as_tuple(kernel(*dev)), _as_tuple(kernel(*dev))
    torch.cuda.synchronize()
    assert getattr(module, counter) == before + 2
    assert len(got) == len(want)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, a)  # two launches bitwise equal
        assert _rel(g, w.cpu()) <= TOL[dtype]


@pytest.mark.parametrize("Q", (1, 5))
@pytest.mark.parametrize("bwd_backend", ("auto", "pallas"))
@pytest.mark.parametrize("stat", ("suffstats", "psi2"))
def test_psi2_ops_route_mixed_dtypes_through_the_kernels(card, stat, bwd_backend, Q):
    """The GP-LVM facade's mix (float64 mu, Y and Z; float32 S, variance
    and lengthscale) through `ops.suffstats` / `ops.psi2` at M = 100: one
    forward and one reverse launch, each cotangent in its own input's
    dtype, against the plain reverse pass."""
    case = (300, 100, Q, 3, True)
    mu, S, Y, Z, v, l = _inputs(*case)
    g2, gY = _cotangents(100, 3)
    S32, v32, l32 = S.float(), v.float(), l.float()
    if stat == "suffstats":
        want = ss.suffstats_vjp_plain(mu, S32.double(), Y, Z, v32.double(), l32.double(),
                                      g2, gY)
        leaves = [a.to(card).requires_grad_(True) for a in (mu, S32, Y, Z, v32, l32)]
        counters = ((ss, "LAUNCHES"), (ss, "BWD_LAUNCHES"))
    else:
        want = ss.psi2_vjp_plain(mu, S32.double(), Z, v32.double(), l32.double(), g2)
        leaves = [a.to(card).requires_grad_(True) for a in (mu, S32, Z, v32, l32)]
        counters = ((p2, "LAUNCHES"), (ss, "PSI2_BWD_LAUNCHES"))
    before = [getattr(*c) for c in counters]
    if stat == "suffstats":
        psi2, psiY = ops.suffstats(*leaves, bwd_backend=bwd_backend)
        loss = (psi2 * g2.to(card)).sum() + (psiY * gY.to(card)).sum()
    else:
        loss = (ops.psi2(*leaves, bwd_backend=bwd_backend) * g2.to(card)).sum()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert [getattr(*c) for c in counters] == [b + 1 for b in before]
    for g, leaf, w in zip(grads, leaves, want):
        assert g.dtype == leaf.dtype
        assert _rel(g, w) <= TOL[leaf.dtype]


# ---------------------------------------------------------------------------
# B5, B6 and B7 across their staged spans: the paper's shape, the second
# kernel shape, odd N and M (runs that start on and off 16-byte
# boundaries), a row of M = 1000 doubles that outgrows a stage of the
# reverse kernel (column tiles), one point; B6's fast path (compile-time
# Q, a lane's dZ columns in registers) and its general path (M = 257 at
# Q = 4, M = 1000 in double). The plain versions run in float64 on the
# card.
# ---------------------------------------------------------------------------

SPAN_CASES = [(1_000_003, 100, 1, True), (100_003, 256, 4, True), (1_001, 130, 3, True),
              (4_099, 257, 2, False), (513, 33, 1, True), (5_003, 1_000, 1, True),
              (1, 7, 1, False), (37, 5, 3, True), (3_001, 257, 4, True)]
CROSS_KERNELS = {  # name: (kernel, plain, arguments of (mu, S, Z, v, l, g), counter)
    "psi1_fwd": (p1.psi1_cuda, p1.psi1_plain, (0, 1, 2, 3, 4), (p1, "LAUNCHES")),
    "psi1_bwd": (ss.psi1_bwd_cuda, ss.psi1_vjp_plain, (0, 1, 2, 3, 4, 5),
                 (ss, "PSI1_BWD_LAUNCHES")),
    "kfu_fwd": (kf.kfu_cuda, kf.kfu_plain, (0, 2, 3, 4), (kf, "LAUNCHES")),
    "kfu_bwd": (ss.kfu_bwd_cuda, ss.kfu_vjp_plain, (0, 2, 3, 4, 5), (ss, "PSI1_BWD_LAUNCHES")),
}


def _span_args(case, device, seed=3):
    """(mu, S, Z, variance, lengthscale, g) on `device`; above Q = 16 the
    lengthscales grow with sqrt(Q) so that the statistics stay well above
    underflow."""
    N, M, Q, pos_S = case
    rng = np.random.default_rng(seed)
    spread = np.sqrt(Q) if Q > 16 else 1.0
    arrs = (rng.uniform(-3.0, 3.0, (N, Q)),
            rng.uniform(0.001, 0.05, (N, Q)) if pos_S else np.zeros((N, Q)),
            rng.uniform(-3.0, 3.0, (M, Q)), np.float64(1.3), spread * rng.uniform(0.3, 1.2, Q),
            rng.normal(size=(N, M)))
    return [torch.as_tensor(a, device=device) for a in arrs]


def _held(kernel, plain, args, counter, dtype):
    want = _as_tuple(plain(*args))
    dev = [a.to(dtype) for a in args]
    before = getattr(*counter)
    got, again = _as_tuple(kernel(*dev)), _as_tuple(kernel(*dev))
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 2
    assert len(got) == len(want)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, a)  # two launches bitwise equal
        assert _rel(g, w.cpu()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", SPAN_CASES, ids=str)
@pytest.mark.parametrize("name", sorted(CROSS_KERNELS))
def test_cross_and_psi1_reverse_kernels_match_plain_across_spans(card, name, case, dtype):
    kernel, plain, idx, counter = CROSS_KERNELS[name]
    arrs = _span_args(case, card)
    _held(kernel, plain, [arrs[i] for i in idx], counter, dtype)


# ---------------------------------------------------------------------------
# every kernel above Q = 16: the run-time-Q instances of B1-B4 with their
# wide pair and point passes, B6's chunked moments, B5/B7's run-time Q
# ---------------------------------------------------------------------------

LARGE_Q_KERNELS = {  # name: (kernel, plain, arguments of (mu, S, Y, Z, v, l, g2, gY, g), counter)
    **{k: v for k, v in PSI2_KERNELS.items()},
    "psi1_fwd": (p1.psi1_cuda, p1.psi1_plain, (0, 1, 3, 4, 5), (p1, "LAUNCHES")),
    "psi1_bwd": (ss.psi1_bwd_cuda, ss.psi1_vjp_plain, (0, 1, 3, 4, 5, 8),
                 (ss, "PSI1_BWD_LAUNCHES")),
    "kfu_fwd": (kf.kfu_cuda, kf.kfu_plain, (0, 3, 4, 5), (kf, "LAUNCHES")),
}


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("Q", (17, 32))
@pytest.mark.parametrize("name", sorted(LARGE_Q_KERNELS))
def test_every_kernel_takes_q_above_16(card, name, Q, dtype):
    kernel, plain, idx, counter = LARGE_Q_KERNELS[name]
    N, M, D = 2_003, 40, 3
    mu, S, Z, v, l, g = _span_args((N, M, Q, True), card)
    g2, gY = (a.to(card) for a in _cotangents(M, D))
    Y = torch.as_tensor(np.random.default_rng(4).normal(size=(N, D)), device=card)
    arrs = (mu, S, Y, Z, v, l, g2, gY, g)
    _held(kernel, plain, [arrs[i] for i in idx], counter, dtype)


# ---------------------------------------------------------------------------
# half precision through the ops, and the statistics under a caller's TF32
# ---------------------------------------------------------------------------

HALF_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}  # a rounding of each to the half type
HALF_OPS = {  # op: (op, plain forward, plain reverse, arguments of (mu, S, Y, Z, v, l), cotangents)
    "suffstats": (ops.suffstats, ss.suffstats_fused_plain, ss.suffstats_vjp_plain,
                  (0, 1, 2, 3, 4, 5), ("g2", "gY")),
    "psi1": (ops.psi1, p1.psi1_plain, ss.psi1_vjp_plain, (0, 1, 3, 4, 5), ("g",)),
    "psi2": (ops.psi2, p2.psi2_plain, ss.psi2_vjp_plain, (0, 1, 3, 4, 5), ("g2",)),
    "kfu": (ops.kfu, kf.kfu_plain, ss.kfu_vjp_plain, (0, 3, 4, 5), ("g",)),
}


@pytest.mark.parametrize("half", sorted(HALF_TOL, key=str), ids=str)
@pytest.mark.parametrize("name", sorted(HALF_OPS))
def test_ops_run_half_precision_through_the_kernels_in_float32(card, name, half):
    """bfloat16 / float16 inputs: forward and reverse through the kernels in
    float32, outputs and cotangents in the half type, each within one
    rounding of the float32 plain version on the same (half-rounded)
    inputs cast back."""
    op, plain, plain_vjp, idx, cot_names = HALF_OPS[name]
    N, M, Q, D = 1_003, 33, 2, 3
    arrs = _inputs(N, M, Q, D, True)
    rng = np.random.default_rng(5)
    cots = {"g": rng.normal(size=(N, M)), "g2": rng.normal(size=(M, M)),
            "gY": rng.normal(size=(M, D))}
    args = [arrs[i].to(card, half) for i in idx]
    gs = [torch.as_tensor(cots[c], device=card).to(half) for c in cot_names]
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = _as_tuple(op(*leaves))
    grads = torch.autograd.grad(sum((o * g).sum() for o, g in zip(out, gs)), leaves)
    torch.cuda.synchronize()
    want = _as_tuple(plain(*(a.float() for a in args)))
    want_g = plain_vjp(*(a.float() for a in args), *(g.float() for g in gs))
    for o, w in zip(out, want):
        assert o.dtype == half and _rel(o, w.to(half).double().cpu()) <= HALF_TOL[half]
    for g, w in zip(grads, want_g):
        assert g.dtype == half and _rel(g, w.to(half).double().cpu()) <= HALF_TOL[half]


@pytest.mark.parametrize("backend", ("pallas", "fused"))
def test_statistics_ignore_a_callers_tf32(card, backend):
    """Under torch.set_float32_matmul_precision("high") the float32
    statistics and their gradients are bitwise those under "highest", and
    the caller's "high" is still set afterwards."""
    from repro_torch.core import psi_stats as tps

    rng = np.random.default_rng(6)
    N, M, D = 20_000, 64, 3
    kern = {"log_variance": torch.tensor(0.1, device=card),
            "log_lengthscale": torch.tensor([-0.5], device=card)}
    X, S, Y, Z = (torch.as_tensor(a, device=card, dtype=torch.float32) for a in
                  (rng.normal(size=(N, 1)), rng.uniform(0.01, 0.1, (N, 1)),
                   rng.normal(size=(N, D)), rng.normal(size=(M, 1))))

    def run():
        leaves = [a.clone().requires_grad_(True) for a in (X, S, Z)]
        exact = tps.exact_stats_rbf(kern, leaves[0], Y, leaves[2], backend=backend)
        expected = tps.expected_stats_rbf(kern, leaves[0], leaves[1], Y, leaves[2],
                                          backend=backend)
        loss = sum(s.psi2.sum() + s.psiY.sum() for s in (exact, expected))
        return [*exact[1:3], *expected[1:3], *torch.autograd.grad(loss, leaves)]

    want = run()
    torch.set_float32_matmul_precision("high")
    try:
        got = run()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the kernels a Product of RBFs runs per forward + backward: (module, counter)
PRODUCT_LAUNCHES = {
    "fused": ((ss, "LAUNCHES"), (ss, "BWD_LAUNCHES")),
    "pallas": ((p1, "LAUNCHES"), (p2, "LAUNCHES"), (ss, "PSI1_BWD_LAUNCHES"),
               (ss, "PSI2_BWD_LAUNCHES")),
}


@pytest.mark.parametrize("backend", ("fused", "pallas"))
def test_product_of_rbfs_launches_the_kernels(card, backend):
    """A Product of RBFs delegates its expected statistics to the
    equivalent RBF, so on the card one forward and backward launches each
    of the backend's kernels once (B1, B2; or B5, B3, B6, B4); statistics
    and the parts' gradients are the CPU plain versions' within TOL and
    the single RBF's at the equivalent parameters bit for bit."""
    from repro_torch.gp import kernels as gk

    rng = np.random.default_rng(7)
    N, M, D = 4099, 100, 3
    kern = gk.Product(gk.RBF(1), gk.RBF(1))
    params = {"k0": {"log_variance": 0.2, "log_lengthscale": [-0.3]},
              "k1": {"log_variance": -0.1, "log_lengthscale": [0.4]}}
    data = (rng.normal(size=(N, 1)), rng.uniform(0.05, 0.5, (N, 1)),
            rng.normal(size=(N, D)), 1.5 * rng.normal(size=(M, 1)))

    def run(device, product=True):
        p = {s: {k: torch.tensor(v, dtype=torch.float64, device=device,
                                 requires_grad=True) for k, v in part.items()}
             for s, part in params.items()}
        mu, S, Y, Z = (torch.as_tensor(a, device=device) for a in data)
        k, kp = (kern, p) if product else kern._equivalent_rbf(p)
        st = k.expected_suff_stats(kp, mu, S, Y, Z, backend=backend)
        leaves = [p[s][k] for s in ("k0", "k1") for k in ("log_lengthscale", "log_variance")]
        grads = torch.autograd.grad(st.psi2.sum() + st.psiY.sum(), leaves)
        return [st.psi2.detach(), st.psiY.detach(), *grads]

    before = [getattr(m, a) for m, a in PRODUCT_LAUNCHES[backend]]
    got = run(card)
    after = [getattr(m, a) for m, a in PRODUCT_LAUNCHES[backend]]
    assert [a - b for a, b in zip(after, before)] == [1] * len(before)
    for g, w in zip(got, run("cpu")):
        assert _rel(g, w) <= TOL[torch.float64]
    for g, w in zip(got, run(card, product=False)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# tuned launch geometry, the tuner and the budgeted server on the card
# ---------------------------------------------------------------------------

TUNE_KERNELS = ("suffstats_pallas", "suffstats_bwd_pallas", "psi2_pallas",
                "psi2_bwd_pallas", "psi1_pallas", "psi1_bwd_pallas", "kfu_pallas")


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("name", TUNE_KERNELS)
@pytest.mark.parametrize("mq", [(100, 1), (256, 4)], ids=str)
def test_kernels_match_plain_at_every_wave_count(card, name, mq, dtype):
    """At the measuring problem of (M, Q) every wave count is admissible
    and launches its own grid; each is held to the float64 plain version
    and is bitwise reproducible."""
    from repro_torch.tune import autotune, search

    M, Q = mq
    cardinfo = search.Card(torch.cuda.current_device())
    prob = search.measure_problem(name, M, Q, dtype, cardinfo)
    cands = search.candidate_blocks(name, problem=prob, dtype=dtype, card=cardinfo)
    assert cands == list(search.WAVE_CANDIDATES)
    args64 = autotune.kernel_inputs(name, prob, torch.float64, card)
    want = _as_tuple(search.KERNELS[name].plain(*args64))
    args = tuple(a.to(dtype) for a in args64)
    for w in cands:
        got = _as_tuple(autotune.run_kernel(name, args, w))
        again = _as_tuple(autotune.run_kernel(name, args, w))
        torch.cuda.synchronize()
        for g, a, p in zip(got, again, want):
            assert torch.equal(g, a)
            assert _rel(g, p.cpu()) <= TOL[dtype]


def _recording(monkeypatch):
    """Record the ints of every launch (the split counts among them)."""
    from repro_torch.kernels import kfu as kf_mod
    from repro_torch.kernels import psi1 as p1_mod
    from repro_torch.kernels import psi2 as p2_mod

    seen = []
    real = ss.launch

    def launch(lib, tensors, ints):
        seen.append((lib, tuple(ints)))
        return real(lib, tensors, ints)

    for mod in (ss, p1_mod, p2_mod, kf_mod):
        monkeypatch.setattr(mod, "launch", launch)
    return seen


# where each library's launch carries its split counts
_SPLIT_INTS = {"suffstats_fwd": (4, 5), "suffstats_bwd": (4,), "psi2_fwd": (3,),
               "psi2_bwd": (3,), "psi1_fwd": (4,), "kfu_fwd": (4,), "psi1_bwd": (3,)}


@pytest.mark.parametrize("waves", [(1, 1), (2, 4), (4, 2)], ids=str)
def test_ops_launch_a_pinned_block(card, monkeypatch, waves):
    """ops.suffstats / kfu / psi1 / psi2 with block= and bwd_block= launch
    exactly the split counts `tune.search.launch_plan` gives those waves."""
    from repro_torch.tune import search

    block, bwd_block = waves
    N, M, Q, D = 200_003, 100, 1, 3
    mu, S, Y, Z, v, ls = (a.to(card).requires_grad_() for a in _inputs(N, M, Q, D, True))
    seen = _recording(monkeypatch)
    outs = [ops.suffstats(mu, S, Y, Z, v, ls, block=block, bwd_block=bwd_block),
            ops.psi1(mu, S, Z, v, ls, block=block, bwd_block=bwd_block),
            ops.psi2(mu, S, Z, v, ls, block=block, bwd_block=bwd_block),
            ops.kfu(mu, Z, v, ls, block=block, bwd_block=bwd_block)]
    loss = sum(o.sum() for out in outs for o in _as_tuple(out))
    torch.autograd.grad(loss, (mu, S, Z, v, ls))
    torch.cuda.synchronize()
    cardinfo = search.Card(card.index or 0)
    prob = search.Problem(N, M, Q, D)
    name_of = {k.lib: name for name, k in search.KERNELS.items()}
    assert sorted(lib for lib, _ in seen) == sorted(
        ["suffstats_fwd", "suffstats_bwd", "psi1_fwd", "psi1_bwd", "psi2_fwd",
         "psi2_bwd", "kfu_fwd", "psi1_bwd"])
    for lib, ints in seen:
        w = block if lib.endswith("fwd") else bwd_block
        plan = search.launch_plan(name_of[lib], w, prob, torch.float64, cardinfo)
        assert tuple(ints[i] for i in _SPLIT_INTS[lib]) == plan.counts, lib


def test_ops_launch_the_tuners_winner(card, monkeypatch):
    """With a winner in the cache (and tuning off) an unpinned op launches
    it; with nothing cached, one wave."""
    from repro_torch import tune
    from repro_torch.tune import search

    N, M, Q = 100_003, 100, 1
    mu, S, Z, v, ls = (a.to(card) for a in _single((N, M, Q, 1, True))[:5])
    seen = _recording(monkeypatch)
    tune.store(tune.make_key("blocks", "psi2_pallas", torch.float64, M, Q, device=card),
               {"winner": 4})
    tune.clear_memo()
    ops.psi2(mu, S, Z, v, ls)
    ops.psi1(mu, S, Z, v, ls)
    cardinfo = search.Card(card.index or 0)
    prob = search.Problem(N, M, Q)
    assert seen[0][1][3] == search.launch_plan("psi2_pallas", 4, prob, torch.float64,
                                               cardinfo).counts[0]
    assert seen[1][1][4] == search.launch_plan("psi1_pallas", 1, prob, torch.float64,
                                               cardinfo).counts[0]


def test_tuner_measures_on_the_card_once(card, monkeypatch):
    """Tuning on: the first resolution times every candidate on the card,
    the second (memo cleared) reads the file with no timing run."""
    from repro_torch import tune
    from repro_torch.tune import autotune

    monkeypatch.setattr(autotune, "_ENABLED_OVERRIDE", True)
    runs = tune.timing_runs()
    win = tune.best_blocks("kfu_pallas", dtype=torch.float32, m=100, q=1, device=card)
    assert win in tune.WAVE_CANDIDATES and tune.timing_runs() == runs + 3
    tune.clear_memo()
    assert tune.best_blocks("kfu_pallas", dtype=torch.float32, m=100, q=1,
                            device=card) == win
    assert tune.timing_runs() == runs + 3
    chunk = tune.best_chunk(n=50_000, m=100, q=1, d=3, dtype=torch.float32,
                            backend="fused", device=card)
    n_meas = min(50_000, 4 * max(tune.CHUNK_CANDIDATES))  # the measuring N
    assert chunk in tune.candidate_chunks(n_meas)


def test_budgeted_server_evicts_reloads_and_answers_the_same(card, tmp_path):
    from repro_torch import convert
    from repro_torch.gp import ExactBatch, get, suff_stats
    from repro_torch.serve import GPServer, build_state

    rng = np.random.default_rng(5)
    kernel = get("rbf")(1)
    states = {}
    for i in range(4):
        X = rng.uniform(-3, 3, (20_000, 1))
        Y = np.sin(2 * X + 0.3 * i) + 0.1 * rng.normal(size=X.shape)
        params = convert.params_from_numpy(
            {"kern": {"log_variance": 0.0, "log_lengthscale": [np.log(0.3)]},
             "Z": np.linspace(-3, 3, 50)[:, None], "log_beta": np.log(100.0)},
            device=card, dtype=torch.float64)
        X, Y = torch.as_tensor(X, device=card), torch.as_tensor(Y, device=card)
        stats = suff_stats(kernel, params["kern"], ExactBatch(X, Y, params["Z"]),
                           backend="fused")
        states[f"m{i}"] = build_state(kernel, params, stats)
    Xt = torch.linspace(-3, 3, 64, device=card, dtype=torch.float64)[:, None]
    budget = 2 * states["m0"].nbytes
    with GPServer(store=tmp_path, budget_bytes=budget, device=card) as srv:
        first = {}
        for name, st in states.items():
            srv.register(name, kernel=kernel, state=st)
            first[name] = srv.predict(name, Xt)
        for name in states:
            again = srv.predict(name, Xt)
            assert all(torch.equal(a, b) for a, b in zip(again, first[name]))
            assert srv.state(name).Z.device.type == "cuda"
        m = srv.metrics()
        assert m["evictions"] > 0 and m["lazy_loads"] > 0
        assert m["peak_resident_bytes"] <= budget
        srv.save_all()
    restarted = GPServer.load(tmp_path, device=card)
    for name in states:
        again = restarted.predict(name, Xt)
        assert all(torch.equal(a, b) for a, b in zip(again, first[name]))
    restarted.close()
