"""The port's reverse pass of the fused statistics (`suffstats_vjp_plain`,
the op's backward) and the checkpointed chunk loops, on the CPU.

Against the JAX reference: the plain reverse pass vs `suffstats_vjp_jnp`
and vs the reverse Pallas kernel in interpret mode (as the reference's own
tests run it), and vs torch autograd of the plain forward. Inputs are
float64 from numpy seeds, held to 1e-10 relative to max|reference| per
output. The CUDA reverse kernel runs only on the card
(tests/test_torch_cuda.py and the `-m cuda` tests below, which skip
elsewhere); here its wrapper and the op's kernel-only backend are checked
to refuse CPU tensors, and its launch plan and scratch are checked against
the tuner's. JAX is imported inside the tests that compare with it, so the
card's tests run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_suffstats_bwd.py
"""
import numpy as np
import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks

from repro_torch.analysis import kernel_audit
from repro_torch.core import psi_stats as tps
from repro_torch.gp import (ExactBatch, ExpectedBatch, get, streaming_suff_stats,
                            suff_stats)
from repro_torch.kernels import ops
from repro_torch.kernels import suffstats as tss
from repro_torch.tune import search

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


JAX_FNS = ("pallas_interpret", "vjp_jnp")


def _jax_fn(name):
    from repro.kernels.suffstats import suffstats_bwd_pallas, suffstats_vjp_jnp

    if name == "vjp_jnp":
        return suffstats_vjp_jnp
    return lambda *a: suffstats_bwd_pallas(*a, interpret=True)


@pytest.mark.parametrize("jax_fn", JAX_FNS)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_vjp_matches_jax(case, jax_fn):
    import jax.numpy as jnp

    arrs = _inputs(*case)
    want = _jax_fn(jax_fn)(*map(jnp.asarray, arrs))
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
    """The pair pass's N-splits and the point pass's blocks are functions
    of the shapes, the geometry and the occupancy: one wave of point-pass
    blocks, each with a tile of the first chunk."""
    N, M = shape
    geo = tss.Geometry(pairs_per_block=1024, blocks_per_sm=2, run=32, group=4)
    P2 = tss.bwd_pair_split(N, M, geo, 132).count
    W = tss.point_blocks(N, M, geo.pairs_per_block, 3, 132)
    assert (P2, W) == (tss.bwd_pair_split(N, M, geo, 132).count,
                       tss.point_blocks(N, M, geo.pairs_per_block, 3, 132))
    assert P2 >= 1 and (P2 == 1 or N // P2 >= geo.run)
    tiles = -(-tss.point_chunk(N, M, geo.pairs_per_block) // tss.BWD_THREADS)
    assert W == min(tiles, 3 * 132) >= 1
    assert tss.dz_scratch(M, 1, W) == (2, W, M, 1)


# (N, M, Q, D, dtype, bytes): the benchmark's two fit shapes, where a dZ row
# per 256 points over all of N would take 33.5 MB and 3.1 MB
DZ_SHAPES = [(16_777_216, 128, 1, 3, torch.float32, 4 << 20),
             (1_000_000, 100, 1, 3, torch.float64, 1 << 20)]


@pytest.mark.parametrize("shape", DZ_SHAPES, ids=lambda s: f"N{s[0]}-{s[4]}")
def test_dz_scratch_is_small_at_the_benchmark_shapes(shape):
    """The point-pass blocks' dZ totals hold a wave of (M, Q) rows, in
    float64 with their compensation terms, whatever N is."""
    N, M, Q, D, dtype, limit = shape
    card = kernel_audit.StandInCard()
    geo = card.psi2_geometry("suffstats_bwd", dtype, Q)
    W = tss.point_blocks(N, M, geo.pairs_per_block, card.point_resident(dtype, Q), card.sms)
    dz = 8 * int(np.prod(tss.dz_scratch(M, Q, W)))
    assert dz < limit
    assert W <= card.point_resident(dtype, Q) * card.sms < -(-N // tss.BWD_THREADS)
    plan = search.launch_plan("suffstats_bwd_pallas", 1, search.Problem(N, M, Q, D), dtype,
                              card)
    assert np.prod(tss.dz_scratch(M, Q, W)) in plan.scratch
    # twice the points: the same dZ scratch
    again = tss.point_blocks(2 * N, M, geo.pairs_per_block, card.point_resident(dtype, Q),
                             card.sms)
    assert again == W


@pytest.mark.parametrize("shape", [(100_003, 256, 4, 5), (20_011, 33, 20, 2), (1, 5, 1, 3)],
                         ids=str)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
def test_launch_plan_scratch_is_what_the_wrapper_allocates(monkeypatch, shape, dtype):
    """`tune.search.launch_plan`'s scratch and split counts are the
    wrapper's: its launch is recorded on the CPU (no kernel runs) over the
    stand-in card's geometry and occupancy."""
    N, M, Q, D = shape
    card = kernel_audit.StandInCard()
    seen = []
    monkeypatch.setattr(tss, "check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(tss, "card_geometry",
                        lambda lib, t: (card.psi2_geometry(lib, t.dtype, t.shape[1]), card.sms))
    monkeypatch.setattr(tss, "card_of", lambda t: (0, card.sms))
    monkeypatch.setattr(tss, "point_occupancy", lambda dt, q, dev: card.point_resident(dt, q))
    monkeypatch.setattr(tss, "launch", lambda lib, tensors, ints: seen.append((tensors, ints)))
    arrs = [torch.as_tensor(a, dtype=dtype) for a in _inputs(N, M, Q, True, D=D)]
    tss.suffstats_bwd_cuda(*arrs)
    (tensors, ints), = seen
    plan = search.launch_plan("suffstats_bwd_pallas", 1, search.Problem(N, M, Q, D), dtype,
                              card)
    # pair partials, then the float64 dZ totals and pair carry
    pair_part, carry, dz = tensors[13], tensors[15], tensors[17]
    assert plan.scratch == (pair_part.numel(), dz.numel(), carry.numel())
    assert (dz.dtype, carry.dtype) == (torch.float64, torch.float64)
    assert plan.scratch_bytes == (pair_part.numel() * pair_part.element_size()
                                  + 8 * (dz.numel() + carry.numel()))
    assert plan.counts == (ints[4],)  # P2
    geo = card.psi2_geometry("suffstats_bwd", dtype, Q)
    assert ints[5] == tss.point_blocks(N, M, geo.pairs_per_block,
                                       card.point_resident(dtype, Q), card.sms)
    assert dz.shape == tss.dz_scratch(M, Q, ints[5])
    audit = kernel_audit.kernel_plan("suffstats_bwd_pallas", kernel_audit.Problem(N, M, Q, D),
                                     dtype, card)
    assert audit.passes[1].grid == (ints[5],)


# ---------------------------------------------------------------------------
# on the card: the fused reverse kernel against the plain reverse pass
# ---------------------------------------------------------------------------

CARD_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# (N, M, Q, D): M ragged against the 32-column tile (100, 33, 129); N not a
# multiple of 256, over several chunks (20,011 at M = 100 or 129: 5 and 17)
# and with point-pass blocks that walk several tiles of a chunk (300,007 at
# M = 33, one chunk; 1,000,003 at M = 100, five); every compile-time Q
# class, the run-time one (Q = 6) and Q = 20 (two passes of 16 q's)
CARD_CASES = [(20_011, 100, 1, 3), (20_011, 33, 2, 3), (20_011, 129, 4, 5),
              (5_003, 100, 6, 3), (3_001, 33, 20, 2), (300_007, 33, 1, 3),
              (1_000_003, 100, 1, 3)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32), ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_fused_reverse_kernel_matches_plain(card, monkeypatch, case, dtype):
    """Every output of the fused reverse kernel, whose point pass sums dZ's
    psi1 part, against the plain reverse pass in float64 (float64 within
    1e-10 and float32 within 1e-4 of max|plain| per output), two launches
    bitwise equal, the scratch `tune.search.launch_plan` plans."""
    N, M, Q, D = case
    arrs = [torch.as_tensor(a) for a in _inputs(N, M, Q, True, D=D, seed=N % 7)]
    if Q > 4:  # lengthscales grow with sqrt(Q): the Q-term exponents stay O(1)
        arrs[5] = arrs[5] * np.sqrt(Q)
    want = tss.suffstats_vjp_plain(*[a.to(card) for a in arrs])
    dev = [a.to(card, dtype) for a in arrs]
    seen, real = [], tss.launch

    def launch(lib, tensors, ints):
        seen.append((tuple(t.numel() for t in tensors), ints))
        return real(lib, tensors, ints)

    monkeypatch.setattr(tss, "launch", launch)
    before = tss.BWD_LAUNCHES
    got, again = tss.suffstats_bwd_cuda(*dev), tss.suffstats_bwd_cuda(*dev)
    torch.cuda.synchronize()
    assert tss.BWD_LAUNCHES == before + 2
    for name, g, a, w in zip(OUTPUTS, got, again, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert torch.equal(g, a), name  # bitwise reproducible
        assert float((g.double() - w).abs().max() / w.abs().max()) <= CARD_TOL[dtype], name
    plan = search.launch_plan("suffstats_bwd_pallas", 1, search.Problem(N, M, Q, D), dtype,
                              search.Card(card.index or 0))
    numel, ints = seen[0]
    assert plan.scratch == (numel[13], numel[17], numel[15]) and plan.counts == (ints[4],)


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
