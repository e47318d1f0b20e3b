"""The port's statistics ops at a latent dimension above 16 (Q = 20), and the
float32 matrix products' precision, on the CPU.

`ops.psi1`, `ops.psi2`, `ops.kfu` and `ops.suffstats` (their plain
versions on the CPU) forward and in reverse against the reference's Pallas
kernels in interpret mode, as its own tests run them, on float64 inputs
from numpy seeds at 1e-10 relative to max|reference| per output. The CUDA
kernels take the same Q on the card (tests/test_torch_cuda.py, `-m cuda`);
here the host's shared-memory bounds are checked to let Q = 20 through.

The statistics' matrix products (K_fu^T K_fu, K_fu^T Y, psi1^T Y) run in
full float32 whatever a caller sets, and hand the caller's setting back.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kfu import kfu_pallas
from repro.kernels.psi1 import psi1_pallas
from repro.kernels.psi2 import psi2_pallas
from repro.kernels.suffstats import (kfu_bwd_pallas, psi1_bwd_pallas, psi2_bwd_pallas,
                                     suffstats_bwd_pallas, suffstats_pallas)
from repro_torch.core import psi_stats as tps
from repro_torch.kernels import ops
from repro_torch.kernels import suffstats as tss

RTOL = 1e-10
Q = 20

# (N, M, S > 0): N ragged against the reference's tiles, M ragged, S = 0
# (psi1 is then K_fu) and S > 0
CASES = [(37, 13, True), (50, 7, False)]


def _inputs(N, M, pos_S, D=3, seed=0):
    """(mu, S, Y, Z, variance, lengthscale, g (N, M), g2 (M, M), gY (M, D));
    the lengthscales grow with sqrt(Q), so the 20-term exponents stay O(1)."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(N, Q))
    S = rng.uniform(0.05, 0.6, (N, Q)) if pos_S else np.zeros((N, Q))
    return (mu, S, rng.normal(size=(N, D)), 1.2 * rng.normal(size=(M, Q)),
            np.float64(1.3), np.sqrt(Q) * rng.uniform(0.6, 1.4, Q),
            rng.normal(size=(N, M)), rng.normal(size=(M, M)), rng.normal(size=(M, D)))


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _case_id(c):
    return f"N{c[0]}-M{c[1]}-{'S' if c[2] else 'S0'}"


# stat: (port op, reference forward, reference reverse, forward inputs, cotangents)
STATS = {
    "psi1": (ops.psi1, lambda *a: psi1_pallas(*a, interpret=True),
             lambda *a: psi1_bwd_pallas(*a, interpret=True), (0, 1, 3, 4, 5), (6,)),
    "psi2": (ops.psi2, lambda *a: psi2_pallas(*a, interpret=True),
             lambda *a: psi2_bwd_pallas(*a, interpret=True), (0, 1, 3, 4, 5), (7,)),
    "kfu": (ops.kfu, lambda *a: kfu_pallas(*a, interpret=True),
            lambda *a: kfu_bwd_pallas(*a, interpret=True), (0, 3, 4, 5), (6,)),
    "suffstats": (ops.suffstats, lambda *a: suffstats_pallas(*a, interpret=True),
                  lambda *a: suffstats_bwd_pallas(*a, interpret=True), (0, 1, 2, 3, 4, 5),
                  (7, 8)),
}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("stat", sorted(STATS))
def test_ops_forward_at_q20_matches_the_reference(stat, case):
    op, ref_fwd, _, idx, _ = STATS[stat]
    arrs = _inputs(*case)
    args = [arrs[i] for i in idx]
    want = _tuple(ref_fwd(*map(jnp.asarray, args)))
    got = _tuple(op(*map(torch.as_tensor, args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("stat", sorted(STATS))
def test_ops_reverse_at_q20_matches_the_reference(stat, case):
    op, _, ref_bwd, idx, gidx = STATS[stat]
    arrs = _inputs(*case)
    args = [arrs[i] for i in idx]
    cots = [arrs[i] for i in gidx]
    want = ref_bwd(*map(jnp.asarray, args + cots))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in args]
    out = _tuple(op(*leaves))
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(out, cots))
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.dtype == torch.float64
        assert _rel(g, w) <= RTOL


def test_the_kernels_bounds_let_q20_through():
    """No Q limit but shared memory: Q = 20 passes every kernel's bound in
    both dtypes (the wrappers then refuse the CPU tensors for being on the
    CPU, not for their Q)."""
    for itemsize in (4, 8):
        for lib in ("suffstats_fwd", "suffstats_bwd", "psi2_fwd", "psi2_bwd"):
            assert tss.kernel_smem(lib, Q, itemsize) <= tss.SMEM_LIMIT
        assert tss.psi1_bwd_plan(100, Q, itemsize).smem <= tss.SMEM_LIMIT
    mu, S, Y, Z, v, l = map(torch.as_tensor, _inputs(37, 13, True)[:6])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tss.suffstats_bwd_cuda(mu, S, Y, Z, v, l, torch.zeros(13, 13), torch.zeros(13, 3))


# ---------------------------------------------------------------------------
# the statistics' float32 matrix products
# ---------------------------------------------------------------------------

@pytest.fixture
def caller_allows_tf32():
    """A caller that asks for TF32 float32 products; its setting is put
    back whatever the test does."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    yield "tf32"
    matmul.fp32_precision = saved


def _stats_args(seed=0):
    rng = np.random.default_rng(seed)
    N, M, D = 53, 11, 3
    kern = {"log_variance": torch.tensor(np.log(1.3), dtype=torch.float32),
            "log_lengthscale": torch.as_tensor(np.log(rng.uniform(0.6, 1.4, 2)),
                                               dtype=torch.float32)}
    X, S, Y = rng.normal(size=(N, 2)), rng.uniform(0.05, 0.5, (N, 2)), rng.normal(size=(N, D))
    Z = 1.1 * rng.normal(size=(M, 2))
    return kern, *(torch.as_tensor(a, dtype=torch.float32) for a in (X, S, Y, Z))


def test_full_float32_matmul_pins_ieee_and_restores_the_caller(caller_allows_tf32):
    matmul = torch.backends.cuda.matmul
    with tps.full_float32_matmul():
        assert matmul.fp32_precision == "ieee"
        with tps.full_float32_matmul():  # nested: still pinned
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "ieee"
    assert matmul.fp32_precision == caller_allows_tf32


def test_full_float32_matmul_keeps_a_setting_made_while_pinned(caller_allows_tf32):
    """Another thread's change of the process-wide flag inside the window
    survives the restore."""
    matmul = torch.backends.cuda.matmul
    with tps.full_float32_matmul():
        matmul.fp32_precision = "tf32" if caller_allows_tf32 != "tf32" else "none"
        changed = matmul.fp32_precision
    assert changed != "ieee" and matmul.fp32_precision == changed


@pytest.mark.parametrize("backend", ("jnp", "pallas"))
def test_statistics_leave_the_callers_tf32_setting_as_they_found_it(caller_allows_tf32,
                                                                    backend):
    """The statistics and their gradients under a caller's TF32 setting
    equal the ones under the default, and the setting is the caller's
    again afterwards."""
    kern, X, S, Y, Z = _stats_args()
    leaves = [a.clone().requires_grad_(True) for a in (X, S, Z)]

    def run():
        exact = tps.exact_stats_rbf(kern, leaves[0], Y, leaves[2], backend=backend)
        expected = tps.expected_stats_rbf(kern, leaves[0], leaves[1], Y, leaves[2],
                                          backend=backend)
        loss = sum(s.psi2.sum() + s.psiY.sum() for s in (exact, expected))
        return (exact, expected, torch.autograd.grad(loss, leaves))

    got = run()
    assert torch.backends.cuda.matmul.fp32_precision == caller_allows_tf32
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    want = run()
    torch.backends.cuda.matmul.fp32_precision = caller_allows_tf32
    for g, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(g, w)


def test_stat_matmul_gradients_keep_their_inputs_layout():
    """K_fu^T K_fu and K_fu^T Y: the gradient through the transposed view
    comes back contiguous and bitwise PyTorch's own product's, so K_fu's
    cotangents add in one pass."""
    K = torch.randn(40, 7, dtype=torch.float64, requires_grad=True)
    Y = torch.randn(40, 3, dtype=torch.float64)
    g2, gY = torch.randn(7, 7, dtype=torch.float64), torch.randn(7, 3, dtype=torch.float64)
    grads = []
    for mm in (tps.stat_matmul, torch.matmul):
        loss = (mm(K.T, K) * g2).sum() + (mm(K.T, Y) * gY).sum()
        grads.append(torch.autograd.grad(loss, K)[0])
    assert grads[0].is_contiguous()
    assert torch.equal(grads[0], grads[1])


def test_stat_matmul_is_the_plain_product_in_both_directions():
    a, b = torch.randn(7, 40, dtype=torch.float64), torch.randn(40, 5, dtype=torch.float64)
    la, lb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    pa, pb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    g = torch.randn(7, 5, dtype=torch.float64)
    out = tps.stat_matmul(la, lb)
    assert torch.equal(out, pa @ pb)
    assert all(torch.equal(x, y) for x, y in zip(torch.autograd.grad((out * g).sum(), (la, lb)),
                                                 torch.autograd.grad(((pa @ pb) * g).sum(),
                                                                     (pa, pb))))


def test_concurrent_statistics_restore_the_caller_once_all_leave(caller_allows_tf32):
    """Two threads inside at once (a server's worker beside its caller):
    neither gives the caller's setting back while the other is inside."""
    matmul = torch.backends.cuda.matmul
    inside, release, seen = threading.Event(), threading.Event(), []

    def worker():
        with tps.full_float32_matmul():
            inside.set()
            release.wait(10)
            seen.append(matmul.fp32_precision)

    t = threading.Thread(target=worker)
    t.start()
    assert inside.wait(10)
    with tps.full_float32_matmul():
        pass  # this thread leaves first
    assert matmul.fp32_precision == "ieee"  # the worker is still inside
    release.set()
    t.join(10)
    assert seen == ["ieee"] and matmul.fp32_precision == caller_allows_tf32
