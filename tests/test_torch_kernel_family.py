"""The port's kernel family (`repro_torch.gp.kernels`: Linear, the Materns,
Sum, Product, the cross-psi2 terms, `capabilities`) against the JAX
reference on the same float64 inputs, drawn with numpy.

Tolerances, relative to max|reference| per output: kernel values and
statistics 1e-10; gradients 1e-8; 3-step fits 1e-5 on losses and
parameters, as in tests/test_torch_models.py (Adam rounds each parameter
to float32 before its step, in both packages, so gradients that differ in
their last bits can land a float32 ulp apart and Adam's sign-like first
steps carry that on). Error messages are the reference's, word for word (the
package name aside).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gplvm as jgplvm
from repro.core import psi_stats as jps
from repro.core import svgp as jsvgp
from repro.gp import BayesianGPLVM as JBayesianGPLVM
from repro.gp import SparseGPRegression as JSparseGPRegression
from repro.gp import kernels as jk
from repro.kernels import ref as jref
from repro.serve import state as jstate
from repro_torch import convert
from repro_torch.core import gplvm as tgplvm
from repro_torch.core import psi_stats as tps
from repro_torch.core import svgp as tsvgp
from repro_torch.gp import BayesianGPLVM, SparseGPRegression
from repro_torch.gp import kernels as tk
from repro_torch.kernels import ref as tref
from repro_torch.serve.state import build_state

TOL = 1e-10
GRAD_TOL = 1e-8
FIT_TOL = 1e-5
Q = 2


def _rel(got, want) -> float:
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _pair(spec):
    """(torch kernel, reference kernel) from a nested spec: a registry name
    or (composite name, part spec, part spec)."""
    if isinstance(spec, str):
        return tk.get(spec)(Q), jk.get(spec)(Q)
    name, *parts = spec
    pairs = [_pair(p) for p in parts]
    return (tk.get(name)(*(t for t, _ in pairs)),
            jk.get(name)(*(j for _, j in pairs)))


def _np_params(tkern, seed=0):
    """The kernel's parameter tree with every leaf drawn from numpy in
    [-0.4, 0.4] (log-values: variances and lengthscales in 0.67..1.5)."""
    rng = np.random.default_rng(seed)

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return rng.uniform(-0.4, 0.4, tuple(tree.shape))

    return draw(tkern.init(device="cpu", dtype=torch.float64))


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.asarray(a, np.float64)), tree)


def _jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


CASES = {
    "rbf": "rbf", "linear": "linear", "matern12": "matern12",
    "matern32": "matern32", "matern52": "matern52",
    "sum": ("sum", "rbf", "linear"),
    "product": ("product", "rbf", "rbf"),
    "sum-linear-linear": ("sum", "linear", "linear"),
    "sum-linear-rbf": ("sum", "linear", "rbf"),
    "sum-matern12-rbf": ("sum", "matern12", "rbf"),
    "product-rbf-linear": ("product", "rbf", "linear"),
    "product-matern32-matern52": ("product", "matern32", "matern52"),
    "sum-3-parts": ("sum", "rbf", "linear", "linear"),
}


def _data(N=23, M=6, D=3, seed=1):
    rng = np.random.default_rng(seed)
    return {"X": rng.normal(size=(N, Q)), "Y": rng.normal(size=(N, D)),
            "Z": 1.2 * rng.normal(size=(M, Q)),
            "S": rng.uniform(0.05, 0.6, (N, Q))}


def test_available_names_agree():
    assert tk.available() == jk.available() == (
        "linear", "matern12", "matern32", "matern52", "product", "rbf", "sum")
    for name in tk.available():
        assert tk.get(name).name == name


@pytest.mark.parametrize("case", CASES, ids=str)
def test_K_and_Kdiag_match_the_reference(case):
    tkern, jkern = _pair(CASES[case])
    p = _np_params(tkern)
    a = _data()
    X, Z = a["X"], a["Z"]
    tp, jp = _torch_tree(p), _jax_tree(p)
    # K(X): off the diagonal at TOL; on it, each package sits within the
    # expanded form's bound of Kdiag (see `_diag_bound`), and no closer to
    # the other's rounding
    got, want = tkern.K(tp, torch.as_tensor(X)), np.asarray(jkern.K(jp, jnp.asarray(X)))
    off = ~np.eye(X.shape[0], dtype=bool)
    assert _rel(got.numpy()[off], want[off]) <= TOL
    bound = _diag_bound(tkern, tp, torch.as_tensor(X))
    assert np.abs(got.numpy().diagonal() - want.diagonal()).max() <= 2 * bound
    assert _rel(tkern.K(tp, torch.as_tensor(X), torch.as_tensor(Z)),
                jkern.K(jp, jnp.asarray(X), jnp.asarray(Z))) <= TOL
    assert _rel(tkern.Kdiag(tp, torch.as_tensor(X)),
                jkern.Kdiag(jp, jnp.asarray(X))) <= TOL


def _diag_bound(tkern, tp, X) -> float:
    """How far diag(K) may sit from Kdiag. The Materns take r from the
    expanded form |x|^2 + |x'|^2 - 2 x.x' (the reference's formula), which
    on the diagonal cancels to a few eps * |x/l|^2 instead of 0, clamped
    below at 1e-18; r is its square root, ~1e-8 here. Matern-1/2's shape
    exp(-r) has slope -1 at r = 0, so its diagonal drops by sigma^2 r (up
    to ~3e-8); Matern-3/2 and 5/2 have zero slope at 0 and lose only
    O(r^2) ~ 1e-15, inside the 1e-12 every smooth kernel is held to. A
    composite inherits its parts' bound, scaled by the other parts' value
    for a product."""
    if isinstance(tkern, tk._Composite):
        bounds = [_diag_bound(k, pp, X) for k, pp in tkern._split(tp)]
        if isinstance(tkern, tk.Sum):
            return sum(bounds)
        scale = [float(k.Kdiag(pp, X).abs().max()) for k, pp in tkern._split(tp)]
        return sum(b * float(np.prod(scale[:i] + scale[i + 1:]))
                   for i, b in enumerate(bounds))
    if isinstance(tkern, tk.Matern12):
        xs2 = float(((X / tkern.lengthscale(tp)) ** 2).sum(-1).max())
        eps = torch.finfo(torch.float64).eps
        r = max(8.0 * eps * xs2, 1e-18) ** 0.5
        return float(tkern.variance(tp)) * r
    return 1e-12 * float(tkern.Kdiag(tp, X).abs().max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_diag_of_K_is_Kdiag_within_the_expanded_form(case):
    tkern, _ = _pair(CASES[case])
    tp = _torch_tree(_np_params(tkern, seed=3))
    X = torch.as_tensor(np.random.default_rng(4).normal(size=(31, Q)))
    dev = float((tkern.K(tp, X).diagonal() - tkern.Kdiag(tp, X)).abs().max())
    bound = _diag_bound(tkern, tp, X)
    assert dev <= bound, (dev, bound)
    if "matern12" not in case:
        assert bound <= 1e-12 * float(tkern.Kdiag(tp, X).abs().max()) * 4


@pytest.mark.parametrize("case", CASES, ids=str)
def test_exact_stats_and_gradients_match_the_reference(case):
    tkern, jkern = _pair(CASES[case])
    p = _np_params(tkern)
    a = _data()
    W = np.random.default_rng(5).normal(size=(6, 6))

    def loss_j(pj, X, Z):
        s = jkern.exact_suff_stats(pj, X, jnp.asarray(a["Y"]), Z)
        return jnp.sum(W * s.psi2) + jnp.sum(s.psiY) + s.psi0 + s.yy

    want = jkern.exact_suff_stats(_jax_tree(p), jnp.asarray(a["X"]),
                                  jnp.asarray(a["Y"]), jnp.asarray(a["Z"]))
    gj = jax.grad(loss_j, argnums=(0, 1, 2))(_jax_tree(p), jnp.asarray(a["X"]),
                                             jnp.asarray(a["Z"]))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), _torch_tree(p))
    X = torch.as_tensor(a["X"]).requires_grad_(True)
    Z = torch.as_tensor(a["Z"]).requires_grad_(True)
    got = tkern.exact_suff_stats(tp, X, torch.as_tensor(a["Y"]), Z)
    for name, g, w in zip(tps.SuffStats._fields, got, want):
        assert _rel(g, w) <= TOL, name
    loss = (torch.as_tensor(W) * got.psi2).sum() + got.psiY.sum() + got.psi0 + got.yy
    leaves = [*jax.tree.leaves(tp), X, Z]
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(gj)):
        assert _rel(g, w) <= GRAD_TOL


PSI_CASES = [c for c in CASES if jk.capabilities(_pair(CASES[c])[1])["psi"]]


@pytest.mark.parametrize("case", PSI_CASES, ids=str)
def test_expected_stats_and_gradients_match_the_reference(case):
    tkern, jkern = _pair(CASES[case])
    p = _np_params(tkern, seed=6)
    a = _data(seed=7)
    W = np.random.default_rng(8).normal(size=(6, 6))

    def loss_j(pj, mu, S, Z):
        s = jkern.expected_suff_stats(pj, mu, S, jnp.asarray(a["Y"]), Z)
        return jnp.sum(W * s.psi2) + jnp.sum(s.psiY) + s.psi0

    jargs = (_jax_tree(p), *(jnp.asarray(a[k]) for k in ("X", "S", "Z")))
    want = jkern.expected_suff_stats(jargs[0], jargs[1], jargs[2],
                                     jnp.asarray(a["Y"]), jargs[3])
    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*jargs)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), _torch_tree(p))
    mu, S, Z = (torch.as_tensor(a[k]).requires_grad_(True) for k in ("X", "S", "Z"))
    got = tkern.expected_suff_stats(tp, mu, S, torch.as_tensor(a["Y"]), Z)
    for name, g, w in zip(tps.SuffStats._fields, got, want):
        assert _rel(g, w) <= TOL, name
    loss = (torch.as_tensor(W) * got.psi2).sum() + got.psiY.sum() + got.psi0
    grads = torch.autograd.grad(loss, [*jax.tree.leaves(tp), mu, S, Z])
    for g, w in zip(grads, jax.tree.leaves(gj)):
        assert _rel(g, w) <= GRAD_TOL


@pytest.mark.parametrize("backend", ("fused", "pallas"))
def test_product_of_rbfs_runs_the_kernel_backends(backend):
    """A Product of RBFs delegates to the equivalent RBF through the fused
    and pallas ops (their plain versions on the CPU), with gradients back
    to each part, equal to the reference through "jnp"."""
    tkern, jkern = _pair(("product", "rbf", "rbf"))
    p = _np_params(tkern, seed=9)
    a = _data(N=41, M=7, seed=10)
    W = np.random.default_rng(11).normal(size=(7, 7))

    def loss_j(pj, mu, S, Z):
        s = jkern.expected_suff_stats(pj, mu, S, jnp.asarray(a["Y"]), Z)
        return jnp.sum(W * s.psi2) + jnp.sum(s.psiY) + s.psi0

    jargs = (_jax_tree(p), *(jnp.asarray(a[k]) for k in ("X", "S", "Z")))
    want = jkern.expected_suff_stats(jargs[0], jargs[1], jargs[2],
                                     jnp.asarray(a["Y"]), jargs[3])
    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*jargs)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), _torch_tree(p))
    mu, S, Z = (torch.as_tensor(a[k]).requires_grad_(True) for k in ("X", "S", "Z"))
    got = tkern.expected_suff_stats(tp, mu, S, torch.as_tensor(a["Y"]), Z,
                                    backend=backend)
    for name, g, w in zip(tps.SuffStats._fields, got, want):
        assert _rel(g, w) <= TOL, name
    loss = (torch.as_tensor(W) * got.psi2).sum() + got.psiY.sum() + got.psi0
    grads = torch.autograd.grad(loss, [*jax.tree.leaves(tp), mu, S, Z])
    for g, w in zip(grads, jax.tree.leaves(gj)):
        assert _rel(g, w) <= GRAD_TOL
    # and the statistics are a single RBF's at the equivalent parameters
    rbf, eq = tkern._equivalent_rbf(_torch_tree(p))
    single = rbf.expected_suff_stats(eq, *(torch.as_tensor(a[k]) for k in "XSYZ"),
                                     backend=backend)
    for g, w in zip(got, single):
        assert _rel(g, w.numpy()) <= TOL


def test_cross_terms_match_the_reference():
    a = _data(N=30, M=7, seed=12)
    mu, S, Z = (a[k] for k in ("X", "S", "Z"))
    tr, tl = tk.RBF(Q), tk.Linear(Q)
    jr, jl = jk.RBF(Q), jk.Linear(Q)
    pr, pl, pl2 = (_np_params(k, seed=s) for k, s in ((tr, 13), (tl, 14), (tl, 15)))
    targs = [torch.as_tensor(x) for x in (mu, S, Z)]
    jargs = [jnp.asarray(x) for x in (mu, S, Z)]
    pairs = [((tr, pr, tl, pl), (jr, pr, jl, pl)),
             ((tl, pl, tr, pr), (jl, pl, jr, pr)),
             ((tl, pl, tl, pl2), (jl, pl, jl, pl2))]
    for (ka, pa, kb, pb), (ja, _, jb, _) in pairs:
        got = tk._cross_psi2(ka, _torch_tree(pa), kb, _torch_tree(pb), *targs)
        want = jk._cross_psi2(ja, _jax_tree(pa), jb, _jax_tree(pb), *jargs)
        assert _rel(got, want) <= TOL
    assert _rel(tk._cross_psi2_rbf_linear(tr, _torch_tree(pr), tl, _torch_tree(pl), *targs),
                jk._cross_psi2_rbf_linear(jr, _jax_tree(pr), jl, _jax_tree(pl), *jargs)) <= TOL
    assert _rel(tk._cross_psi2_linear_linear(tl, _torch_tree(pl), tl, _torch_tree(pl2), *targs),
                jk._cross_psi2_linear_linear(jl, _jax_tree(pl), jl, _jax_tree(pl2), *jargs)) <= TOL
    names = ("rbf", "linear", "matern32")
    for x in names:
        for y in names:
            assert tk._has_cross_psi2(tk.get(x)(Q), tk.get(y)(Q)) == \
                jk._has_cross_psi2(jk.get(x)(Q), jk.get(y)(Q)), (x, y)


def test_linear_statistics_and_exact_marginal_match_the_reference():
    a = _data(N=25, M=5, seed=16)
    ard = np.exp(np.random.default_rng(17).uniform(-0.4, 0.4, Q))
    targs = [torch.as_tensor(a[k]) for k in ("X", "S", "Z")]
    jargs = [jnp.asarray(a[k]) for k in ("X", "S", "Z")]
    for fn in ("psi0_linear",):
        assert _rel(getattr(tref, fn)(targs[0], targs[1], torch.as_tensor(ard)),
                    getattr(jref, fn)(jargs[0], jargs[1], jnp.asarray(ard))) <= TOL
    for fn in ("psi1_linear", "psi2_linear"):
        assert _rel(getattr(tref, fn)(*targs, torch.as_tensor(ard)),
                    getattr(jref, fn)(*jargs, jnp.asarray(ard))) <= TOL
    v, ls = np.float64(1.3), np.array([0.8, 1.2])
    assert _rel(tref.phi_exact_rbf(targs[0], targs[2], torch.as_tensor(v), torch.as_tensor(ls)),
                jref.phi_exact_rbf(jargs[0], jargs[2], jnp.asarray(v), jnp.asarray(ls))) <= TOL
    kp = {"log_ard": np.log(ard)}
    got = tps.expected_stats_linear(_torch_tree(kp), targs[0], targs[1],
                                    torch.as_tensor(a["Y"]), targs[2])
    want = jps.expected_stats_linear(_jax_tree(kp), jargs[0], jargs[1],
                                     jnp.asarray(a["Y"]), jargs[2])
    for name, g, w in zip(tps.SuffStats._fields, got, want):
        assert _rel(g, w) <= TOL, name
    tkern, jkern = _pair("matern32")
    p = _np_params(tkern, seed=18)
    beta = 50.0
    got = tsvgp.exact_gp_log_marginal(tkern.K(_torch_tree(p), targs[0]),
                                      torch.as_tensor(a["Y"]),
                                      torch.tensor(beta, dtype=torch.float64))
    want = jsvgp.exact_gp_log_marginal(jkern.K(_jax_tree(p), jargs[0]),
                                       jnp.asarray(a["Y"]), jnp.asarray(beta))
    assert _rel(got, want) <= TOL
    beta = torch.tensor(beta, dtype=torch.float64)
    # the collapsed bound through a Matern stays below the exact marginal
    stats = tkern.exact_suff_stats(_torch_tree(p), targs[0], torch.as_tensor(a["Y"]),
                                   targs[0][:8])
    terms = tsvgp.collapsed_bound(tkern.K(_torch_tree(p), targs[0][:8]), stats,
                                  beta, 3)
    assert float(terms.bound) <= float(got)


def test_capabilities_match_the_reference():
    for name in tk.available():
        for dim in (1, 2):
            if name in ("sum", "product"):  # a composite needs its parts
                got, want = _messages(lambda: tk.capabilities(name, dim),
                                      lambda: jk.capabilities(name, dim), ValueError)
                assert got == want
                continue
            assert tk.capabilities(name, dim) == jk.capabilities(name, dim), (name, dim)
    for spec in CASES.values():
        tkern, jkern = _pair(spec)
        assert tk.capabilities(tkern) == jk.capabilities(jkern), spec
        assert tkern.supports_psi() == jkern.supports_psi()
    one = ("sum", "matern32", "matern12")
    assert tk.capabilities(tk.Sum(tk.Matern32(1), tk.Matern12(1)))["sde"]
    assert tk.capabilities(tk.Product(tk.Matern32(1), tk.RBF(1))) == \
        jk.capabilities(jk.Product(jk.Matern32(1), jk.RBF(1)))
    assert repr(_pair(one)[0]) == repr(_pair(one)[1])


def _messages(fn_t, fn_j, exc):
    with pytest.raises(exc) as et:
        fn_t()
    with pytest.raises(exc) as ej:
        fn_j()
    return str(et.value).replace("repro_torch", "repro"), str(ej.value)


def test_errors_are_the_references():
    a = _data(N=6, M=2, seed=19)
    t = [torch.as_tensor(a[k]) for k in "XSYZ"]
    j = [jnp.asarray(a[k]) for k in "XSYZ"]
    checks = []
    for spec in ("matern12", "matern32", "matern52", ("sum", "rbf", "matern32")):
        tkern, jkern = _pair(spec)
        tp, jp = _torch_tree(_np_params(tkern)), _jax_tree(_np_params(tkern))
        checks.append((lambda tkern=tkern, tp=tp: tkern.expected_suff_stats(tp, *t),
                       lambda jkern=jkern, jp=jp: jkern.expected_suff_stats(jp, *j),
                       NotImplementedError))
    for spec in ("linear", "matern32", ("sum", "rbf", "linear"), ("product", "rbf", "linear")):
        tkern, jkern = _pair(spec)
        tp, jp = _torch_tree(_np_params(tkern)), _jax_tree(_np_params(tkern))
        for backend in ("fused", "pallas"):
            checks.append((lambda tkern=tkern, tp=tp, b=backend: tkern.exact_suff_stats(
                               tp, t[0], t[2], t[3], backend=b),
                           lambda jkern=jkern, jp=jp, b=backend: jkern.exact_suff_stats(
                               jp, j[0], j[2], j[3], backend=b), ValueError))
    tkern, jkern = _pair(("product", "rbf", "linear"))
    tp, jp = _torch_tree(_np_params(tkern)), _jax_tree(_np_params(tkern))
    checks.append((lambda: tkern.psi1(tp, t[0], t[1], t[3]),
                   lambda: jkern.psi1(jp, j[0], j[1], j[3]), NotImplementedError))
    checks.append((lambda: tk.RBF(1).to_sde({}), lambda: jk.RBF(1).to_sde({}),
                   NotImplementedError))
    checks.append((lambda: tk.Matern32(2).to_sde({}), lambda: jk.Matern32(2).to_sde({}),
                   NotImplementedError))
    checks.append((lambda: tk.Sum(tk.RBF(1), tk.Linear(1)).init(k2={}),
                   lambda: jk.Sum(jk.RBF(1), jk.Linear(1)).init(k2={}), TypeError))
    checks.append((lambda: tk.Sum(tk.RBF(1), tk.Linear(1)).init(k0=2.0),
                   lambda: jk.Sum(jk.RBF(1), jk.Linear(1)).init(k0=2.0), TypeError))
    checks.append((lambda: tk.Product(tk.RBF(1)), lambda: jk.Product(jk.RBF(1)), ValueError))
    checks.append((lambda: tk.Sum(tk.RBF(1), tk.RBF(2)),
                   lambda: jk.Sum(jk.RBF(1), jk.RBF(2)), ValueError))
    for fn_t, fn_j, exc in checks:
        got, want = _messages(fn_t, fn_j, exc)
        assert got == want


def test_facades_fail_as_the_references_do():
    rng = np.random.default_rng(20)
    Y = rng.normal(size=(12, 3))
    X = rng.normal(size=(12, 1))
    got, want = _messages(
        lambda: BayesianGPLVM(kernel=tk.Matern32(1), M=4, device="cpu").fit(Y, steps=1),
        lambda: JBayesianGPLVM(kernel=jk.Matern32(1), M=4).fit(jnp.asarray(Y), steps=1),
        NotImplementedError)
    assert got == want
    for backend in ("fused", "pallas"):
        got, want = _messages(
            lambda: SparseGPRegression(kernel=tk.Matern32(1), M=4, backend=backend,
                                       device="cpu").fit(X, Y, steps=1),
            lambda: JSparseGPRegression(kernel=jk.Matern32(1), M=4, backend=backend
                                        ).fit(jnp.asarray(X), jnp.asarray(Y), steps=1),
            ValueError)
        assert got == want


def test_composite_init_takes_slots_device_and_dtype():
    kern = tk.Sum(tk.RBF(2), tk.Linear(2))
    p = kern.init(k0={"variance": 2.0, "lengthscale": 0.5}, k1={"variance": 3.0},
                  device="cpu", dtype=torch.float64)
    want = jk.Sum(jk.RBF(2), jk.Linear(2)).init(
        k0={"variance": 2.0, "lengthscale": 0.5}, k1={"variance": 3.0})
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), p))
    for g, w in zip(jax.tree.leaves(p), jax.tree.leaves(want)):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        assert _rel(g, w) <= 1e-7  # the reference's init is float32
    for name in tk.available():
        kern = _pair(name if name not in ("sum", "product") else (name, "rbf", "linear"))[0]
        for leaf in jax.tree.leaves(kern.init(device="cpu")):
            assert leaf.dtype == torch.float32


FIT_CASES = {
    "sgpr-sum-linear-matern32": ("sgpr", ("sum", "linear", "matern32"), "jnp"),
    "sgpr-matern52": ("sgpr", "matern52", "jnp"),
    "sgpr-product-matern": ("sgpr", ("product", "matern32", "rbf"), "jnp"),
    "gplvm-sum": ("gplvm", ("sum", "rbf", "linear"), "jnp"),
    "gplvm-product-fused": ("gplvm", ("product", "rbf", "rbf"), "fused"),
    "gplvm-product-pallas": ("gplvm", ("product", "rbf", "rbf"), "pallas"),
}


@pytest.mark.parametrize("case", FIT_CASES, ids=str)
def test_three_step_fit_matches_the_reference(case):
    """Three Adam steps through each facade from the same float64 params
    (carried across as numpy arrays by `convert.params_from_numpy`); the
    reference runs "jnp"."""
    model, spec, backend = FIT_CASES[case]
    tkern, jkern = _pair(spec)
    rng = np.random.default_rng(21)
    N, M, D = 40, 6, 2
    Y = np.sin(rng.normal(size=(N, Q)) @ rng.normal(size=(Q, D))) + 0.1 * rng.normal(size=(N, D))
    p_np = {"kern": _np_params(tkern, seed=22), "Z": rng.normal(size=(M, Q)),
            "log_beta": np.float64(2.0)}
    if model == "gplvm":
        p_np["q_mu"] = rng.normal(size=(N, Q))
        p_np["q_logS"] = np.log(rng.uniform(0.05, 0.3, (N, Q)))
        jm = JBayesianGPLVM(kernel=jkern, M=M).fit(
            jnp.asarray(Y), steps=3, log_every=1, params=_jax_tree(p_np))
        tm = BayesianGPLVM(kernel=tkern, M=M, backend=backend, device="cpu").fit(
            Y, steps=3, log_every=1, params=convert.params_from_numpy(p_np, device="cpu"))
    else:
        X = rng.normal(size=(N, Q))
        jm = JSparseGPRegression(kernel=jkern, M=M).fit(
            jnp.asarray(X), jnp.asarray(Y), steps=3, log_every=1, params=_jax_tree(p_np))
        tm = SparseGPRegression(kernel=tkern, M=M, backend=backend, device="cpu").fit(
            X, Y, steps=3, log_every=1, params=convert.params_from_numpy(p_np, device="cpu"))
    assert len(tm.history) == 3
    assert _rel(np.array(tm.history), np.array(jm.history)) <= FIT_TOL
    for g, w in zip(jax.tree.leaves(tm.params), jax.tree.leaves(jm.params)):
        assert _rel(g, w) <= FIT_TOL
    # the fitted model serves the reference's prediction
    Xt = np.linspace(-1.5, 1.5, 5)[:, None].repeat(Q, 1)
    for g, w in zip(tm.predict(Xt), jm.predict(jnp.asarray(Xt))):
        assert _rel(g, w) <= FIT_TOL


def test_state_nbytes_counts_nested_kernel_params():
    """`PosteriorState.nbytes` walks a composite's nested params, and comes
    to the reference state's bytes."""
    tkern, jkern = _pair(("sum", "rbf", "linear"))
    rng = np.random.default_rng(23)
    X, Y, Z = rng.normal(size=(20, Q)), rng.normal(size=(20, 2)), rng.normal(size=(5, Q))
    p_np = {"kern": _np_params(tkern, seed=24), "Z": Z, "log_beta": np.float64(1.0)}
    tp = convert.params_from_numpy(p_np, device="cpu")
    tstate = build_state(tkern, tp, tkern.exact_suff_stats(
        tp["kern"], torch.as_tensor(X), torch.as_tensor(Y), tp["Z"]))
    jp = _jax_tree(p_np)
    jstate_ = jstate.build_state(jkern, jp, jkern.exact_suff_stats(
        jp["kern"], jnp.asarray(X), jnp.asarray(Y), jp["Z"]))
    assert tstate.nbytes == jstate_.nbytes
    assert tstate.kern["k0"]["log_lengthscale"].shape == (Q,)
    # the reference's parameters give the same GP-LVM loss in both packages
    p_np["q_mu"], p_np["q_logS"] = rng.normal(size=(20, Q)), np.full((20, Q), -1.0)
    got = tgplvm.loss(convert.params_from_numpy(p_np, device="cpu"),
                      torch.as_tensor(Y), kernel=tkern)
    want = jgplvm.loss(_jax_tree(p_np), jnp.asarray(Y), kernel=jkern)
    assert _rel(got, want) <= TOL
