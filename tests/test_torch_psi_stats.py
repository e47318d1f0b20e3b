"""The port's statistics layer (`repro_torch.core.psi_stats`,
`repro_torch.gp.stats`) against the JAX reference on the same float64
inputs from numpy seeds, at 1e-10 relative to max|reference|: exact and
expected RBF statistics on both backends, the chunked Psi2, the SuffStats
monoid, and the streaming engine's explicit tail chunk."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import psi_stats as jps
from repro.gp import kernels as jkernels
from repro.gp import stats as jstats
from repro_torch.core import psi_stats as tps
from repro_torch.gp import kernels as tkernels
from repro_torch.gp import stats as tstats

RTOL = 1e-10


def _data(N=53, M=11, Q=2, D=3, seed=0):
    rng = np.random.default_rng(seed)
    arrs = {"X": rng.normal(size=(N, Q)), "S": rng.uniform(0.05, 0.5, (N, Q)),
            "Y": rng.normal(size=(N, D)), "Z": 1.1 * rng.normal(size=(M, Q))}
    kern = {"log_variance": np.log(1.3), "log_lengthscale": np.log(
        rng.uniform(0.6, 1.4, Q))}
    return arrs, kern


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) / scale


def _assert_stats(got: tps.SuffStats, want):
    for g, w, name in zip(got, want, tps.SuffStats._fields):
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("backend", ("jnp", "fused"))
def test_exact_stats_match_jax(backend):
    a, k = _data()
    want = jps.exact_stats_rbf(_jax(k), *(jnp.asarray(a[n]) for n in "XYZ"),
                               backend=backend)
    got = tps.exact_stats_rbf(_torch(k), *(torch.as_tensor(a[n]) for n in "XYZ"),
                              backend=backend)
    _assert_stats(got, want)


@pytest.mark.parametrize("backend", ("jnp", "fused", "pallas"))
def test_expected_stats_match_jax(backend):
    a, k = _data()
    names = ("X", "S", "Y", "Z")
    want = jps.expected_stats_rbf(_jax(k), *(jnp.asarray(a[n]) for n in names),
                                  backend=backend)
    got = tps.expected_stats_rbf(_torch(k), *(torch.as_tensor(a[n]) for n in names),
                                 backend=backend)
    _assert_stats(got, want)


@pytest.mark.parametrize("chunk", (1, 16, 256))
def test_psi2_rbf_chunked_matches_jax(chunk):
    a, k = _data(N=70, M=9, Q=3)
    v, l = np.exp(k["log_variance"]), np.exp(k["log_lengthscale"])
    args = (a["X"], a["S"], a["Z"], v, l)
    want = jps._psi2_rbf_chunked(*map(jnp.asarray, args), chunk=chunk)
    got = tps._psi2_rbf_chunked(*map(torch.as_tensor, args), chunk=chunk)
    assert _rel(got, want) <= RTOL


def test_suffstats_monoid_matches_jax():
    a, k = _data(N=40)
    b, _ = _data(N=23, seed=1)
    tk, jk = _torch(k), _jax(k)

    def both(d):
        return (tps.exact_stats_rbf(tk, *(torch.as_tensor(d[n]) for n in "XYZ")),
                jps.exact_stats_rbf(jk, *(jnp.asarray(d[n]) for n in "XYZ")))

    b["Z"] = a["Z"]
    (ta, ja), (tb, jb) = both(a), both(b)
    _assert_stats(tps.SuffStats.combine(ta, tb), jps.SuffStats.combine(ja, jb))
    _assert_stats(tps.SuffStats.subtract(ta, tb), jps.SuffStats.subtract(ja, jb))
    # the inverse round-trips
    back = tps.SuffStats.subtract(tps.SuffStats.combine(ta, tb), tb)
    _assert_stats(back, ja)


@pytest.mark.parametrize("kind", ("exact", "expected"))
@pytest.mark.parametrize("chunk", (7, 16, 53, 100))
def test_streaming_suff_stats_tail_chunk_matches_jax(kind, chunk):
    """53 points in chunks of 7 and 16 end in a tail chunk; 53 is exactly
    one chunk; 100 is a lone tail."""
    a, k = _data()
    kern_t, kern_j = tkernels.get("rbf")(2), jkernels.get("rbf")(2)
    if kind == "exact":
        tb = tstats.ExactBatch(*(torch.as_tensor(a[n]) for n in "XYZ"))
        jb = jstats.ExactBatch(*(jnp.asarray(a[n]) for n in "XYZ"))
    else:
        names = ("X", "S", "Y", "Z")
        tb = tstats.ExpectedBatch(*(torch.as_tensor(a[n]) for n in names))
        jb = jstats.ExpectedBatch(*(jnp.asarray(a[n]) for n in names))
    want = jstats.streaming_suff_stats(kern_j, _jax(k), jb, chunk=chunk)
    got = tstats.streaming_suff_stats(kern_t, _torch(k), tb, chunk=chunk)
    _assert_stats(got, want)
    # and the one-shot path agrees with the streamed one
    _assert_stats(tstats.suff_stats(kern_t, _torch(k), tb), want)


def test_unported_backends_and_knobs_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_TORCH_TUNE", raising=False)
    a, k = _data()
    X, Y, Z = (torch.as_tensor(a[n]) for n in "XYZ")
    # backend="pallas" is ported (the K_fu op): it now equals the plain path
    got = tps.exact_stats_rbf(_torch(k), X, Y, Z, backend="pallas")
    want = tps.exact_stats_rbf(_torch(k), X, Y, Z, backend="jnp")
    for name, g, w in zip(tps.SuffStats._fields, got, want):
        assert _rel(g, w) <= RTOL, name
    with pytest.raises(ValueError, match="backend"):
        tps.exact_stats_rbf(_torch(k), X, Y, Z, backend="xla")
    # chunk="auto" is ported: untuned, it is the default chunk; any other
    # string is refused
    auto = tstats.suff_stats(tkernels.get("rbf")(2), _torch(k),
                             tstats.ExactBatch(X, Y, Z), chunk="auto")
    fixed = tstats.suff_stats(tkernels.get("rbf")(2), _torch(k),
                              tstats.ExactBatch(X, Y, Z), chunk=4096)
    for name, g, w in zip(tps.SuffStats._fields, auto, fixed):
        assert _rel(g, w) <= RTOL, name
    with pytest.raises(ValueError, match="auto"):
        tstats.suff_stats(tkernels.get("rbf")(2), _torch(k),
                          tstats.ExactBatch(X, Y, Z), chunk="turbo")
    # the whole kernel family is ported; an unknown name lists it
    assert tkernels.get("matern52").name == "matern52"
    with pytest.raises(KeyError, match="available"):
        tkernels.get("matern72")


def test_rbf_kernel_matches_jax():
    a, k = _data(N=17)
    X, Z = a["X"], a["Z"]
    kern_t, kern_j = tkernels.get("rbf")(2), jkernels.get("rbf")(2)
    assert _rel(kern_t.K(_torch(k), torch.as_tensor(X), torch.as_tensor(Z)),
                kern_j.K(_jax(k), jnp.asarray(X), jnp.asarray(Z))) <= RTOL
    assert _rel(kern_t.K(_torch(k), torch.as_tensor(X)),
                kern_j.K(_jax(k), jnp.asarray(X))) <= RTOL
    assert _rel(kern_t.Kdiag(_torch(k), torch.as_tensor(X)),
                kern_j.Kdiag(_jax(k), jnp.asarray(X))) <= RTOL
    p = kern_t.init(1.3, 0.8, device="cpu", dtype=torch.float64)
    assert float(p["log_variance"]) == pytest.approx(np.log(1.3))
    assert p["log_lengthscale"].shape == (2,)
