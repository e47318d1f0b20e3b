"""`repro_torch.tune` on the CPU: the cache, resolution, candidate, chunk
and concurrency cases of tests/test_tune.py against the port (a fake
stopwatch where a case times), the warm-cache second process doing zero
timing runs (tuning forced on the CPU through the environment),
`chunk="auto"` equal to the explicit winner, the CPU path of `ops` never
consulting the tuner, the wave-count search over a stand-in card (each
untuned split count the same as the wrappers' launch before tuning
existed), and the lock order of the port's threaded modules.

Where statistics are compared, chunked and one-shot sums differ only in
the order of float64 additions: RTOL = 1e-10 relative to max|reference|.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import tune
from repro_torch.gp import ExpectedBatch, get, suff_stats
from repro_torch.gp.models import BayesianGPLVM
from repro_torch.kernels import ops
from repro_torch.kernels import psi1 as tp1
from repro_torch.kernels import suffstats as tss
from repro_torch.tune import autotune, cache, search

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = search.Problem(N=64, M=16, Q=3, D=2)
RTOL = 1e-10
KERNELS = tuple(search.KERNELS)


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """Isolated cache file + clean memo + tuning force-DISABLED."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(cache.CACHE_ENV, path)
    monkeypatch.delenv(search.MAX_CANDIDATES_ENV, raising=False)
    monkeypatch.setattr(autotune, "_ENABLED_OVERRIDE", False)
    tune.clear_memo()
    yield path
    tune.clear_memo()


@pytest.fixture
def tuning_on(tune_env, monkeypatch):
    """Same isolation, but with the measuring path live."""
    monkeypatch.setattr(autotune, "_ENABLED_OVERRIDE", True)
    return tune_env


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


# ---------------------------------------------------------------------------
# persistent cache store
# ---------------------------------------------------------------------------

def test_cache_round_trip(tune_env):
    cache.store("k1", {"winner": 2}, tune_env)
    cache.store("k2", {"winner": 2048}, tune_env)
    assert cache.lookup("k1", tune_env) == {"winner": 2}
    assert cache.lookup("k2", tune_env) == {"winner": 2048}
    doc = json.load(open(tune_env))  # schema-stamped, whole-document JSON
    assert doc["schema_version"] == cache.SCHEMA_VERSION
    assert set(doc["entries"]) == {"k1", "k2"}


def test_cache_schema_mismatch_rejected(tune_env):
    with open(tune_env, "w") as f:
        json.dump({"schema_version": cache.SCHEMA_VERSION + 1,
                   "entries": {"k": {"winner": 4}}}, f)
    assert cache.load_entries(tune_env) == {}
    assert cache.lookup("k", tune_env) is None


@pytest.mark.parametrize("content", [
    "", "{", "[1, 2, 3]", '{"entries": {"k": 1}}', "\x00\x01garbage",
    '{"schema_version": 1, "entries": "not a dict"}',
])
def test_cache_corrupt_file_falls_back_without_raising(tune_env, content):
    with open(tune_env, "w") as f:
        f.write(content)
    assert cache.load_entries(tune_env) == {}
    before = tune.timing_runs()
    assert tune.best_blocks("kfu_pallas", dtype=torch.float32, m=16, q=3,
                            device="cpu") is None
    assert tune.timing_runs() == before


def test_cache_store_over_corrupt_file_recovers(tune_env):
    with open(tune_env, "w") as f:
        f.write("definitely not json")
    cache.store("k", {"winner": 4}, tune_env)
    assert cache.lookup("k", tune_env) == {"winner": 4}


def test_cache_missing_file_is_empty(tune_env):
    assert not os.path.exists(tune_env)
    assert cache.load_entries(tune_env) == {}


def test_cache_path_env_override_and_default(tune_env, monkeypatch):
    assert cache.cache_path() == tune_env
    monkeypatch.delenv(cache.CACHE_ENV)
    assert cache.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "tune.json")


# ---------------------------------------------------------------------------
# resolution: disabled -> defaults with zero timing, cached -> winner
# ---------------------------------------------------------------------------

def test_enabled_policy(monkeypatch):
    monkeypatch.setattr(autotune, "_ENABLED_OVERRIDE", None)
    monkeypatch.delenv(autotune.TUNE_ENV, raising=False)
    assert not tune.enabled("cpu")
    assert tune.enabled("cuda:0")  # on exactly for a CUDA device
    monkeypatch.setenv(autotune.TUNE_ENV, "1")
    assert tune.enabled("cpu")
    monkeypatch.setenv(autotune.TUNE_ENV, "off")
    assert not tune.enabled("cuda:0")
    monkeypatch.setattr(autotune, "_ENABLED_OVERRIDE", True)  # the override wins
    assert tune.enabled("cpu")


def test_key_names_what_and_where():
    key = tune.make_key("blocks", "psi2_pallas", torch.float64, 100, 1, device="cpu")
    assert key == "blocks|psi2_pallas|float64|M=100|Q=1|cpu|cpu"
    assert tune.make_key("chunk", "streaming_suff_stats", None, 8, 2,
                         extra="backend=fused", device="cpu").endswith(
        "float32|M=8|Q=2|cpu|cpu|backend=fused")


def test_disabled_resolution_returns_defaults_without_timing(tune_env):
    before = tune.timing_runs()
    assert tune.best_blocks("psi1_pallas", dtype=torch.float32, m=128, q=3,
                            device="cpu") is None
    assert tune.best_chunk(n=512, m=16, q=2, d=1, device="cpu") == tune.DEFAULT_CHUNK
    assert tune.timing_runs() == before


def test_cached_winner_resolves_without_timing(tune_env):
    key = tune.make_key("blocks", "kfu_pallas", torch.float32, 128, 3, device="cpu")
    cache.store(key, {"winner": 4}, tune_env)
    tune.clear_memo()
    before = tune.timing_runs()
    assert tune.best_blocks("kfu_pallas", dtype=torch.float32, m=128, q=3,
                            device="cpu") == 4
    assert tune.timing_runs() == before


def test_first_call_measures_and_persists(tuning_on, monkeypatch):
    timed = []
    monkeypatch.setattr(autotune, "_time_fn",
                        lambda fn: float(len(timed)) + (timed.append(1) or 1.0))
    monkeypatch.setenv(search.MAX_CANDIDATES_ENV, "2")
    before = tune.timing_runs()
    win = tune.best_blocks("kfu_pallas", dtype=torch.float32, m=SMALL.M,
                           q=SMALL.Q, problem=SMALL, device="cpu")
    assert win == tune.DEFAULT_WAVES  # the fake stopwatch favours the first
    assert tune.timing_runs() == before + 2  # counted even with the fake stopwatch
    entry = cache.lookup(tune.make_key("blocks", "kfu_pallas", torch.float32,
                                       SMALL.M, SMALL.Q, device="cpu"), tuning_on)
    assert entry["winner"] == win and set(entry["timings_s"]) == {"1", "2"}
    tune.clear_memo()  # persisted: a fresh memo resolves from the file
    assert tune.best_blocks("kfu_pallas", dtype=torch.float32, m=SMALL.M,
                            q=SMALL.Q, problem=SMALL, device="cpu") == win
    assert tune.timing_runs() == before + 2


def test_measurement_picks_the_fastest(tuning_on, monkeypatch):
    times = iter([3.0, 1.0, 2.0])
    monkeypatch.setattr(autotune, "_time_fn", lambda fn: next(times))
    assert tune.best_blocks("psi2_bwd_pallas", dtype=torch.float64, m=SMALL.M,
                            q=SMALL.Q, problem=SMALL, device="cpu") == 2


def test_concurrent_first_call_resolves_to_one_winner(tuning_on, monkeypatch):
    calls = []

    def fake_time(fn):
        calls.append(1)
        return float(len(calls))  # monotone: the first candidate always wins

    monkeypatch.setattr(autotune, "_time_fn", fake_time)
    monkeypatch.setenv(search.MAX_CANDIDATES_ENV, "2")
    results = []

    def worker():
        results.append(tune.best_blocks("kfu_pallas", dtype=torch.float32,
                                        m=SMALL.M, q=SMALL.Q, problem=SMALL,
                                        device="cpu"))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(results) == 2 and results[0] == results[1]
    assert len(calls) == 2  # exactly one thread measured: one 2-candidate sweep
    entries = cache.load_entries(tuning_on)
    assert sum(1 for k in entries if k.startswith("blocks|")) == 1


def test_cpu_measurement_runs_the_plain_versions(tuning_on):
    """Forced on the CPU, every candidate runs the plain version (no grid):
    the real stopwatch, every kernel, both directions."""
    before = tune.timing_runs()
    for name in KERNELS:
        assert tune.best_blocks(name, dtype=torch.float64, m=SMALL.M, q=SMALL.Q,
                                problem=SMALL, device="cpu") in search.WAVE_CANDIDATES
    assert tune.timing_runs() == before + len(KERNELS) * len(search.WAVE_CANDIDATES)


def test_warm_cache_second_process_does_zero_timing_runs(tmp_path):
    path = str(tmp_path / "tune.json")
    env = dict(os.environ, REPRO_TORCH_TUNE="1", REPRO_TORCH_TUNE_CACHE=path,
               REPRO_TORCH_TUNE_MAX_CANDIDATES="2",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    prog = (
        "import torch\n"
        "from repro_torch import tune\n"
        "p = tune.Problem(N=64, M=16, Q=3, D=2)\n"
        "w = tune.best_blocks('kfu_pallas', dtype=torch.float32, m=16, q=3,"
        " problem=p, device='cpu')\n"
        "c = tune.best_chunk(n=300, m=8, q=2, d=1, dtype=torch.float64,"
        " backend='jnp', device='cpu')\n"
        "assert w is not None\n"
        "print('RUNS', tune.timing_runs(), w, c)\n"
    )
    first = subprocess.run([sys.executable, "-c", prog], env=env,
                           capture_output=True, text=True, timeout=240)
    assert first.returncode == 0, first.stderr
    runs, w, c = first.stdout.split()[1:]
    assert runs == "4"  # two wave counts, two chunks
    second = subprocess.run([sys.executable, "-c", prog], env=env,
                            capture_output=True, text=True, timeout=240)
    assert second.returncode == 0, second.stderr
    assert second.stdout.split()[1:] == ["0", w, c]  # the warm-cache contract


# ---------------------------------------------------------------------------
# the search space over a stand-in card
# ---------------------------------------------------------------------------

class FakeCard:
    """What `search.Card` reports, with H100-like numbers: 132 SMs; psi2
    pair blocks of 512 pairs, 2 a multiprocessor, runs of 128; 8 cross
    blocks, 2 psi1-reverse blocks and 3 B2 point-pass blocks a
    multiprocessor."""
    sms = 132

    def psi2_geometry(self, lib, dtype, Q):
        return tss.Geometry(512, 2, 128, 1 if lib.endswith("fwd") else 8)

    def cross_resident(self, lib, dtype, Q, cols):
        return 8

    def psi1_bwd_resident(self, dtype, M, Q, plan):
        return 2

    def point_resident(self, dtype, Q):
        return 3


def _parent_counts(name, N, M, Q, D, dtype, card):
    """The split counts each wrapper launched before tuning existed, in the
    formulas of its parent commit; the reverse pair passes (B2, B4) split
    each chunk of about N / (pair blocks) points, whole point-pass blocks,
    over which they run since their per-point scratch lost its pair-block
    factor. B2's dZ pass, once split as (TARGET_BLOCKS over its 32-column
    tiles, no split under 64 points), is gone: its point pass sums dZ."""
    size = torch.finfo(dtype).bits // 8
    if name in ("suffstats_pallas", "suffstats_bwd_pallas", "psi2_pallas",
                "psi2_bwd_pallas"):
        geo = card.psi2_geometry(search.KERNELS[name].lib, dtype, Q)
        blocks = -(-M * (M + 1) // 2 // geo.pairs_per_block)
        points = N
        if name in ("suffstats_bwd_pallas", "psi2_bwd_pallas"):
            points = min(N, -(-(-(-N // blocks)) // 256) * 256)
        p2 = max(1, min(geo.blocks_per_sm * card.sms // blocks, points // geo.run))
        if name == "suffstats_pallas":
            y_blocks = -(-M // 32) * -(-D // 8)
            return p2, max(1, min(-(-tss.TARGET_BLOCKS // y_blocks), -(-N // 64)))
        return (p2,)
    if name == "psi1_bwd_pallas":
        plan = tss.psi1_bwd_plan(M, Q, size)
        resident = card.psi1_bwd_resident(dtype, M, Q, plan) * card.sms
        return (max(1, min(resident, -(-N // plan.run))),)
    tiles = -(-M // tp1.cross_cols(M, Q))
    resident = card.cross_resident(None, dtype, Q, None) * card.sms
    return (max(1, min(resident // tiles, -(-N // tp1.cross_run(Q)))),)


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("shape", [(1_000_003, 100, 1, 3), (100_003, 256, 4, 5),
                                   (37, 130, 3, 3), (20_000, 64, 20, 3)])
def test_one_wave_is_the_untuned_launch(name, shape):
    """With tuning off every wrapper launches one wave, whose split counts
    are those of the launch before tuning existed."""
    N, M, Q, D = shape
    for dtype in (torch.float32, torch.float64):
        plan = search.launch_plan(name, 1, search.Problem(N, M, Q, D), dtype, FakeCard())
        assert plan.counts == _parent_counts(name, N, M, Q, D, dtype, FakeCard())


@pytest.mark.parametrize("name", KERNELS)
def test_candidates_start_with_default_and_pass_the_gate(name):
    card = FakeCard()
    prob = search.measure_problem(name, 100, 1, torch.float32, card)
    assert prob.N >= search.MEASURE_N and (prob.M, prob.Q) == (100, 1)
    cands = search.candidate_blocks(name, problem=prob, dtype=torch.float32, card=card)
    assert cands == list(search.WAVE_CANDIDATES)  # all three, default first
    grids = [search.launch_plan(name, w, prob, torch.float32, card) for w in cands]
    assert len({g.counts for g in grids}) == len(cands)  # each a different grid
    for w, g in zip(cands, grids):
        assert all(s.want <= s.most for s in g.splits)  # no split shorter than a run
        assert g.scratch_bytes <= search.SCRATCH_LIMIT
    # the measuring N is the smallest at which that holds (or 1e5)
    if prob.N > search.MEASURE_N:
        smaller = search.Problem(prob.N - 1, 100, 1, 3)
        plan = search.launch_plan(name, 4, smaller, torch.float32, card)
        assert any(s.want > s.most for s in plan.splits)


def test_clamped_and_repeated_grids_are_not_candidates():
    card = FakeCard()
    # at N = 2,000 even two waves of psi1-reverse blocks want more splits
    # than runs of points exist: only the default is admissible
    small = search.Problem(2000, 100, 1, 3)
    assert search.candidate_blocks("psi1_bwd_pallas", problem=small, card=card) == [1]
    assert not search.admissible("psi1_bwd_pallas", 2, problem=small, card=card)
    # at M = 1000 one pair block exceeds a wave: one and two waves launch
    # the same single split, so two waves is dropped
    big_m = search.Problem(10_000_000, 1000, 1, 3)
    cands = search.candidate_blocks("psi2_pallas", problem=big_m, card=card)
    assert 2 not in cands and cands[0] == 1


def test_scratch_and_shared_memory_gate(monkeypatch):
    card = FakeCard()
    # B2's pair partials, (P2, Q + 1, M(M+1)/2), grow with the waves (its
    # dZ totals do not): a limit between two and four waves' scratch admits
    # [1, 2]
    prob = search.measure_problem("suffstats_bwd_pallas", 100, 1, torch.float64, card)
    plans = {w: search.launch_plan("suffstats_bwd_pallas", w, prob, torch.float64, card)
             for w in search.WAVE_CANDIDATES}
    assert plans[1].scratch_bytes < plans[2].scratch_bytes < plans[4].scratch_bytes
    monkeypatch.setattr(search, "SCRATCH_LIMIT", plans[2].scratch_bytes)
    assert search.candidate_blocks("suffstats_bwd_pallas", problem=prob,
                                   dtype=torch.float64, card=card) == [1, 2]
    # a Q no block's shared memory holds admits nothing, not even the default
    assert search.candidate_blocks("psi2_pallas", problem=search.Problem(1000, 8, 4000),
                                   card=card) == []
    assert search.candidate_blocks("psi2_pallas", problem=search.Problem(1000, 8, 4000)) == []
    with pytest.raises(ValueError, match="shared memory"):
        search.launch_plan("suffstats_bwd_pallas", 1, search.Problem(10**6, 1000, 60, 3),
                           torch.float64, card)


def test_candidate_limit_env(monkeypatch):
    monkeypatch.setenv(search.MAX_CANDIDATES_ENV, "2")
    assert search.candidate_blocks("psi1_pallas", problem=SMALL) == [1, 2]
    card = FakeCard()
    prob = search.measure_problem("psi1_pallas", 100, 1, None, card)
    assert search.candidate_blocks("psi1_pallas", problem=prob, card=card) == [1, 2]


def test_unknown_kernel_name_raises():
    with pytest.raises(KeyError, match="suffstats_pallas"):
        search.default_blocks("bogus_pallas")


def test_chunk_candidates_respect_n():
    cands = search.candidate_chunks(1500)
    assert cands[0] == search.DEFAULT_CHUNK
    assert 1500 in cands
    assert all(c <= 1500 or c == search.DEFAULT_CHUNK for c in cands)
    assert search.candidate_chunks(10_000, limit=2) == [4096, 1024]


# ---------------------------------------------------------------------------
# ops: the CPU path never consults the tuner; a pinned block is accepted
# ---------------------------------------------------------------------------

def _psi_args(n=24, m=16, q=3, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(a).requires_grad_() for a in (
        rng.normal(size=(n, q)), np.exp(0.2 * rng.normal(size=(n, q))),
        rng.normal(size=(m, q)), np.exp(0.1 * rng.normal()),
        np.exp(0.1 * rng.normal(size=q))))


def _through_all_ops(**kw):
    mu, S, Z, var, ls = _psi_args()
    Y = torch.ones(mu.shape[0], 2, dtype=mu.dtype)
    outs = [ops.kfu(mu, Z, var, ls, **kw), ops.psi1(mu, S, Z, var, ls, **kw),
            ops.psi2(mu, S, Z, var, ls, **kw), *ops.suffstats(mu, S, Y, Z, var, ls, **kw)]
    grads = torch.autograd.grad(sum(o.sum() for o in outs), (mu, S, Z, var, ls))
    return [o.detach() for o in outs], grads


def test_cpu_ops_never_consult_the_tuner(tuning_on, monkeypatch):
    asked = []

    def spy(*a, **kw):
        asked.append(a)
        raise AssertionError("the CPU path consulted the tuner")

    monkeypatch.setattr(autotune, "best_blocks", spy)
    monkeypatch.setattr(tune, "best_blocks", spy)
    monkeypatch.setattr(autotune, "_time_fn", spy)
    before = tune.timing_runs()
    _through_all_ops()
    assert asked == [] and tune.timing_runs() == before


def test_explicit_block_matches_defaults_on_the_cpu(tune_env):
    base, gbase = _through_all_ops()
    alt, galt = _through_all_ops(block=4, bwd_block=2)
    for a, b in zip(base + list(gbase), alt + list(galt)):
        assert torch.equal(a, b)  # the plain versions have no grid
    with pytest.raises(ValueError, match="block"):
        ops.psi1(*_psi_args(), block=0)
    with pytest.raises(ValueError, match="bwd_block"):
        ops.kfu(*[_psi_args()[i] for i in (0, 2, 3, 4)], bwd_block=(64, 128))


# ---------------------------------------------------------------------------
# chunk="auto"
# ---------------------------------------------------------------------------

def _batch(n=37, m=8, q=2, seed=1):
    rng = np.random.default_rng(seed)
    return ExpectedBatch(torch.as_tensor(rng.normal(size=(n, q))),
                         torch.as_tensor(np.exp(0.2 * rng.normal(size=(n, q)))),
                         torch.as_tensor(rng.normal(size=(n, 1))),
                         torch.linspace(-1, 1, m, dtype=torch.float64)[:, None]
                         * torch.ones(m, q, dtype=torch.float64))


def test_chunk_auto_matches_explicit(tune_env):
    kern = get("rbf")(2)
    params = kern.init(device="cpu", dtype=torch.float64)
    batch = _batch()
    auto = suff_stats(kern, params, batch, backend="jnp", chunk="auto")
    explicit = suff_stats(kern, params, batch, backend="jnp", chunk=tune.DEFAULT_CHUNK)
    for a, b in zip(auto, explicit):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="auto"):
        suff_stats(kern, params, batch, backend="jnp", chunk="turbo")


def test_chunk_auto_uses_cached_winner(tune_env):
    key = tune.make_key("chunk", "streaming_suff_stats", torch.float64, 8, 2,
                        extra="backend=jnp", device="cpu")
    cache.store(key, {"winner": 7}, tune_env)
    tune.clear_memo()
    kern = get("rbf")(2)
    params = kern.init(device="cpu", dtype=torch.float64)
    batch = _batch(n=21)
    model = BayesianGPLVM(get("rbf")(2), M=8, chunk="auto", device="cpu")
    assert model.chunk == "auto"  # the facade keeps "auto"
    assert tune.best_chunk(n=21, m=8, q=2, d=1, dtype=torch.float64,
                           backend="jnp", device="cpu") == 7
    auto = suff_stats(kern, params, batch, backend="jnp", chunk="auto")
    explicit = suff_stats(kern, params, batch, backend="jnp", chunk=7)
    for a, b in zip(auto, explicit):
        assert torch.equal(a, b)
    one_shot = suff_stats(kern, params, batch, backend="jnp")
    for a, b in zip(auto, one_shot):
        assert _rel(a, b) <= RTOL


def test_chunk_auto_measures_when_tuning(tuning_on, monkeypatch):
    """Forced on: the chunk ladder is timed through the real streaming
    loop and the winner (here the fake stopwatch's pick) is what
    chunk="auto" streams with, through the facade as well."""
    assert search.candidate_chunks(1500) == [4096, 1024, 1500]
    times = iter([3.0, 1.0, 2.0] * 2)  # the facade's float32 key measures too
    seen = []
    monkeypatch.setattr(autotune, "_time_fn",
                        lambda fn: seen.append(fn) or next(times))
    kern = get("rbf")(2)
    params = kern.init(device="cpu", dtype=torch.float64)
    batch = _batch(n=1500)
    auto = suff_stats(kern, params, batch, backend="jnp", chunk="auto")
    assert tune.best_chunk(n=1500, m=8, q=2, d=1, dtype=torch.float64,
                           backend="jnp", device="cpu") == 1024
    assert len(seen) == 3
    for a, b in zip(auto, suff_stats(kern, params, batch, backend="jnp", chunk=1024)):
        assert torch.equal(a, b)
    Y = batch.Y.numpy()
    model = BayesianGPLVM(get("rbf")(2), M=8, chunk="auto", device="cpu")
    model.fit(Y, steps=2)
    assert np.isfinite(model.history).all() and len(seen) == 6


# ---------------------------------------------------------------------------
# the lock order of the port's threaded modules
# ---------------------------------------------------------------------------

def test_port_lock_order_has_no_cycle():
    """The reference's static analyzer over the port's serve/, tune/ and
    checkpoint/ modules: no lock-order cycle or hierarchy inversion
    (ANL005), and the server's _budget_lock -> _Entry.lock ->
    _registry_lock edges are the ones it sees."""
    from repro.analysis.concurrency import analyze_paths

    src = ROOT / "src"
    paths = sorted(p for d in ("serve", "tune", "checkpoint")
                   for p in (src / "repro_torch" / d).glob("*.py"))
    model = analyze_paths(paths=paths, root=src)
    assert not [f.describe() for f in model.findings if f.code == "ANL005"]
    assert ("GPServer._budget_lock", "_Entry.lock") in model.edges
    assert ("_Entry.lock", "GPServer._registry_lock") in model.edges
