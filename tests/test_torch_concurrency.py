"""The port's concurrency analyzer and lockdep runtime verifier
(`repro_torch.analysis.concurrency`, `repro_torch.analysis.lockdep`), case
for case with tests/test_concurrency.py: seeded AB/BA, unguarded-write and
blocking-under-lock fixtures each trigger exactly their rule; the port's
tree analyzes clean with every discovered lock ranked in the declared
hierarchy (the kernel-build and pinned-precision locks included); lockdep
instruments repo-created locks under watch(), raises LockOrderViolation on
declared-hierarchy and observed-order inversions (check-before-acquire: no
hang), and stays transparent otherwise. The port's serve tests run under
watch() through an autouse fixture in their files — these tests cover the
machinery."""
import pathlib
import threading

import pytest
import torch

from repro.analysis import concurrency as ref_concurrency
from repro_torch.analysis import concurrency, lockdep

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "torch_analysis"


def _analyze_fixture(name):
    src = (FIXTURES / f"{name}.py").read_text()
    return concurrency.analyze_sources([(f"repro_torch/seeded/{name}.py", src)])


# ---------------------------------------------------------------------------
# static pass: seeded violations
# ---------------------------------------------------------------------------

def test_lock_cycle_fixture_flags_exactly_anl005():
    model = _analyze_fixture("lock_cycle")
    codes = {f.code for f in model.findings}
    assert codes == {"ANL005"}, model.findings
    cyc = [f for f in model.findings if "cycle" in f.message]
    assert len(cyc) == 1
    assert "_LEDGER_LOCK" in cyc[0].message
    assert "_JOURNAL_LOCK" in cyc[0].message
    assert "lock_cycle.py:13" in cyc[0].message  # ledger -> journal site
    assert "lock_cycle.py:19" in cyc[0].message  # the reverse edge


def test_unguarded_write_fixture_flags_exactly_anl006():
    model = _analyze_fixture("unguarded_write")
    assert [(f.code, f.line) for f in model.findings] == [("ANL006", 19)]
    f = model.findings[0]
    assert "self._table" in f.message and "Registry._lock" in f.message


def test_blocking_under_lock_fixture_flags_exactly_anl007():
    model = _analyze_fixture("blocking_under_lock")
    assert [(f.code, f.line) for f in model.findings] == [
        ("ANL007", 17), ("ANL007", 18), ("ANL007", 19), ("ANL007", 20)]
    whats = [f.message for f in model.findings]
    assert any("open" in m for m in whats)
    assert any("json.dump" in m for m in whats)
    assert any("torch.cuda.synchronize" in m for m in whats)
    assert any("result" in m for m in whats)
    for f in model.findings:
        assert "_STATE_LOCK" in f.message


@pytest.mark.parametrize("name", ["lock_cycle", "unguarded_write", "blocking_under_lock"])
def test_seeded_fixtures_agree_with_the_reference_analyzer(name):
    """The port's copy finds what the reference's finds on the same source
    (the reference's blocking list knows no torch call, so the device wait
    is the port's alone)."""
    src = (FIXTURES / f"{name}.py").read_text()
    ours = {(f.code, f.line) for f in _analyze_fixture(name).findings}
    theirs = {(f.code, f.line) for f in ref_concurrency.analyze_sources(
        [(f"repro/seeded/{name}.py", src)]).findings}
    assert theirs <= ours
    assert ours - theirs == ({("ANL007", 19)} if name == "blocking_under_lock" else set())


def test_self_deadlock_on_non_reentrant_lock_is_anl005():
    src = (
        "import threading\n"
        "_L = threading.Lock()\n"
        "def twice():\n"
        "    with _L:\n"
        "        with _L:\n"
        "            pass\n"
    )
    model = concurrency.analyze_sources([("repro_torch/seeded/self.py", src)])
    assert [f.code for f in model.findings] == ["ANL005"]
    assert "self-deadlock" in model.findings[0].message
    rsrc = src.replace("threading.Lock()", "threading.RLock()")
    rmodel = concurrency.analyze_sources([("repro_torch/seeded/self.py", rsrc)])
    assert rmodel.findings == []


def test_declared_hierarchy_inversion_without_a_cycle_is_anl005():
    """The declared order is the contract even before the reverse edge
    ships: the precision lock under the registry lock alone is a finding."""
    src = (
        "from repro_torch.analysis import lockdep\n"
        "_precision_lock = lockdep.named_lock(\n"
        "    'repro_torch.core.psi_stats._precision_lock')\n"
        "class GPServer:\n"
        "    def __init__(self):\n"
        "        import threading\n"
        "        self._registry_lock = threading.Lock()\n"
        "    def bad(self):\n"
        "        with self._registry_lock:\n"
        "            with _precision_lock:\n"
        "                pass\n"
    )
    model = concurrency.analyze_sources([("repro_torch/seeded/inv.py", src)])
    assert [f.code for f in model.findings] == ["ANL005"]
    assert "declared" in model.findings[0].message


def test_acquire_release_pairs_are_tracked_like_with_blocks():
    src = (
        "import threading\n"
        "_A = threading.Lock()\n"
        "_B = threading.Lock()\n"
        "def ab():\n"
        "    _A.acquire()\n"
        "    _B.acquire()\n"
        "    _B.release()\n"
        "    _A.release()\n"
        "def ba():\n"
        "    with _B:\n"
        "        _A.acquire()\n"
        "        _A.release()\n"
    )
    model = concurrency.analyze_sources([("repro_torch/seeded/ar.py", src)])
    assert {f.code for f in model.findings} == {"ANL005"}
    assert any("cycle" in f.message for f in model.findings)


def test_locked_suffix_and_init_are_exempt_from_guard_inference():
    src = (
        "class Store:\n"
        "    def __init__(self):\n"
        "        import threading\n"
        "        self._lock = threading.Lock()\n"
        "        self._managers = {}\n"
        "    def save(self, k, v):\n"
        "        with self._lock:\n"
        "            self._managers[k] = v\n"
        "    def _manager_locked(self, k):\n"
        "        return self._managers[k]\n"
    )
    model = concurrency.analyze_sources([("repro_torch/seeded/st.py", src)])
    assert model.findings == []


def test_condition_wait_on_held_cv_is_not_blocking():
    src = (
        "class S:\n"
        "    def __init__(self):\n"
        "        import threading\n"
        "        self._cv = threading.Condition()\n"
        "        self._queue = []\n"
        "    def loop(self):\n"
        "        with self._cv:\n"
        "            while not self._queue:\n"
        "                self._cv.wait()\n"
        "            self._queue.pop()\n"
    )
    model = concurrency.analyze_sources([("repro_torch/seeded/cv.py", src)])
    assert model.findings == []


def test_blocking_ok_locks_may_block():
    """StateStore._lock's documented job is serializing store I/O."""
    src = (
        "import json\n"
        "class StateStore:\n"
        "    def __init__(self):\n"
        "        import threading\n"
        "        self._lock = threading.Lock()\n"
        "    def save(self, path, doc):\n"
        "        with self._lock:\n"
        "            with open(path, 'w') as f:\n"
        "                json.dump(doc, f)\n"
    )
    model = concurrency.analyze_sources([("repro_torch/seeded/ok.py", src)])
    assert model.findings == []


def test_the_build_lock_may_wait_on_nvcc():
    """The kernel-build lock is declared BLOCKING_OK: holding it across an
    nvcc run is its job."""
    src = (
        "import subprocess\n"
        "from repro_torch.analysis import lockdep\n"
        "_lock = lockdep.named_lock('repro_torch.kernels._build._lock')\n"
        "def build(cmd):\n"
        "    with _lock:\n"
        "        subprocess.run(cmd)\n"
    )
    assert concurrency.analyze_sources([("repro_torch/seeded/b.py", src)]).findings == []
    blocked = src.replace("repro_torch.kernels._build._lock", "test.other")
    model = concurrency.analyze_sources([("repro_torch/seeded/b.py", blocked)])
    assert [f.code for f in model.findings] == ["ANL007"]


def test_noqa_alias_anl002_suppresses_anl006():
    src = (FIXTURES / "unguarded_write.py").read_text()
    muted = src.replace("# ANL006: lock-free write races put()", "# noqa: ANL002")
    model = concurrency.analyze_sources([("repro_torch/seeded/uw.py", muted)])
    assert model.findings == []


# ---------------------------------------------------------------------------
# static pass: the port's tree
# ---------------------------------------------------------------------------

def test_src_tree_analyzes_clean_and_every_lock_is_ranked():
    model = concurrency.analyze_paths()
    assert model.findings == [], [f.describe() for f in model.findings]
    # the port's whole lock population is declared in the hierarchy — a
    # new lock must take a rank before it ships
    assert set(model.defs) == set(concurrency.LOCK_HIERARCHY)
    rank = {n: i for i, n in enumerate(concurrency.LOCK_HIERARCHY)}
    for (a, b) in model.edges:
        assert rank[a] < rank[b], (a, b)
    assert ("GPServer._budget_lock", "_Entry.lock") in model.edges
    assert ("_Entry.lock", "GPServer._registry_lock") in model.edges


def test_module_locks_are_named_and_ranked():
    """The four module-level locks are created through named_lock (they
    exist before any watch()), under their hierarchy names."""
    from repro_torch.core import psi_stats
    from repro_torch.kernels import _build
    from repro_torch.tune import autotune, cache

    locks = {autotune._LOCK: "rlock", cache._LOCK: "rlock", _build._lock: "lock",
             psi_stats._precision_lock: "lock"}
    for lk, kind in locks.items():
        assert isinstance(lk, lockdep._Instrumented) and lk.kind == kind
        assert lk.name in concurrency.LOCK_HIERARCHY
    assert concurrency.BLOCKING_OK >= {_build._lock.name, cache._LOCK.name}


# ---------------------------------------------------------------------------
# lockdep: runtime verification
# ---------------------------------------------------------------------------

def test_watch_instruments_repo_locks_and_names_them():
    with lockdep.watch() as rec:
        class Holder:
            def __init__(self):
                self._lock = threading.Lock()

        h = Holder()
        assert isinstance(h._lock, lockdep._Instrumented)
        assert h._lock.name == "Holder._lock"
        with h._lock:
            pass
    assert rec.acquisitions == 1
    assert rec.violations == []
    assert not isinstance(threading.Lock(), lockdep._Instrumented)


def test_watch_leaves_non_repo_locks_raw():
    import concurrent.futures

    with lockdep.watch():
        fut = concurrent.futures.Future()
        assert not isinstance(fut._condition, lockdep._Instrumented)


def test_declared_hierarchy_inversion_raises_and_is_recorded():
    a = lockdep.named_lock("GPServer._budget_lock")
    b = lockdep.named_lock("GPServer._registry_lock")
    with lockdep.watch() as rec:
        with a:
            with b:
                pass
        with pytest.raises(lockdep.LockOrderViolation, match="declared"):
            with b:
                with a:
                    pass
    assert len(rec.violations) == 1
    assert rec.violations[0].lock == "GPServer._budget_lock"
    with pytest.raises(AssertionError, match="lock-order violation"):
        rec.assert_clean()


def test_a_kernel_build_under_an_entry_lock_is_in_order():
    """A refit under `_Entry.lock` reaches a kernel build and the pinned
    precision: declared order. The reverse raises before it can hang."""
    entry = lockdep.named_lock("_Entry.lock")
    build = lockdep.named_lock("repro_torch.kernels._build._lock")
    precision = lockdep.named_lock("repro_torch.core.psi_stats._precision_lock")
    with lockdep.watch() as rec:
        with entry:
            with build:
                pass
            with precision:
                pass
        with pytest.raises(lockdep.LockOrderViolation, match="declared"):
            with precision:
                with build:
                    pass
    assert ("_Entry.lock", "repro_torch.kernels._build._lock") in rec.edges


def test_observed_order_abba_raises_for_unranked_locks():
    a = lockdep.named_lock("test.A")
    b = lockdep.named_lock("test.B")
    with lockdep.watch() as rec:
        with a:
            with b:
                pass
        with pytest.raises(lockdep.LockOrderViolation, match="opposite"):
            with b:
                with a:
                    pass
    assert ("test.A", "test.B") in rec.edges


def test_self_deadlock_raises_instead_of_hanging():
    lk = lockdep.named_lock("test.self")
    with lockdep.watch():
        with lk:
            with pytest.raises(lockdep.LockOrderViolation, match="self-deadlock"):
                lk.acquire()
    rl = lockdep.named_lock("test.rself", kind="rlock")
    with lockdep.watch() as rec:
        with rl:
            with rl:
                pass
    assert rec.violations == []


def test_condition_wait_releases_the_held_stack():
    cv = lockdep.named_lock("test.cv", kind="condition")
    other = lockdep.named_lock("test.other")
    done = []

    def waker():
        with cv:
            cv.notify_all()
            done.append(True)

    with lockdep.watch() as rec:
        with cv:
            t = threading.Thread(target=waker)
            t.start()
            cv.wait(timeout=5.0)
        t.join(5.0)
        assert not t.is_alive()
        with other:
            pass
    assert done == [True]
    assert rec.violations == []


def test_watch_is_transparent_when_inactive_and_rejects_nesting():
    lk = lockdep.named_lock("test.plain")
    with lk:
        assert lk.locked()
    assert not lk.locked()
    with lockdep.watch():
        with pytest.raises(RuntimeError, match="already active"):
            with lockdep.watch():
                pass


def test_serving_locks_run_clean_under_lockdep_end_to_end():
    """Build a real port GPServer under watch(), exercise register /
    predict / update / close, and require zero violations."""
    from repro_torch.gp import SparseGPRegression
    from repro_torch.serve import GPServer

    X = torch.linspace(-2.0, 2.0, 64, dtype=torch.float64)[:, None]
    Y = torch.sin(X)
    gp = SparseGPRegression(M=8, device="cpu").fit(X, Y, steps=3)
    with lockdep.watch() as rec:
        server = GPServer(device="cpu")
        server.register("m", gp)
        mean, _ = server.predict("m", X[:8])
        assert mean.shape == (8, 1)
        server.update("m", X[:4], Y[:4])
        server.close()
    assert rec.violations == [], [str(v) for v in rec.violations]
    assert rec.acquisitions > 0
    rank = {n: i for i, n in enumerate(concurrency.LOCK_HIERARCHY)}
    assert ("_Entry.lock", "GPServer._registry_lock") in rec.edges
    assert all(rank[a] < rank[b] for a, b in rec.edges), rec.edges


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_concurrency_clean_on_src(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--concurrency"]) == 0
    out = capsys.readouterr().out
    assert "ANL005-ANL007" in out and "0 finding(s)" in out and "9 lock(s)" in out


@pytest.mark.parametrize("name,rule", [("lock_cycle", "ANL005"),
                                       ("unguarded_write", "ANL006"),
                                       ("blocking_under_lock", "ANL007")])
def test_cli_concurrency_fails_on_each_seeded_fixture(capsys, name, rule):
    from repro_torch.analysis.__main__ import main

    assert main(["--concurrency", str(FIXTURES / f"{name}.py")]) == 1
    out = capsys.readouterr().out
    assert rule in out and f"{name}.py" in out


def test_cli_json_format_is_machine_readable(capsys):
    import json

    from repro_torch.analysis.__main__ import main

    rc = main(["--concurrency", "--format", "json", str(FIXTURES / "lock_cycle.py")])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is False and doc["failures"] == 1
    conc = doc["passes"]["concurrency"]
    assert conc["hierarchy"] == list(concurrency.LOCK_HIERARCHY)
    assert any(f["code"] == "ANL005" for f in conc["findings"])
    rc = main(["--lint", "--format", "json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["passes"]["lint"]["findings"] == []
