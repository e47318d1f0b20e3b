"""The launcher of a cell on several cards (`gpbench/ranks.py`), on the
CPU: four gloo ranks run `gplvm-2p24.fit-4dp` through the same harness
path as on the cards, at a size a test run holds. The program is correct
with every rank at the same step count and the same globals; the control
and each fault the cell can have fail the check, the exchange between
ranks among them; and a rank that fails or hangs ends the run with no
result and no process left behind."""
import multiprocessing
import time

import pytest

from gpbench import harness, ranks

CELL = "gplvm-2p24.fit-4dp"
SMALL = {"N": 8192, "M": 32}
SEED = 2**31 + 11
FAULTS = ("control", "control-refold", "control-stats", "half", "alter", "unchanged",
          "left-out", "twice")


def _launch(tmp_path, runs, target=None, numbers=False):
    return ranks.launch(harness.load_cell(CELL), runs, 0.05, False, None, backend="gloo",
                        device="cpu", threads=1, workdir=tmp_path, shape_override=SMALL,
                        numbers=numbers, target=target, log=lambda m: None)


def _raises_on_rank_one(rank, world, spec):
    if rank == 1:
        raise RuntimeError("a rank that fails")
    ranks._rank(rank, world, spec)


def _hangs_on_rank_one(rank, world, spec):
    if rank == 1:
        time.sleep(3600)
    ranks._rank(rank, world, spec)


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """The program and every control and fault, in one launch."""
    runs = [(SEED, "program")] + [(SEED, mode) for mode in FAULTS]
    out = _launch(tmp_path_factory.mktemp("ranks"), runs, numbers=True)
    assert out is not None
    return {r["mode"]: r for r in out}


def test_program_is_correct_on_every_rank(readings):
    r = readings["program"]["result"]
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == 4
    checks = r["checks"]
    assert checks["step_gap"]["value"] == 0 and checks["rank_gap"]["value"] == 0
    cell = harness.load_cell(CELL)
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert checks[name]["value"] <= cell.limits[name], name


@pytest.mark.parametrize("mode", FAULTS)
def test_control_and_faults_are_not_correct(readings, mode):
    assert not readings[mode]["result"]["correct"], readings[mode]["numbers"]


def test_rank_faults_fail_their_numbers(readings):
    """One rank's statistics left out moves the first loss; cotangents
    summed twice move the first gradient."""
    limits = harness.load_cell(CELL).limits
    left, twice = readings["left-out"]["numbers"], readings["twice"]["numbers"]
    assert left["loss_gap"] > limits["loss_gap"]
    assert twice["grad_gap"] > limits["grad_gap"]


def test_one_result_from_the_first_rank(tmp_path, capfd):
    out = _launch(tmp_path, [(SEED, "program")])
    assert [r["mode"] for r in out] == ["program"]
    assert capfd.readouterr().out == ""
    assert sorted(p.name for p in tmp_path.iterdir()) == ["results.json"]


@pytest.mark.parametrize("target,join_s", [(_raises_on_rank_one, ranks.JOIN_S),
                                           (_hangs_on_rank_one, 20.0)])
def test_a_failed_rank_ends_the_run(tmp_path, monkeypatch, target, join_s):
    monkeypatch.setattr(ranks, "JOIN_S", join_s)
    t0 = time.monotonic()
    assert _launch(tmp_path, [(SEED, "program")], target=target) is None
    assert time.monotonic() - t0 < join_s + 30
    assert multiprocessing.active_children() == []
