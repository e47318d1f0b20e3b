"""The check catches what it is for, at a size a test run holds: whole runs
of each cell on the CPU (the program's plain versions under the same
ops), with the cell's own limits. The program passes; the reference put in
its place one precision below the configuration's fails (the control);
and so does each fault the cell can have, planted under the timed path:
half of the points left out with the mean over the rest, one answer
altered where it is produced, and a training step that returns its state
unchanged. (One card, so no exchange between chips to leave out.) The
faults of half and altered answers are each model's own (`FAULTS` of
`gpbench/models/<model>.py`)."""
import time

import pytest

from gpbench import faults, harness
from gpbench.reference import gplvm as R
from gpbench.reference import sgpr as RS

SMALL = {"N": 8192, "M": 32}
SEEDS = (11, 2**31 + 7)
FITS = ["gplvm-2p24.fit", "gplvm-paper.fit", "sgpr-paper.fit"]


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(R, "BLOCK_ELEMENTS", 1 << 16)
    monkeypatch.setattr(RS, "BLOCK_ELEMENTS", 1 << 13)


def _run(name, seed, plant=None):
    cell = harness.load_cell(name)
    return harness.run(cell, seed, 0.05, False, "cpu", time.perf_counter(),
                       shape_override=SMALL, plant=plant, log=lambda m: None)


CASES = [(w, s) for w in FITS + ["gplvm-2p24.build"] for s in SEEDS]


@pytest.mark.parametrize("name,seed", CASES)
def test_program_is_correct(name, seed):
    r = _run(name, seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("name,seed", CASES)
def test_control_is_not_correct(name, seed):
    assert not _run(name, seed, plant=faults.control)["correct"]


@pytest.mark.parametrize("fault", ["half", "alter"])
@pytest.mark.parametrize("name", FITS + ["gplvm-2p24.build"])
def test_planted_fault_is_not_correct(name, fault):
    with harness.load_cell(name).model.FAULTS[fault]():
        assert not _run(name, SEEDS[0])["correct"]


@pytest.mark.parametrize("name", FITS)
def test_unchanged_state_is_not_correct(name):
    r = _run(name, SEEDS[0], plant=faults.unchanged)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == 1.0


@pytest.mark.parametrize("mode", ["control-refold", "control-stats"])
@pytest.mark.parametrize("name", ["gplvm-2p24.fit", "gplvm-2p24.build"])
def test_lower_controls_are_not_correct(name, mode):
    """The refold in TF32, or the statistics in bfloat16, in the program's
    place: each fails the float32 cells' check."""
    assert not _run(name, SEEDS[0], plant=faults.CONTROLS[mode])["correct"]


def test_build_holds_the_served_factors():
    """A refold that weights psi2 in K_uu + beta psi2 wrongly fails the build
    cell on its factors alone: the statistics are the program's own."""
    def plant(prog, model):
        build = prog._build_state

        def lossy(kernel, params, stats):
            state = build(kernel, params, stats._replace(psi2=0.9 * stats.psi2))
            return state._replace(stats=stats)
        prog._build_state = lossy
        return prog

    r = _run("gplvm-2p24.build", SEEDS[0], plant=plant)
    assert not r["correct"]
    assert r["checks"]["stats_rel"]["value"] <= r["checks"]["stats_rel"]["limit"]
    assert r["checks"]["state_rel"]["value"] > r["checks"]["state_rel"]["limit"]
