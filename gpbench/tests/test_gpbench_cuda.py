"""On the card (skipped elsewhere): a short run of each cell through the
kernels, correct, with the trace's attribution of the statistics ops'
kernels agreeing with their times alone: the GP-LVM cells at a small
size, the regression at its own (at 262,144 points K_fu's kernel runs in
0.08 ms, under the host's time to launch it, so timed alone back to back
it reads the launches: 0.13 ms).

    python -m pytest -q -m cuda gpbench/tests/test_gpbench_cuda.py
"""
import time

import pytest
import torch

from gpbench import harness

SMALL = {"N": 262_144}
SIZE = {"gplvm-2p24.fit": SMALL, "gplvm-paper.fit": SMALL, "gplvm-2p24.build": SMALL,
        "sgpr-paper.fit": {}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZE))
def test_traced_run_on_the_card(card, name, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE", "0")
    lines = []
    r = harness.run(harness.load_cell(name), 21, 1.0, True, card, time.perf_counter(),
                    shape_override=SIZE[name], log=lines.append)
    assert r["correct"], (r["checks"], lines)
    assert r["device"]["busy_s"] > 0
    checks = [x for x in lines if x.startswith("trace check:")]
    assert checks and all("agree" in x and "DISAGREE" not in x for x in checks), lines
    assert {m["name"] for m in harness.load_cell(name).per_layer} == set(r["metrics"])
