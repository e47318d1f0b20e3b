"""BENCHMARK.json against the files it names, and the rules the harness
relies on: every cell finds its configuration, traffic mix, limits and
readers by name, and every configuration names a model that has a module
under `gpbench/models/`."""
import json
import re
from pathlib import Path

import pytest

from gpbench import harness
from gpbench.work import ITEMSIZE

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TRAIN_NUMBERS = {"loss_gap", "grad_gap", "change_gap", "grad_diff", "change_diff"}
BUILD_NUMBERS = {"stats_rel", "n_gap", "state_rel"}
RANK_NUMBERS = {"rank_gap", "step_gap"}  # a cell on several cards
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for c in BENCH["configs"]:
        assert c["file"].startswith("gpbench/") and (ROOT / c["file"]).is_file()
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"]
        assert (ROOT / "gpbench" / "models" / f"{config['model']}.py").is_file()
        assert harness.model_of(config["model"]).__name__ == f"gpbench.models.{config['model']}"


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = harness.load_cell(name)
    assert cell.config["dtype"] in ITEMSIZE
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        harness.load_reader(m)
    numbers = TRAIN_NUMBERS if cell.traffic["kind"] == "train" else BUILD_NUMBERS
    if cell.chips > 1:
        numbers = numbers | RANK_NUMBERS
        assert RANK_NUMBERS <= set(cell.limits)
    assert cell.limits and set(cell.limits) <= numbers
    assert cell.traffic["kind"] in cell.model.STATS_OPS
    assert cell.model.__name__ == f"gpbench.models.{cell.config['model']}"


def test_every_reader_has_an_entry():
    files = {p for p in (ROOT / "gpbench" / "metrics").glob("*.py")}
    assert files == {harness.reader_path(m["name"]) for m in BENCH["per_layer"]}


def test_readers_declare_nothing_of_their_own():
    """Unit, layer and what a metric moves are BENCHMARK.json's alone."""
    for m in BENCH["per_layer"]:
        mod = harness.load_reader(m)
        assert callable(mod.read)
        assert not {"UNIT", "LAYER", "MOVES"} & set(vars(mod)), m["name"]


def test_program_rejects_another_model(tmp_path):
    """A configuration whose model has no module fails as its cell loads,
    naming the model; a model's program refuses a kernel it does not drive."""
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "configs").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "models").mkdir()
    config = dict(harness.load_cell(CELLS[0]).config, model="NoSuchGP")
    (tmp_path / "configs" / "nosuch.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "fit.json").write_text(json.dumps({"kind": "train"}))
    (tmp_path / "limits" / "nosuch.fit.json").write_text("{}")
    bench["workloads"].append({"name": "nosuch.fit", "config": "nosuch", "traffic": "fit",
                               "chips": 1, "why": "a model with no module"})
    with pytest.raises(KeyError, match="NoSuchGP"):
        harness.load_cell("nosuch.fit", bench, tmp_path)
    for model in ("BayesianGPLVM", "SparseGPRegression"):
        config = dict(harness.load_cell(CELLS[0]).config, kernel="matern32")
        with pytest.raises(ValueError, match="RBF only"):
            harness.model_of(model).Program(config, lr=1e-2, device="cpu")
