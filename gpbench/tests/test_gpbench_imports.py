"""Nothing under gpbench/ imports JAX, the JAX package (`repro`) or its
benchmarks, and the reference imports nothing of the program either.
Module names are compared by their top-level name, whole: `repro_torch`
begins with `repro` and is not it."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_forbidden_import(path):
    names = set(_top_level_imports(path))
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names and "gpbench" not in names, (path, names)


def test_whole_name_comparison(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import repro_torch.core\nfrom repro_torch import gp\nimport reprox\n")
    names = set(_top_level_imports(path))
    assert names == {"repro_torch", "reprox"} and not names & FORBIDDEN


def test_a_run_loads_nothing_forbidden():
    """A whole run on the CPU at a small size, its readers and its check
    included, in a fresh process: which top-level modules are loaded."""
    code = f"""
import sys, time, json
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from gpbench import harness
from gpbench.reference import gplvm as R
from gpbench.reference import sgpr as RS
R.BLOCK_ELEMENTS = 1 << 14
RS.BLOCK_ELEMENTS = 1 << 12
for name in ("gplvm-paper.fit", "gplvm-2p24.build", "sgpr-paper.fit"):
    cell = harness.load_cell(name)
    harness.run(cell, 5, 0.05, True, "cpu", time.perf_counter(),
                shape_override={{"N": 500, "M": 8}}, log=lambda m: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
