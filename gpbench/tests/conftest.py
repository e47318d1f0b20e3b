"""The benchmark's tests run from the root of a checkout with
`python -m pytest -q gpbench/tests`; the program lives under `src/`."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
