"""The benchmark's reader of the program's spans (`gpbench/spans.py`),
collected with the repo's tests; its cases are those of
`gpbench/tests/test_gpbench_spans.py`."""
from gpbench.tests.test_gpbench_spans import *  # noqa: F401,F403
