"""The benchmark of `repro_torch`, the PyTorch and CUDA port: one run of one
cell on the CUDA cards of the machine it starts on. A cell whose `chips`
is 1 runs in this process on card 0; one on several cards runs as that many
processes, one rank a card (`gpbench/ranks.py`), and this process prints
the first rank's result once every rank has ended well.

    python3 gpbench/run.py --workload gplvm-2p24.fit --seed 7 --seconds 20 --trace 0

It prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` a `breakdown`, and last `checks`, each number the check
compared beside its limit; the same numbers close standard error. It exits
with another code than 0, and prints no result, without as many CUDA
devices as the cell asks for, if the program cannot be imported, if a rank
fails or hangs, or if JAX or the JAX package was loaded.
Run it from the root of a checkout; it builds and caches only inside it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches a library could write, kept inside the checkout at fixed paths
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/gpbench/triton",
              "TORCH_EXTENSIONS_DIR": "build/gpbench/torch_extensions"}


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _clean(x):
    """JSON-safe: a number that is not finite becomes null."""
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpbench import harness, ranks

    cell = harness.load_cell(args.workload)
    os.environ.update({k: str(ROOT / v) for k, v in CACHE_DIRS.items()})
    os.environ.update(harness.program_env(cell))

    import torch

    want = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        _err(f"gpbench: needs {want} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        _err(f"gpbench: the program cannot be imported: {e}")
        return 2
    if want == 1:
        torch.set_num_threads(4)
        torch.cuda.set_device(0)
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                             log=_err)
    else:
        # ended from outside, the launcher still ends its ranks
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        runs = ranks.launch(cell, [(args.seed, "program")], args.seconds, bool(args.trace),
                            T_START)
        if runs is None:
            return 4
        result = runs[0]["result"]
    found = ranks.forbidden_modules()
    if found:
        _err(f"gpbench: JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        _err(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    _err(f"correct: {result['correct']}; failed {result['failed']} of {result['attempted']}")
    print(json.dumps(_clean(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
