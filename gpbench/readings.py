"""Readings that set a cell's limits, on the card at the cell's own size;
the benchmark's own runs never run this.

    python3 gpbench/readings.py --workload gplvm-2p24.fit --mode program --seeds 1,2,3

Modes: "program" (the program's numbers against the reference, after a
short window), "control" (the reference itself in the program's place,
computed one precision below the configuration's: float32 for float64,
TF32 for float32, against the float64 reference), for float32
configurations "control-refold" and "control-stats" (the refold in TF32,
the statistics in bfloat16: `gpbench.faults.CONTROLS`), and the planted
faults of `gpbench.faults`: "half", "alter", "unchanged". Prints one JSON
line a seed with every number the check computes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("program", "control", "control-refold", "control-stats", "half", "alter", "unchanged")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpbench/readings.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, choices=MODES)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpbench import faults, harness

    cell = harness.load_cell(args.workload)
    os.environ.update(harness.program_env(cell))
    import torch

    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = {}
        context = faults.FAULTS[args.mode]() if args.mode in faults.FAULTS else contextlib.nullcontext()
        plant = dict(faults.CONTROLS, unchanged=faults.unchanged).get(args.mode)
        with context:
            r = harness.run(cell, seed, args.seconds, False, dev, t0, plant=plant,
                            numbers_out=numbers, log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "numbers": numbers, "correct": r["correct"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
