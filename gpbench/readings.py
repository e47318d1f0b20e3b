"""Readings that set a cell's limits, on the card at the cell's own size;
the benchmark's own runs never run this.

    python3 gpbench/readings.py --workload gplvm-2p24.fit --mode program --seeds 1,2,3
    python3 gpbench/readings.py --workload gplvm-2p24.fit-4dp --mode program,control \
        --seeds 1,2,3,4 --others 2

Modes: "program" (the program's numbers against the reference, after a
short window), "control" (the reference itself in the program's place,
computed one precision below the configuration's: float32 for float64,
TF32 for float32, against the float64 reference), for float32
configurations "control-refold" and "control-stats" (the refold in TF32,
the statistics in bfloat16: `gpbench.faults.CONTROLS`), and the planted
faults: the model's "half" and "alter" (`FAULTS` of
`gpbench/models/<model>.py`), "unchanged", and on several cards
"left-out" and "twice" (`gpbench.faults`). `--mode` takes a comma-separated list; the
modes other than "program" run on the first `--others` seeds only. All
runs share one process (on several cards, one process a rank, through
`gpbench/ranks.py`), and the runs of one seed one reference. Prints one
JSON line a run with every number the check computes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("program", "control", "control-refold", "control-stats", "half", "alter", "unchanged",
         "left-out", "twice")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpbench/readings.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, help=f"comma-separated, of {', '.join(MODES)}")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--others", type=int, default=None,
                    help="run the modes other than 'program' on this many first seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    modes = args.mode.split(",")
    if not set(modes) <= set(MODES):
        ap.error(f"--mode: {sorted(set(modes) - set(MODES))} not of {MODES}")
    seeds = [int(s) for s in args.seeds.split(",")]
    others = seeds[:args.others] if args.others is not None else seeds
    runs = [(seed, mode) for seed in seeds for mode in modes
            if mode == "program" or seed in others]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpbench import faults, harness, ranks

    cell = harness.load_cell(args.workload)
    os.environ.update(harness.program_env(cell))

    def show(seed, mode, numbers, result, seconds):
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                          "numbers": numbers, "correct": result["correct"],
                          "seconds": seconds}), flush=True)

    if cell.chips > 1:
        out = ranks.launch(cell, runs, args.seconds, False, None, numbers=True,
                           device=args.device,
                           backend="nccl" if args.device == "cuda" else "gloo")
        if out is None:
            return 4
        for r in out:
            show(r["seed"], r["mode"], r["numbers"], r["result"], r["seconds"])
        return 0
    import torch

    dev = torch.device(args.device)
    ref_cache = {}
    for seed, mode in runs:
        t0 = time.perf_counter()
        numbers = {}
        context, plant = faults.planted(mode, cell.model)
        with context:
            r = harness.run(cell, seed, args.seconds, False, dev, t0, plant=plant,
                            numbers_out=numbers, ref_cache=ref_cache,
                            log=lambda m: print(m, file=sys.stderr))
        show(seed, mode, numbers, r, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
