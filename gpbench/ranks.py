"""A cell on several cards: one process a card, each a rank of one process
group, through the harness's data-parallel path.

`launch` spawns the cell's ranks (a fresh interpreter each). Rank r takes
device r, joins the group (NCCL on the cards, gloo on the CPU) through a
file store in the launcher's work directory, and runs `harness.run` for
each run asked of it; the first rank writes every result to that
directory. The launcher waits for all of them: a rank that exits with
another code than 0 ends the others at once, as does a launch that
outlasts JOIN_S (a rank that hangs), and then there is no result. Every
process it started has ended when it returns.
"""
from __future__ import annotations

import datetime
import json
import multiprocessing
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
WORKDIR = ROOT / "build" / "gpbench" / "ranks"
# a checkout's first run builds the kernels, and the driver allows it 1200 s
JOIN_S = 1140.0
# a collective that waits longer than this ends its rank
GROUP_TIMEOUT_S = 600
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX package's,
    compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _rank(rank: int, world: int, spec: dict) -> None:
    """One rank: join the group, run each (seed, mode) of `spec["runs"]`,
    and on the first rank write their results."""
    import torch
    import torch.distributed as dist

    from gpbench import faults, harness

    cuda = spec["device"] == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device(spec["device"])
    if cuda:
        torch.cuda.set_device(dev)
    torch.set_num_threads(spec["threads"])
    dist.init_process_group(spec["backend"], init_method=f"file://{spec['store']}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                            **({"device_id": dev} if cuda else {}))
    try:
        cell = harness.load_cell(spec["cell"])
        log = _err if rank == 0 else (lambda msg: None)
        out = []
        ref_cache = {} if spec["numbers"] else None  # readings share a seed's reference
        for seed, mode in spec["runs"]:
            t0 = spec["t_start"] if spec["t_start"] is not None else time.perf_counter()
            numbers = {} if spec["numbers"] else None
            context, plant = faults.planted(mode, cell.model)
            with context:
                result = harness.run(cell, seed, spec["seconds"], spec["traced"], dev, t0,
                                     log=log, shape_override=spec["shape"], plant=plant,
                                     numbers_out=numbers, ref_cache=ref_cache)
            out.append({"seed": seed, "mode": mode, "result": result, "numbers": numbers,
                        "seconds": time.perf_counter() - t0})
    finally:
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        _err(f"gpbench: rank {rank}: JAX or the JAX package was loaded: {', '.join(found)}")
        sys.exit(3)
    if rank == 0:
        Path(spec["results"]).write_text(json.dumps(out))


def launch(cell, runs: List[Tuple[int, str]], seconds: float, traced: bool,
           t_start: Optional[float], *, backend: str = "nccl", device: str = "cuda",
           threads: int = 4, workdir: Path = WORKDIR, shape_override: Optional[dict] = None,
           numbers: bool = False, target: Optional[Callable] = None,
           log: Callable[[str], None] = _err) -> Optional[list]:
    """Each run's {"seed", "mode", "result", "numbers", "seconds"} from the
    first rank, in order; None where a rank failed or the ranks outlasted
    JOIN_S. `runs`: (seed, mode) pairs, a mode as `faults.planted` takes
    it; `t_start`: the clock reading a run's set-up counts from, None for
    each run's own start; `target`: the rank's function, `_rank`."""
    workdir.mkdir(parents=True, exist_ok=True)
    store, results = workdir / "store", workdir / "results.json"
    for f in (store, results):
        f.unlink(missing_ok=True)
    spec = {"cell": cell.name, "runs": list(runs), "seconds": seconds, "traced": traced,
            "t_start": t_start, "backend": backend, "device": device, "threads": threads,
            "store": str(store), "results": str(results), "shape": shape_override,
            "numbers": numbers}
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or _rank, args=(r, cell.chips, spec), daemon=True)
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                log(f"gpbench: rank {failed[0][0]} exited with {failed[0][1]}: the run ends")
                return None
            if None not in codes:
                break
            if time.monotonic() > deadline:
                log(f"gpbench: ranks {[r for r, c in enumerate(codes) if c is None]} "
                    f"still running after {JOIN_S:.0f} s: the run ends")
                return None
            procs[codes.index(None)].join(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        store.unlink(missing_ok=True)
    return json.loads(results.read_text())
