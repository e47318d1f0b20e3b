"""One run of one cell: set-up, the measured window, the traced reading and
the check against the reference.

A cell is an entry of `BENCHMARK.json`'s `workloads`. Everything that
belongs to it is found by name: its configuration (`configs/<config>.json`:
the model, shapes, dtype, backend, the program's environment), the model's
module (`models/<model>.py`: the draw, the calls into the program, the
reference, the ops the readers time, the least work and the planted
faults; `gpbench/models/__init__.py` lists them), its traffic mix
(`traffic/<traffic>.json`: which loop drives the window and its
parameters), the limits of its check (`limits/<cell>.json`) and one reader
per per-layer quantity (`metrics/<the metric's name before its first
dot>.py`: `stats_fwd_roofline.build` is read by
`metrics/stats_fwd_roofline.py`). This module is the one general driver of
every mix:

  * "train": a closed loop of full-batch Adam steps. Set-up draws the
    problem from the seed and takes the first `check_steps` steps through
    the very step the window then repeats; those steps are what the check
    compares with the reference.
  * "build": a closed loop of rebuilds of the served state from all
    points; the check compares a build drawn from the seed and the last.

The window issues work until `seconds` have passed on the host clock, then
waits for the device; its length runs to the end of that wait, and a rate
is the window over the work it completed. A traced run measures such a
window untraced first, and then a second one, of at most TRACE_SECONDS,
under the profiler: the per-layer metrics take the time of a step or build
from the first, which the profiler's host work does not slow, and only
device times from the trace.

A cell whose `chips` is more than 1 runs in that many ranks, one a card
(`gpbench/ranks.py` starts them), through the program's `mesh=` path:
every rank draws the whole problem and keeps its rows, and the window runs
a fixed count of steps, set from the set-up steps' pace and agreed over
the ranks before it, so that every rank issues as many all-reduces. Its
length is the first rank's host clock. The first rank alone is traced and
its readers see its own shard's shapes; the check gathers the checked
state from every rank in row order and adds `rank_gap` (the largest
difference of a global leaf between ranks) and `step_gap` (of the ranks'
step counts), each with the limit 0.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from gpbench import check, problem, trace, work

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# the traced per-op time agrees with the kernels timed alone within this
AGREE = 0.15
TIMED_LAUNCHES = 5
# the traced window's length at most: its per-call device times are steady
# well within it, and reading a longer trace only lengthens the run
TRACE_SECONDS = 10.0
# an end-to-end metric is read by the part of its name before the first
# dot: the set-up seconds, the window's memory peak, or the window over the
# items it completed, by traffic kind ("train_step_ms.paper" is a step time)
PER_ITEM = {"train": "train_step_ms", "build": "state_build_ms"}


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    model: ModuleType  # the configuration's model (`models/<model>.py`)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str, e2e: List[str]) -> bool:
    """A per-layer metric with `workloads` is read in those cells; one
    without, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e


def model_of(name: str, here: Path = HERE) -> ModuleType:
    """The module of the model a configuration names, `models/<name>.py`."""
    if not (here / "models" / f"{name}.py").is_file():
        have = sorted(p.stem for p in (here / "models").glob("*.py") if p.stem != "__init__")
        raise KeyError(f"model {name!r}: no gpbench/models/{name}.py; have {have}")
    return importlib.import_module(f"gpbench.models.{name}")


def load_cell(name: str, bench: Optional[dict] = None, here: Path = HERE) -> Cell:
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    config = _json(here / "configs" / f"{w['config']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["chips"], config, _json(here / "traffic" / f"{w['traffic']}.json"),
                _json(here / "limits" / f"{name}.json"), e2e, per_layer,
                model_of(config["model"], here))


def program_env(cell: Cell, root: Path = ROOT) -> Dict[str, str]:
    """The configuration's environment for the program; a value of a key
    ending in `_DIR` or `_CACHE` is a path inside the checkout."""
    return {k: str(root / v) if k.endswith(("_DIR", "_CACHE")) else v
            for k, v in cell.config.get("env", {}).items()}


def reader_path(name: str, here: Path = HERE) -> Path:
    """The reader of the part of the metric's name before its first dot."""
    return here / "metrics" / f"{name.split('.')[0]}.py"


def load_reader(metric: dict, here: Path = HERE):
    """The metric's reader module, whose `read(reading)` gives its value or
    None; its unit, layer and what it moves are BENCHMARK.json's."""
    path = reader_path(metric["name"], here)
    spec = importlib.util.spec_from_file_location(f"gpbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Reading(NamedTuple):
    """What a per-layer reader reads: the traced window, the work it
    completed, the time of a step or build in the untraced window before
    it, the cell's shapes, which ops' attributed times agreed with their
    kernels timed alone, and the cell's model (its ops and least work)."""
    traced: trace.Traced
    done: int  # steps or builds in the traced window
    item_s: float  # seconds a step or build, untraced
    shape: dict
    validated: Dict[str, bool]
    model: ModuleType

    def op_seconds(self, op: str) -> Optional[float]:
        """Device seconds a call of `op`, where the trace saw and could
        attribute it; None otherwise."""
        n = self.traced.op_calls.get(op, 0)
        if n == 0 or not self.validated.get(op) or self.traced.op_device_s[op] <= 0:
            return None
        return self.traced.op_device_s[op] / n

    def per_item_s(self) -> float:
        """Seconds a step or build, from the untraced window."""
        return self.item_s

    def busy_per_item_s(self) -> float:
        """Device-busy seconds a step or build, from the trace."""
        return self.traced.busy_s / self.done

    def shapes(self):
        s = self.shape
        return s["N"], s["M"], s["Q"], s["D"], s["dtype"]

    def step_mfu(self, kind: str) -> Optional[float]:
        """The least work of the model's step or build of traffic `kind` at
        the card's peaks over the untraced step or build, in %; None where
        the model has no such item."""
        fn = self.model.STEP_WORK.get(kind)
        if fn is None:
            return None
        return 100 * work.bound_s(fn(*self.shapes()), self.shape["dtype"]) / self.per_item_s()

    def roofline(self, kernel: str) -> Optional[float]:
        """The model's kernel `kernel` (`ROOFLINES`): its least work at the
        card's peaks over the device time of a call of its op, in %; None
        where the model has no such kernel or the op's time is not read."""
        op, fn = self.model.ROOFLINES.get(kernel, (None, None))
        t = None if op is None else self.op_seconds(op)
        if t is None:
            return None
        return 100 * work.bound_s(fn(*self.shapes()), self.shape["dtype"]) / t


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(issue: Callable[[], torch.Tensor], seconds: float, dev,
            steps: Optional[int] = None) -> tuple:
    """(items issued, items whose output held a value that is not finite,
    seconds): issue work until `seconds` have passed, or, where `steps` is
    given, that many items, then wait for the device. The outputs are
    tallied on the device, so neither the host's pace nor the memory peak
    depends on how many items the window holds."""
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0
    t0 = time.perf_counter()
    with record_function(trace.WINDOW_SPAN):
        while True:
            bad += (~torch.isfinite(issue())).any()
            done += 1
            if done == steps or (steps is None and time.perf_counter() - t0 >= seconds):
                break
        _sync(dev)
    return done, int(bad), time.perf_counter() - t0


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _time_alone(fn, args) -> float:
    """Seconds a call of `fn(*args)`, over TIMED_LAUNCHES back to back
    between CUDA events, after one untimed."""
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_LAUNCHES):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / TIMED_LAUNCHES


def _validate(traced: trace.Traced, model, params, data, ops: tuple, dev,
              log) -> Dict[str, bool]:
    """Each op's traced device time a call against its kernels timed alone
    at the same inputs (`model.timed_alone`); agreement within AGREE
    validates the op."""
    calls = None
    if dev.type == "cuda":
        with torch.no_grad():
            calls = model.timed_alone(params, data, dev)
    out = {}
    if calls is None:
        log("trace check: the kernels cannot be timed alone here; attributed times not used")
        return {op: False for op in ops}
    with torch.no_grad():
        alone = {op: _time_alone(*calls[op][:2]) / calls[op][2] for op in ops}
    for op in ops:
        n = traced.op_calls.get(op, 0)
        seen = traced.op_device_s[op] / n if n else 0.0
        ok = seen > 0 and abs(seen - alone[op]) <= AGREE * alone[op]
        out[op] = ok
        log(f"trace check: {op} {n} calls, traced {seen * 1e3:.4f} ms a call, "
            f"alone {alone[op] * 1e3:.4f} ms a call: {'agree' if ok else 'DISAGREE'}"
            f" (events named {traced.op_names.get(op)})")
    return out


def _ranks(cell: Cell) -> Optional[tuple]:
    """(this rank, ranks) for a cell on several cards, whose process group
    the launcher (`gpbench/ranks.py`) has joined; None for one card."""
    if cell.chips == 1:
        return None
    if not dist.is_initialized() or dist.get_world_size() != cell.chips:
        raise RuntimeError(f"{cell.name} runs as {cell.chips} ranks, one a card: "
                           "start it through gpbench/run.py")
    return dist.get_rank(), cell.chips


def _most(values: List[int], dev) -> List[int]:
    """Each number's largest over the ranks, in one collective."""
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _gather_rows(t: torch.Tensor, N: int, dev) -> Optional[torch.Tensor]:
    """On the first rank, every rank's rows of a local leaf in row order
    (rank r holds rows [N r / W, N (r + 1) / W)), on the host; None on the
    others. One all-gather of the rows, each rank's padded to the most a
    rank holds."""
    rank, world = dist.get_rank(), dist.get_world_size()
    bounds = [N * r // world for r in range(world + 1)]
    most = max(b - a for a, b in zip(bounds, bounds[1:]))
    x = t.to(dev)
    pad = x.new_zeros((most, *x.shape[1:]))
    pad[:x.shape[0]] = x
    out = x.new_empty((world * most, *x.shape[1:]))
    dist.all_gather_into_tensor(out, pad)
    if rank:
        return None
    return torch.cat([out[r * most:r * most + b - a]
                      for r, (a, b) in enumerate(zip(bounds, bounds[1:]))]).cpu()


def _gather(tree, keys, N: int, dev):
    """`tree` with each leaf under `keys` gathered on the first rank."""
    return {k: _gather_rows(v, N, dev) if k in keys else v for k, v in tree.items()}


def _rank_gap(trees, keys, dev) -> float:
    """The largest difference of any global leaf (the leaves not under
    `keys`) of any of `trees` between a rank and the first; every rank
    holds the same bits where the scheme is sound."""
    flat = torch.cat([v.reshape(-1) for tree in trees for path, v in check.leaves(
        {k: x for k, x in tree.items() if k not in keys}).items()]).to(dev)
    seen = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(seen, flat)
    gap = max(float((x - seen[0]).abs().max()) for x in seen)
    return gap if gap == gap else math.inf


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        log: Callable[[str], None] = print, shape_override: Optional[dict] = None,
        plant: Optional[Callable] = None, numbers_out: Optional[dict] = None,
        ref_cache: Optional[dict] = None) -> Optional[dict]:
    """The result of one run (the benchmark's last line as a dict), with
    `checks` holding each compared number beside its limit.

    A cell on several cards runs in each of its ranks (`gpbench/ranks.py`
    starts them, one a card): every rank draws the whole problem and keeps
    its rows, the window runs a step count agreed before it, and the first
    rank reads the trace, gathers the checked state and runs the check;
    the other ranks return None.

    `shape_override` replaces the configuration's shapes, `plant` wraps
    the program (a planted fault or a control), `numbers_out` receives
    every number the check computed, compared or not, and `ref_cache`
    keeps the reference's result for the next run of the same seed; the
    benchmark's own runs use none of them."""
    dev = torch.device(device)
    shape = dict(cell.config, **(shape_override or {}))
    tr = cell.traffic
    kind = tr["kind"]
    ranks = _ranks(cell)
    lead = ranks is None or ranks[0] == 0
    if ranks is not None and kind != "train":
        raise ValueError(f"{cell.name}: a cell on several cards drives the 'train' kind only")
    model = cell.model
    prog = model.Program(shape, lr=tr.get("lr", 1e-2), mesh=None if ranks is None else dev.type,
                         device=dev)
    if plant is not None:
        prog = plant(prog, model)
    params, data = prog.place(*model.draw(shape, seed, dev, tr.get("perturb")))
    steps = None  # on several cards, every rank's count of window items
    if kind == "train":
        opt = prog.adam_init(params)
        losses, m1 = [], None
        for k in range(tr["check_steps"]):
            params, opt, loss = prog.train_step(params, opt, data)
            losses.append(loss)
            if k == 0:
                m1 = _host(opt.m)
                t_paced = time.perf_counter()
        _sync(dev)
        pace = (time.perf_counter() - t_paced) / max(1, tr["check_steps"] - 1)
        checked = {"losses": [float(x) for x in losses], "m1": m1, "params": _host(params)}
        state = {"params": params, "opt": opt}
        if ranks is not None:
            # the window's steps, from the pace of the set-up steps after the
            # first, the most any rank asks for: every rank runs as many, or
            # an all-reduce hangs
            if tr["check_steps"] < 2:
                raise ValueError(f"{cell.name}: the pace needs 2 check steps or more")
            steps = _most([max(1, round(seconds / pace))], dev)[0]

        def issue():
            state["params"], state["opt"], value = prog.train_step(state["params"], state["opt"],
                                                                   data)
            return value
    elif kind == "build":
        if not hasattr(prog, "build"):
            raise ValueError(f"{cell.name}: {model.__name__} has no state build")
        for _ in range(tr["warm_builds"]):
            prog.build(params, data)
        kept, state = {}, {"n": 0}
        pick = seed % tr["check_pick"]

        def issue():
            s = prog.build(params, data)
            if state["n"] == pick:
                kept["picked"] = s
            kept["last"] = s
            state["n"] += 1
            return s.Kuu_inv_mean
    else:
        raise ValueError(f"traffic kind {kind!r}: the driver knows 'train' and 'build'")
    _sync(dev)
    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    ops = tuple(model.STATS_OPS[kind])
    done, failed, window_s = _window(issue, seconds, dev, steps)
    if traced:
        item_s = window_s / done
        steps_t = None if steps is None else max(
            1, round(steps * min(seconds, TRACE_SECONDS) / seconds))
        # the first rank alone is traced; the others run the same steps
        with trace.profiling() if lead else contextlib.nullcontext([]) as holder:
            issue()  # the profiler's first activity, outside the window
            _sync(dev)
            done_t, failed_t, _ = _window(issue, min(seconds, TRACE_SECONDS), dev, steps_t)
        done, failed = done + done_t, failed + failed_t
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    extra = {}  # the numbers only a cell on several cards has
    if ranks is not None:
        peak_setup, peak, most, least = _most([peak_setup, peak, done, -done], dev)
        extra["step_gap"] = float(most + least)
        extra["rank_gap"] = _rank_gap([checked["params"], _host(state["params"])],
                                      prog.local_keys, dev)
        for key in ("m1", "params"):
            checked[key] = _gather(checked[key], prog.local_keys, shape["N"], dev)
        if lead:
            log(f"ranks: {ranks[1]}, {done} steps on rank 0, step_gap {most + least} "
                f"({steps} agreed a window, {pace * 1e3:.2f} ms a set-up step)")
        else:
            del issue, state, params, data, opt
            _free(dev)
            return None
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1 if ranks is None else ranks[1],
                   "memory_peak_bytes": max(peak_setup, peak)}
    metrics, breakdown = {}, None
    if traced:
        t0 = time.perf_counter()
        t = trace.summarize(holder[0], ops)
        holder.clear()
        log(f"trace: {t.window_s:.3f} s window read in {time.perf_counter() - t0:.1f} s; "
            f"{1e3 * item_s:.4f} ms an item untraced, {1e3 * t.window_s / done_t:.4f} traced, "
            f"{1e3 * t.busy_s / done_t:.4f} busy")
        cur = state["params"] if kind == "train" else params
        validated = _validate(t, model, cur, data, ops, dev, log)
        # the readers see this card's share: its rows of the points
        local = shape if ranks is None else dict(shape, N=data[0].shape[0])
        reading = Reading(t, done_t, item_s, local, validated, model)
        for m in cell.per_layer:
            value = load_reader(m).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    else:
        per = {"setup_s": setup_s, "peak_mem_gib": peak / 2**30,
               PER_ITEM[kind]: 1e3 * window_s / done}
        for m in cell.end_to_end:
            value = per.get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the check: the program's state is freed, then the reference runs
    del issue, state, params, data
    if kind == "train":
        del opt
    _free(dev)
    t_ref = time.perf_counter()
    detail = {} if numbers_out is not None else None
    params0, data0 = model.draw(shape, seed, dev, tr.get("perturb"))
    reference = model.reference
    num = reference.Numerics.of("float64", problem.DTYPES[shape["dtype"]])
    key = (json.dumps(shape, sort_keys=True), json.dumps(tr, sort_keys=True), seed)
    if ref_cache is not None and key not in ref_cache:
        ref_cache.clear()  # one seed's at a time
    ref = None if ref_cache is None else ref_cache.get(key)
    if kind == "train":
        if ref is None:
            ref = reference.train(params0, *data0, tr["check_steps"], tr.get("lr", 1e-2), num)
        numbers = check.train_numbers(checked, ref, params0, detail)
    else:
        if ref is None:
            ref = reference.build(params0, *data0, num)
        numbers = check.merge([check.build_numbers(s, ref) for s in kept.values()])
    if ref_cache is not None:
        ref_cache[key] = ref
    numbers.update(extra)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    if numbers_out is not None:
        numbers_out.update(numbers, detail=detail)
    ok, shown = check.verdict(numbers, cell.limits)
    result = {"correct": bool(ok and failed == 0), "attempted": done, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    return result
