"""Empirical launch-geometry and chunk autotuner (counterpart of
`repro.tune.autotune`).

On the FIRST use of a kernel at a given key the tuner times every
admissible wave count (`repro_torch.tune.search`) on the real wrapper and
persists the winner in the JSON store (`repro_torch.tune.cache`). Every
later use, in this process or any other, is a pure lookup: a warm cache
performs ZERO timing runs (`timing_runs()` is the witness).

Resolution order of `best_blocks` / `best_chunk`:

  1. in-process memo (a dict hit — the per-launch cost),
  2. persistent cache file,
  3. when tuning is `enabled()`: measure, store, return the winner,
  4. otherwise: memoize the fallback (one wave / DEFAULT_CHUNK) without
     ever starting a stopwatch.

Tuning is on by default exactly on a CUDA device, where the measured times
mean something; REPRO_TORCH_TUNE ("0"/"false"/"off" disable, anything else
enables) overrides that, and `_ENABLED_OVERRIDE` (the test hook) overrides
both. Forced on the CPU, the candidates run the plain versions, which have
no grid: a check of the tuner's mechanics, whose times say nothing about
the kernels. Keys read `kind|name|dtype|M=|Q=|cuda|<device name>` (or
`...|cpu|cpu`), so winners never leak across cards, dtypes or shapes; N is
absent, since the wave count does not depend on N above the clamp.

The reference's `cached_interpret_max_n` has no counterpart: the port has
no interpret mode, and its CPU path is the plain version.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.tune import cache, search

__all__ = [
    "TUNE_ENV",
    "best_blocks",
    "best_chunk",
    "clear_memo",
    "enabled",
    "kernel_inputs",
    "make_key",
    "measure_blocks",
    "measure_chunks",
    "problem_for",
    "run_kernel",
    "timing_runs",
]

TUNE_ENV = "REPRO_TORCH_TUNE"

# Test-visible override: None = environment/device policy, True/False force.
_ENABLED_OVERRIDE: Optional[bool] = None

# One lock guards the whole resolve-measure-store cycle, so two threads
# racing the same cold key serialize and agree on one winner (the second
# lands on the memo the first filled). Re-entrant: a chunk measurement
# through the fused op resolves that op's blocks inside it.
_LOCK = threading.RLock()
_MEMO: Dict[tuple, Any] = {}  # (cache path, key) -> winner

_TIMING_RUNS = 0

_WARMUP = 1
_ITERS = 3

# the measuring N of a forced run on the CPU (no grid to spread over)
CPU_MEASURE_N = 1024

def _device(device=None) -> torch.device:
    """`device` as a concrete torch.device; None: the current CUDA device
    where there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def enabled(device=None) -> bool:
    """Is the measuring path live for `device`? The test override wins,
    then $REPRO_TORCH_TUNE when set, else on exactly for a CUDA device.
    Disabled keys still resolve through the same lookup path — they just
    memoize the defaults with zero timing runs."""
    if _ENABLED_OVERRIDE is not None:
        return bool(_ENABLED_OVERRIDE)
    env = os.environ.get(TUNE_ENV)
    if env is not None and env != "":
        return env.strip().lower() not in ("0", "false", "off")
    return _device(device).type == "cuda"


def timing_runs() -> int:
    """Candidates this process has timed. The warm-cache contract is that
    a second process over the same cache file keeps this at zero."""
    return _TIMING_RUNS


def clear_memo() -> None:
    """Drop the in-process memo (NOT the persistent file) — tests use this
    to re-exercise the cache-file path within one process."""
    with _LOCK:
        _MEMO.clear()


def _where(dev: torch.device) -> tuple:
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"


def make_key(kind: str, name: str, dtype, m: int, q: int, extra: str = "",
             device=None) -> str:
    """The persistent-store key: what the winner is FOR (kind+name) and
    what it was measured ON (dtype, M, Q, device type, device name)."""
    dt = str(torch.float32 if dtype is None else dtype).removeprefix("torch.")
    parts = [kind, name, dt, f"M={int(m)}", f"Q={int(q)}", *_where(_device(device))]
    if extra:
        parts.append(extra)
    return "|".join(parts)


def _time_fn(fn: Callable[[], Any]) -> float:
    """Median-of-_ITERS wall time of one candidate after _WARMUP calls;
    `fn` synchronizes the card itself. Monkeypatchable in tests;
    `timing_runs` is counted by the measure_* callers, not here, so fake
    timers still register."""
    for _ in range(_WARMUP):
        fn()
    times = []
    for _ in range(_ITERS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _synced(call: Callable[[], Any], dev: torch.device) -> Callable[[], Any]:
    def fn():
        out = call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    return fn


def kernel_inputs(kernel_name: str, problem: search.Problem, dtype=None,
                  device=None, seed: int = 0) -> tuple:
    """The tensor arguments of `kernel_name`'s wrapper at `problem`, from a
    numpy seed: q(X) means and variances, outputs, inducing points,
    hyperparameters and (for the reverse kernels) output cotangents."""
    dtype = torch.float32 if dtype is None else dtype
    N, M, Q, D = problem.N, problem.M, problem.Q, problem.D
    rng = np.random.default_rng(seed)
    draw = {"mu": lambda: rng.normal(size=(N, Q)),
            "S": lambda: rng.uniform(0.05, 0.6, (N, Q)),
            "Y": lambda: rng.normal(size=(N, D)),
            "Z": lambda: 1.2 * rng.normal(size=(M, Q)),
            "v": lambda: np.float64(1.3), "l": lambda: rng.uniform(0.6, 1.4, Q),
            "g2": lambda: rng.normal(size=(M, M)),
            "gY": lambda: rng.normal(size=(M, D)),
            "g": lambda: rng.normal(size=(N, M))}
    arrays = {a: draw[a]() for a in search.KERNELS[kernel_name].args}
    dev = _device(device)
    return tuple(torch.as_tensor(arrays[a]).to(device=dev, dtype=dtype)
                 for a in search.KERNELS[kernel_name].args)


def run_kernel(kernel_name: str, args: tuple, waves: int):
    """One call of `kernel_name` on `args`: its CUDA wrapper at `waves` for
    CUDA tensors, its plain version (no grid) for CPU tensors."""
    kernel = search.KERNELS[kernel_name]
    if args[0].device.type == "cuda":
        return kernel.cuda(*args, waves=waves)
    return kernel.plain(*args)


def measure_blocks(kernel_name: str, candidates, *,
                   problem: search.Problem = search.Problem(), dtype=None,
                   device=None) -> Dict[int, float]:
    """Wall time per candidate wave count on the real kernel wrapper (the
    inputs' values do not change the time)."""
    global _TIMING_RUNS
    dev = _device(device)
    with torch.no_grad():
        args = kernel_inputs(kernel_name, problem, dtype, dev)
        out: Dict[int, float] = {}
        for w in candidates:
            _TIMING_RUNS += 1
            out[int(w)] = _time_fn(_synced(
                functools.partial(run_kernel, kernel_name, args, int(w)), dev))
    return out


def measure_chunks(candidates, *, n: int, m: int, q: int, d: int,
                   dtype=None, backend: str = "jnp",
                   bwd_backend: str = "auto", device=None) -> Dict[int, float]:
    """Wall time per streaming chunk size through the real
    `gp.stats.streaming_suff_stats` loop (expected statistics under an RBF
    kernel — the paper's hot path)."""
    global _TIMING_RUNS
    from repro_torch.gp.kernels import RBF
    from repro_torch.gp.stats import ExpectedBatch, streaming_suff_stats

    dtype = torch.float32 if dtype is None else dtype
    dev = _device(device)
    kern = RBF(int(q))
    params = kern.init(device=dev, dtype=dtype)
    mu, S, Y, Z = kernel_inputs("suffstats_pallas",
                                search.Problem(int(n), int(m), int(q), int(d)),
                                dtype, dev)[:4]
    out: Dict[int, float] = {}
    with torch.no_grad():
        for c in candidates:
            _TIMING_RUNS += 1
            out[int(c)] = _time_fn(_synced(functools.partial(
                streaming_suff_stats, kern, params, ExpectedBatch(mu, S, Y, Z),
                backend=backend, chunk=int(c), bwd_backend=bwd_backend), dev))
    return out


def _resolve(key: str, fallback, measure: Callable[[], Any], dev: torch.device):
    """The shared memo -> file -> measure/store -> fallback ladder."""
    path = cache.cache_path()
    memo_key = (path, key)
    with _LOCK:
        if memo_key in _MEMO:
            return _MEMO[memo_key]
        hit = cache.lookup(key, path)
        if isinstance(hit, dict) and "winner" in hit:
            win = hit["winner"]
            _MEMO[memo_key] = win
            return win
        if not enabled(dev):
            _MEMO[memo_key] = fallback
            return fallback
        value = measure()
        if value is None:
            value = fallback
        else:
            cache.store(key, value, path)
            value = value["winner"]
        _MEMO[memo_key] = value
        return value


def best_blocks(kernel_name: str, *, dtype=None, m: int, q: int,
                problem: Optional[search.Problem] = None,
                device=None) -> Optional[int]:
    """The tuned wave count of one kernel at one key on `device`, or None
    meaning "one wave, the untuned launch". `kernels.ops` resolves every
    launch on the card through here, in both directions."""
    dev = _device(device)
    key = make_key("blocks", kernel_name, dtype, m, q, device=dev)

    def measure():
        card = search.Card(dev.index) if dev.type == "cuda" else None
        prob = problem or problem_for(kernel_name, m, q, dtype, dev)
        cands = search.candidate_blocks(kernel_name, problem=prob, dtype=dtype,
                                        card=card)
        if not cands:
            return None
        timings = measure_blocks(kernel_name, cands, problem=prob, dtype=dtype,
                                 device=dev)
        win = min(timings, key=timings.get)
        return {"winner": int(win), "kernel": kernel_name, "N": prob.N,
                "timings_s": {str(w): t for w, t in timings.items()}}

    win = _resolve(key, None, measure, dev)
    return None if win is None else int(win)


def best_chunk(*, n: int, m: int, q: int, d: int, dtype=None,
               backend: str = "jnp", bwd_backend: str = "auto",
               device=None) -> int:
    """The tuned streaming chunk of `gp.stats.streaming_suff_stats` — what
    `chunk="auto"` resolves to. Falls back to `search.DEFAULT_CHUNK` when
    tuning is off and nothing is cached. Measured at N = min(n, 4 x the
    largest candidate)."""
    dev = _device(device)
    key = make_key("chunk", "streaming_suff_stats", dtype, m, q,
                   extra=f"backend={backend}", device=dev)

    def measure():
        n_meas = max(1, min(int(n), 4 * max(search.CHUNK_CANDIDATES)))
        cands = search.candidate_chunks(n_meas)
        if not cands:
            return None
        timings = measure_chunks(cands, n=n_meas, m=m, q=q, d=d, dtype=dtype,
                                 backend=backend, bwd_backend=bwd_backend,
                                 device=dev)
        win = min(timings, key=timings.get)
        return {"winner": int(win), "kernel": "streaming_suff_stats",
                "N": n_meas, "timings_s": {str(c): t for c, t in timings.items()}}

    return int(_resolve(key, search.DEFAULT_CHUNK, measure, dev))


def problem_for(kernel_name: str, m: int, q: int, dtype=None, device=None
                ) -> search.Problem:
    """The problem `best_blocks` measures a key at on `device`."""
    dev = _device(device)
    if dev.type != "cuda":
        return search.Problem(CPU_MEASURE_N, int(m), int(q))
    return search.measure_problem(kernel_name, m, q, dtype, search.Card(dev.index))
