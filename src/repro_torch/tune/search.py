"""Search space of the launch-geometry autotuner (counterpart of
`repro.tune.search`).

A Pallas block is (tile_n, tile_m). The port's kernels compile their block
size, run length and shared-memory plan in, and choose their grid at run
time from the library's occupancy query, so what is left to tune is each
wrapper's N-split count. A candidate is a number of WAVES of the card's
resident blocks: 1 (the default: the split counts every wrapper launched
before tuning existed, computed by the same functions), 2 or 4. A
candidate is admissible when

  * the kernel takes the problem at all: its shared memory is unchanged by
    the wave count and still fits a block (`suffstats.kernel_smem`,
    `suffstats.psi1_bwd_plan`, `psi1.cross_smem`);
  * no split is shorter than one run: every pass's `Split.want <= most`
    (for the default the clamp simply applies);
  * the partial sums of its splits fit the scratch the wrapper allocates:
    each buffer indexable with 32-bit ints, all of them within
    SCRATCH_LIMIT bytes.

A candidate whose split counts equal a smaller one's launches the same
grid and is dropped. The measuring problem (`measure_problem`) is N =
MEASURE_N at the key's M and Q, or the smallest larger N at which no
candidate is clamped, so each candidate launches a different grid.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import kfu as kf
from repro_torch.kernels import psi1 as p1
from repro_torch.kernels import psi2 as p2
from repro_torch.kernels import suffstats as ss
from repro_torch.kernels.suffstats import Split

__all__ = [
    "WAVE_CANDIDATES",
    "DEFAULT_WAVES",
    "CHUNK_CANDIDATES",
    "DEFAULT_CHUNK",
    "KERNELS",
    "MEASURE_N",
    "MEASURE_PROBLEM",
    "TunedKernel",
    "Problem",
    "Card",
    "Launch",
    "launch_plan",
    "default_blocks",
    "admissible",
    "candidate_blocks",
    "candidate_chunks",
    "measure_problem",
]

WAVE_CANDIDATES = (1, 2, 4)
DEFAULT_WAVES = 1

# streaming chunk ladder; DEFAULT_CHUNK is every chunked path's default
CHUNK_CANDIDATES = (1024, 2048, 4096, 8192)
DEFAULT_CHUNK = 4096

# the measuring N when no candidate is clamped there
MEASURE_N = 100_000
# bytes of partial sums a tuned launch may allocate
SCRATCH_LIMIT = 256 << 20
_INDEX_LIMIT = 2**31  # the kernels index with 32-bit ints

# caps the candidate COUNT, the default included; unset: every wave count
MAX_CANDIDATES_ENV = "REPRO_TORCH_TUNE_MAX_CANDIDATES"


class TunedKernel(NamedTuple):
    """A kernel the tuner knows: its library, CUDA wrapper, plain version
    and the names of their tensor arguments."""
    lib: str
    cuda: Callable
    plain: Callable
    args: Tuple[str, ...]


# the reference's kernel names (the tuner's keys) -> the port's kernel
KERNELS: Dict[str, TunedKernel] = {
    "suffstats_pallas": TunedKernel("suffstats_fwd", ss.suffstats_cuda,
                                    ss.suffstats_fused_plain,
                                    ("mu", "S", "Y", "Z", "v", "l")),
    "suffstats_bwd_pallas": TunedKernel("suffstats_bwd", ss.suffstats_bwd_cuda,
                                        ss.suffstats_vjp_plain,
                                        ("mu", "S", "Y", "Z", "v", "l", "g2", "gY")),
    "psi2_pallas": TunedKernel("psi2_fwd", p2.psi2_cuda, p2.psi2_plain,
                               ("mu", "S", "Z", "v", "l")),
    "psi2_bwd_pallas": TunedKernel("psi2_bwd", ss.psi2_bwd_cuda, ss.psi2_vjp_plain,
                                   ("mu", "S", "Z", "v", "l", "g2")),
    "psi1_pallas": TunedKernel("psi1_fwd", p1.psi1_cuda, p1.psi1_plain,
                               ("mu", "S", "Z", "v", "l")),
    "psi1_bwd_pallas": TunedKernel("psi1_bwd", ss.psi1_bwd_cuda, ss.psi1_vjp_plain,
                                   ("mu", "S", "Z", "v", "l", "g")),
    "kfu_pallas": TunedKernel("kfu_fwd", kf.kfu_cuda, kf.kfu_plain,
                              ("mu", "Z", "v", "l")),
}


@dataclasses.dataclass(frozen=True)
class Problem:
    """The sizes a launch is planned and measured at (the port's own copy
    of the reference's `analysis.pallas_audit.Problem`); defaults: the
    paper's M, Q and D at the measuring N."""
    N: int = MEASURE_N
    M: int = 100
    Q: int = 1
    D: int = 3


# a key is measured at its own M and Q, and at a larger N where
# `measure_problem` needs one
MEASURE_PROBLEM = Problem()


class Card:
    """What a launch's split count depends on besides the shapes, as the
    libraries on CUDA device `index` report it (each query cached by the
    kernel modules). A test substitutes an object with the same methods."""

    def __init__(self, index: int):
        self.index = index
        self.sms = ss.multiprocessors(index)

    def psi2_geometry(self, lib: str, dtype: torch.dtype, Q: int) -> ss.Geometry:
        return ss.geometry(lib, dtype, Q, self.index)

    def cross_resident(self, lib: str, dtype: torch.dtype, Q: int, cols: int) -> int:
        return p1.cross_occupancy(lib, dtype, Q, cols, self.index)

    def psi1_bwd_resident(self, dtype: torch.dtype, M: int, Q: int,
                          plan: ss.Psi1BwdPlan) -> int:
        return ss.psi1_bwd_occupancy(dtype, M, Q, plan, self.index)


class Launch(NamedTuple):
    """A launch's plan: the `Split` of each pass over N and the elements
    and bytes of its partial-sum scratch."""
    splits: Tuple[Split, ...]
    scratch: Tuple[int, ...]
    scratch_bytes: int

    @property
    def counts(self) -> Tuple[int, ...]:
        return tuple(s.count for s in self.splits)


def _check_name(kernel_name: str) -> str:
    if kernel_name not in KERNELS:
        raise KeyError(f"unknown kernel {kernel_name!r}; the tuner knows "
                       f"{sorted(KERNELS)}")
    return KERNELS[kernel_name].lib


def _itemsize(dtype) -> int:
    return torch.finfo(torch.float32 if dtype is None else dtype).bits // 8


def check_shared_memory(kernel_name: str, Q: int, M: int, dtype=None) -> None:
    """Raise ValueError where the kernel cannot take (M, Q) in `dtype`: its
    shared memory (which no wave count changes) exceeds a block's."""
    lib = _check_name(kernel_name)
    size = _itemsize(dtype)
    if lib in ("suffstats_fwd", "suffstats_bwd", "psi2_fwd", "psi2_bwd"):
        need = ss.kernel_smem(lib, Q, size)
    elif lib == "psi1_bwd":
        need = ss.psi1_bwd_plan(M, Q, size).smem  # raises where nothing fits
    else:
        need = p1.cross_smem(Q, p1.cross_cols(M, Q), size, lib == "psi1_fwd")
    if need > ss.SMEM_LIMIT:
        raise ValueError(f"{kernel_name} needs {need} bytes of shared memory at "
                         f"Q={Q}, more than the {ss.SMEM_LIMIT} a block may have")


def launch_plan(kernel_name: str, waves: int, problem: Problem, dtype, card) -> Launch:
    """The splits and scratch of `kernel_name`'s wrapper at `waves` on
    `card`: the same split functions and buffer shapes the wrapper uses.
    Raises ValueError where the kernel cannot take the problem."""
    lib = _check_name(kernel_name)
    dtype = torch.float32 if dtype is None else dtype
    N, M, Q, D = problem.N, problem.M, problem.Q, problem.D
    check_shared_memory(kernel_name, Q, M, dtype)
    size = _itemsize(dtype)
    pairs = ss.pair_count(M)
    if lib in ("suffstats_fwd", "psi2_fwd"):
        pair = ss.psi2_split(N, M, card.psi2_geometry(lib, dtype, Q), card.sms, waves)
        if lib == "suffstats_fwd":
            y = ss.psiy_split(N, M, D, waves)
            splits, scratch = (pair, y), (pair.count * pairs, y.count * M * D)
        else:
            splits, scratch = (pair,), (pair.count * pairs,)
        return Launch(splits, scratch, size * sum(scratch))
    if lib in ("suffstats_bwd", "psi2_bwd"):
        # the pair partials (and B2's dZ partials) in the input dtype; the
        # splits' running pair sums between chunks in float64
        geo = card.psi2_geometry(lib, dtype, Q)
        pair = ss.bwd_pair_split(N, M, geo, card.sms, waves)
        carry = math.prod(ss.bwd_scratch(N, M, Q, geo, pair.count)[1])
        splits, scratch = (pair,), (pair.count * (Q + 1) * pairs,)
        if lib == "suffstats_bwd":
            z = ss.dz_split(N, M, waves)
            splits, scratch = (pair, z), (*scratch, z.count * M * Q)
        return Launch(splits, (*scratch, carry), size * sum(scratch) + 8 * carry)
    if lib == "psi1_bwd":
        plan = ss.psi1_bwd_plan(M, Q, size)
        resident = card.psi1_bwd_resident(dtype, M, Q, plan) * card.sms
        split = ss.psi1_bwd_split(N, plan.run, resident, waves)
        scratch = (split.count * M * Q, split.count * (Q + 1))
        return Launch((split,), scratch, 8 * sum(scratch))  # double partials
    cols = p1.cross_cols(M, Q)
    resident = card.cross_resident(lib, dtype, Q, cols) * card.sms
    return Launch((p1.cross_split(N, M, Q, resident, waves),), (), 0)


def default_blocks(kernel_name: str) -> int:
    """The wave count a kernel launches at when no tuned winner exists —
    also always the first candidate measured."""
    _check_name(kernel_name)
    return DEFAULT_WAVES


def admissible(kernel_name: str, waves: int, *, problem: Problem = Problem(),
               dtype=None, card=None) -> bool:
    """Does `waves` pass the gate at this problem (module docstring)? With
    no card (the CPU, whose plain version has no grid) only the
    shared-memory test applies. Nothing executes."""
    _check_name(kernel_name)
    try:
        if card is None:
            check_shared_memory(kernel_name, problem.Q, problem.M, dtype)
            return True
        plan = launch_plan(kernel_name, waves, problem, dtype, card)
    except ValueError:
        return False
    unclamped = waves == DEFAULT_WAVES or all(s.want <= s.most for s in plan.splits)
    fits = (plan.scratch_bytes <= SCRATCH_LIMIT
            and all(n < _INDEX_LIMIT for n in plan.scratch))
    return unclamped and fits


def _max_candidates(limit: Optional[int]) -> Optional[int]:
    if limit is not None:
        return int(limit)
    env = os.environ.get(MAX_CANDIDATES_ENV)
    return int(env) if env else None


def candidate_blocks(kernel_name: str, *, problem: Problem = Problem(),
                     dtype=None, limit: Optional[int] = None,
                     card=None) -> List[int]:
    """Admissible wave counts worth timing, the default first. A candidate
    that launches the same grid as an earlier one is dropped. `limit` (or
    $REPRO_TORCH_TUNE_MAX_CANDIDATES) caps the list, counting the default,
    so even a 2-candidate grid compares the default with one alternative."""
    limit = _max_candidates(limit)
    ladder = [default_blocks(kernel_name)] + [
        w for w in WAVE_CANDIDATES if w != DEFAULT_WAVES]
    out: List[int] = []
    grids = set()
    for w in ladder:
        if limit is not None and len(out) >= limit:
            break
        if not admissible(kernel_name, w, problem=problem, dtype=dtype, card=card):
            continue
        if card is not None:
            counts = launch_plan(kernel_name, w, problem, dtype, card).counts
            if counts in grids:
                continue
            grids.add(counts)
        out.append(w)
    return out


def _unclamped(kernel_name: str, problem: Problem, dtype, card) -> bool:
    for w in WAVE_CANDIDATES:
        try:
            plan = launch_plan(kernel_name, w, problem, dtype, card)
        except ValueError:
            return True  # the kernel takes no such problem at any N
        if any(s.want > s.most for s in plan.splits):
            return False
    return True


def measure_problem(kernel_name: str, m: int, q: int, dtype=None, card=None,
                    d: int = 3) -> Problem:
    """The problem a key (M, Q) is measured at: N = MEASURE_N, or the
    smallest larger N at which no wave candidate is clamped, so every
    candidate launches a different grid. Without a card, MEASURE_N."""
    prob = dataclasses.replace(MEASURE_PROBLEM, M=int(m), Q=int(q), D=int(d))
    if card is None or _unclamped(kernel_name, prob, dtype, card):
        return prob
    lo, hi = MEASURE_N, 2 * MEASURE_N
    while not _unclamped(kernel_name, dataclasses.replace(prob, N=hi), dtype, card):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:  # lo clamped, hi not
        mid = (lo + hi) // 2
        if _unclamped(kernel_name, dataclasses.replace(prob, N=mid), dtype, card):
            hi = mid
        else:
            lo = mid
    return dataclasses.replace(prob, N=hi)


def candidate_chunks(n: int, *, limit: Optional[int] = None) -> List[int]:
    """Streaming-chunk candidates for a length-N loop, the default first.
    Chunks beyond N are pointless (a single ragged tail); N itself is added
    so small problems still get a one-chunk candidate."""
    limit = _max_candidates(limit)
    ladder = [DEFAULT_CHUNK] + [c for c in CHUNK_CANDIDATES
                                if c != DEFAULT_CHUNK]
    out: List[int] = []
    for c in ladder:
        if c <= n or c == DEFAULT_CHUNK:
            out.append(int(c))
    if n > 0 and int(n) not in out:
        out.append(int(n))
    if limit is not None:
        out = out[:limit]
    return out
