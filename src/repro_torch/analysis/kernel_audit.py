"""CUDA kernel auditor: launch plans, shared memory, N-split coverage and
compute dtypes of the seven kernels, without launching anything (the
port's counterpart of `repro.analysis.pallas_audit`).

A Pallas kernel's promises live in its BlockSpecs; a CUDA kernel's live in
its wrapper's launch plan. For each kernel (B1-B7) and float dtype this
checks:

  * its launch plan: the N-splits and scratch `tune.search.launch_plan`
    computes with the wrapper's own split functions, refused (PLAN001)
    where `tune.search.check_shared_memory` says the kernel cannot take
    the problem;
  * each pass's grid and block, and the dynamic shared memory a block asks
    for against a budget (SMEM001; default: the block opt-in limit
    `suffstats.SMEM_LIMIT`, 227 KB on sm_90);
  * coverage (COVER001), the counterpart of "index maps stay in bounds":
    every pass's N-splits cover [0, N) exactly once with no gap, overlap
    or empty split, one point-pass block per 256 points covers [0, N), and
    the tiles of the other axes — the psi2 pair blocks over the
    M (M + 1) / 2 pairs, column and inducing-point tiles over [0, M), psiY
    tiles over [0, D) — cover theirs exactly once;
  * its compute dtype (DTYPE001): half inputs run through the float32
    entry, float32 and float64 through their own (`kernels.ops`'s
    promotion, the C1 repair).

On the card the plan comes from the libraries' own occupancy queries
(`tune.search.Card`); elsewhere from `StandInCard`, an H100's SM count
with the geometry the libraries compute and report on one. On the card the audit
also attaches each compiled instance's registers, spills, stack (local
memory) and static shared memory, parsed from the `-Xptxas -v` report
`kernels._build` keeps (`ptxas_resources`).

`kernel_table` turns the audits into JSON-ready rows (the counterpart of
`vmem_table`).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import psi1 as p1
from repro_torch.kernels import suffstats as ss
from repro_torch.tune import search

__all__ = [
    "Problem",
    "AuditFinding",
    "Pass",
    "Plan",
    "KernelAudit",
    "KERNELS",
    "SMEM_BUDGET_BYTES",
    "StandInCard",
    "audit_kernel",
    "audit_kernels",
    "audit_plan",
    "kernel_plan",
    "kernel_instance",
    "kernel_table",
    "ptxas_resources",
]

# the block opt-in limit of dynamic shared memory on sm_90 (227 KB)
SMEM_BUDGET_BYTES = ss.SMEM_LIMIT

# the reference's kernel names (the tuner's keys), B1-B7
KERNELS = ("suffstats_pallas", "suffstats_bwd_pallas", "psi2_pallas",
           "psi2_bwd_pallas", "psi1_pallas", "psi1_bwd_pallas", "kfu_pallas")

# every float dtype the ops take, and the entry each one runs through
_DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.float64)
_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class Problem:
    """The sizes the kernels are audited at: several pair blocks, Q > 1,
    D > 1 and an odd N, so every pass has tiles and splits to check."""

    N: int = 100_003
    M: int = 256
    Q: int = 4
    D: int = 5


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    kernel: str
    code: str  # PLAN001 | SMEM001 | COVER001 | DTYPE001
    message: str

    def describe(self) -> str:
        return f"{self.kernel}: {self.code} {self.message}"


class Pass(NamedTuple):
    """One kernel launch of a wrapper: its grid and threads a block."""
    name: str
    grid: Tuple[int, ...]
    block: int


@dataclasses.dataclass(frozen=True)
class KernelAudit:
    """One kernel at one dtype: its plan, shared memory and findings, and
    on the card its instances' ptxas resources."""

    name: str  # the reference's kernel name
    lib: str  # the port's library (csrc/<lib>.cu)
    dtype: str
    problem: Problem
    passes: Tuple[Pass, ...]
    splits: Tuple[int, ...]
    scratch_bytes: int
    smem_bytes: int
    smem_budget_bytes: int
    compute: Dict[str, str]  # input dtype -> the entry it runs through
    resources: Tuple[Dict[str, Any], ...]
    findings: Tuple[AuditFinding, ...]

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= self.smem_budget_bytes


# resident B2 point-pass blocks a multiprocessor, as the library's occupancy
# query reported them on an H100: (float64, compile-time Q or 0) -> blocks
POINT_RESIDENT = {(False, 1): 2, (False, 2): 3, (False, 3): 3, (False, 4): 2, (False, 0): 2,
                  (True, 1): 2, (True, 2): 2, (True, 3): 1, (True, 4): 1, (True, 0): 1}


class StandInCard:
    """What `tune.search.Card` reports, for a host with no card: an H100's
    132 multiprocessors; the psi2 passes' pairs a block, staged run and
    reduction group as the libraries compute them from Q
    (csrc/common.cuh: psi2_geometry, csrc/reverse.cuh: pair_geometry); and
    the resident blocks a multiprocessor the libraries' occupancy queries
    reported on an H100 at the paper's shape (the psi2 forward 5 / 4 in
    float32 / float64, the reverse pair pass 3 / 2, psi1 6, K_fu 8 / 6,
    the psi1 reverse 2 / 1; `chip_smoke.py`'s `[slots]` lines; B2's point
    pass POINT_RESIDENT)."""
    sms = 132

    def psi2_geometry(self, lib: str, dtype: torch.dtype, Q: int) -> ss.Geometry:
        f64 = dtype == torch.float64
        if lib.endswith("fwd"):
            return ss.Geometry((4 if Q <= 16 else 1) * ss.PAIR_THREADS,
                               4 if f64 else 5, 128, 1)
        qc = Q if Q <= 4 else 0
        slots = 1 if qc == 0 else 4 if qc <= 2 else 2
        return ss.Geometry(slots * ss.PAIR_THREADS, 2 if f64 else 3,
                           16 if qc == 0 else 32, 1 if qc == 0 else 4 if qc == 1 else 2)

    def cross_resident(self, lib: str, dtype: torch.dtype, Q: int, cols: int) -> int:
        return 8 if lib == "kfu_fwd" and dtype != torch.float64 else 6

    def psi1_bwd_resident(self, dtype: torch.dtype, M: int, Q: int,
                          plan: ss.Psi1BwdPlan) -> int:
        return 1 if dtype == torch.float64 else 2

    def point_resident(self, dtype: torch.dtype, Q: int) -> int:
        return POINT_RESIDENT[dtype == torch.float64, Q if Q <= 4 else 0]


def _card(card):
    if card is not None:
        return card
    if torch.cuda.is_available():
        return search.Card(torch.cuda.current_device())
    return StandInCard()


# ---------------------------------------------------------------------------
# the launch plan of a wrapper, and the checks
# ---------------------------------------------------------------------------

Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a wrapper launches at one problem: its passes, the N-split
    count of each split pass, the scratch it allocates (the splits'
    partial sums and, for B2 and B4, the per-(pair block, point) sums), the
    most dynamic shared memory a block of it asks for, and each axis it
    tiles as (what, [begin, end) ranges, extent)."""

    passes: Tuple[Pass, ...]
    splits: Tuple[int, ...]
    scratch_bytes: int
    smem_bytes: int
    covers: Tuple[Tuple[str, Ranges, int], ...]


def _cover(ranges: Sequence[Tuple[int, int]], total: int) -> Optional[str]:
    """None if `ranges` cover [0, total) exactly once, in order, none empty;
    else what is wrong."""
    at = 0
    for lo, hi in ranges:
        if lo != at:
            return (f"[{at}, {lo}) uncovered" if lo > at
                    else f"[{lo}, {at}) covered twice")
        if hi <= lo:
            return f"empty or reversed range [{lo}, {hi})"
        at = hi
    if at != total:
        return f"covers [0, {at}), not [0, {total})"
    return None


def _tiles(total: int, tile: int) -> Ranges:
    return tuple((t, min(t + tile, total)) for t in range(0, total, tile))


def kernel_plan(name: str, problem: Problem, dtype, card) -> Plan:
    """The untuned plan of kernel `name`'s wrapper at `problem` in `dtype`
    on `card`: the splits and scratch of `tune.search.launch_plan` (the
    wrapper's own split functions), the grids the libraries launch, their
    shared memory and tiles. Raises ValueError where the kernel cannot take
    the problem (`tune.search.check_shared_memory`)."""
    lib = search.KERNELS[name].lib
    N, M, Q, D = problem.N, problem.M, problem.Q, problem.D
    search.check_shared_memory(name, Q, M, dtype)
    launch = search.launch_plan(name, search.DEFAULT_WAVES, search.Problem(N, M, Q, D),
                                dtype, card)
    counts, scratch = launch.counts, launch.scratch_bytes
    size = torch.finfo(dtype).bits // 8
    T = ss.PAIR_THREADS
    covers = [(f"N-splits of pass {i} ({P})", tuple(ss.split_bounds(N, P)), N)
              for i, P in enumerate(counts)]
    passes: List[Pass] = []
    if lib in ("suffstats_fwd", "suffstats_bwd", "psi2_fwd", "psi2_bwd"):
        geo = card.psi2_geometry(lib, dtype, Q)
        blocks = ss.pair_blocks(M, geo.pairs_per_block)
        npairs = ss.pair_count(M)
        covers.append((f"pairs of {blocks} pair blocks",
                       _tiles(npairs, geo.pairs_per_block), npairs))
        passes.append(Pass("pair", (blocks, counts[0]), T))
        if lib in ("suffstats_bwd", "psi2_bwd"):
            covers.append(("points of the point pass", _tiles(N, ss.BWD_THREADS), N))
            blocks = -(-N // ss.BWD_THREADS)
            if lib == "suffstats_bwd":  # a wave of blocks walks each chunk's tiles
                blocks = ss.point_blocks(N, M, geo.pairs_per_block,
                                         card.point_resident(dtype, Q), card.sms)
            passes.append(Pass("point", (blocks,), ss.BWD_THREADS))
            # the pair pass splits each chunk; one chunk's per-point sums
            # `pt` (the running pair sums between chunks are in the launch
            # plan's scratch)
            chunk = ss.point_chunk(N, M, geo.pairs_per_block)
            covers[0] = (f"N-splits of pass 0 ({counts[0]}) in a chunk",
                         tuple(ss.split_bounds(chunk, counts[0])), chunk)
            covers.append((f"chunks of {chunk} points", tuple(ss.chunk_bounds(N, chunk)), N))
            pt_shape, _ = ss.bwd_scratch(N, M, Q, geo, counts[0])
            scratch += size * math.prod(pt_shape)
        if lib == "suffstats_fwd":
            covers.append(("inducing points of the psiY tiles", _tiles(M, ss.Y_TILE_M), M))
            covers.append(("outputs of the psiY tiles", _tiles(D, ss.Y_TILE_D), D))
            passes.append(Pass("psiY", (-(-M // ss.Y_TILE_M), -(-D // ss.Y_TILE_D),
                                        counts[1]), T))
        smem = ss.kernel_smem(lib, Q, size)
    elif lib == "psi1_bwd":
        plan = ss.psi1_bwd_plan(M, Q, size)
        covers.append((f"column tiles of {plan.cols}", _tiles(M, plan.cols), M))
        passes.append(Pass("reverse", (counts[0],), T))
        smem = plan.smem
    else:
        cols = p1.cross_cols(M, Q)
        covers.append((f"column tiles of {cols}", _tiles(M, cols), M))
        passes.append(Pass("cross", (counts[0], -(-M // cols)), T))
        smem = p1.cross_smem(Q, cols, size, lib == "psi1_fwd")
    return Plan(tuple(passes), counts, int(scratch), int(smem), tuple(covers))


def _compute_entries(name: str, findings: List[AuditFinding]) -> Dict[str, str]:
    """input dtype -> the dtype it runs through the kernel in; DTYPE001
    where that breaks the rule (half -> float32, float32 and float64 kept)
    or the kernel has no entry for it."""
    out = {}
    for dt in _DTYPES:
        ct = ops._compute_dtype(dt)
        want = torch.float32 if dt in _HALF else dt
        label = str(dt).removeprefix("torch.")
        out[label] = str(ct).removeprefix("torch.")
        if ct != want or ct not in ss.DTYPES:
            findings.append(AuditFinding(
                name, "DTYPE001",
                f"{label} inputs run in {out[label]} (entry "
                f"{ss.DTYPES.get(ct)!r}); the rule is "
                f"{str(want).removeprefix('torch.')}"))
    return out


def audit_plan(name: str, plan_fn: Callable[[Problem, torch.dtype], Plan], *,
               problem: Problem = Problem(), dtype=torch.float32,
               smem_budget_bytes: int = SMEM_BUDGET_BYTES, lib: str = "",
               check_dtype_rule: bool = False) -> KernelAudit:
    """Audit one launch plan, ``plan_fn(problem, dtype)``: PLAN001 where it
    refuses the problem, COVER001 for each axis its ranges do not cover
    exactly once, SMEM001 where a block asks for more dynamic shared memory
    than the budget; with `check_dtype_rule`, the ops' promotion rule."""
    findings: List[AuditFinding] = []
    compute = _compute_entries(name, findings) if check_dtype_rule else {}
    try:
        plan: Optional[Plan] = plan_fn(problem, dtype)
    except ValueError as e:
        plan = None
        findings.append(AuditFinding(name, "PLAN001", str(e)))
    if plan is not None:
        for what, ranges, total in plan.covers:
            issue = _cover(ranges, total)
            if issue:
                findings.append(AuditFinding(name, "COVER001", f"{what}: {issue}"))
        if plan.smem_bytes > smem_budget_bytes:
            findings.append(AuditFinding(
                name, "SMEM001",
                f"a block asks for {plan.smem_bytes} bytes of dynamic shared "
                f"memory, more than the {smem_budget_bytes}-byte budget"))
    word = "double" if dtype == torch.float64 else "float"
    resources = tuple(r for r in ptxas_resources(lib)
                      if f"<{word}" in r["instance"]) if lib else ()
    return KernelAudit(
        name=name, lib=lib, dtype=str(dtype).removeprefix("torch."),
        problem=problem, passes=plan.passes if plan else (),
        splits=plan.splits if plan else (),
        scratch_bytes=plan.scratch_bytes if plan else 0,
        smem_bytes=plan.smem_bytes if plan else 0,
        smem_budget_bytes=int(smem_budget_bytes), compute=compute,
        resources=resources, findings=tuple(findings))


def audit_kernel(name: str, *, problem: Problem = Problem(), dtype=torch.float32,
                 smem_budget_bytes: int = SMEM_BUDGET_BYTES, card=None) -> KernelAudit:
    """Audit kernel `name` (its reference name, e.g. "suffstats_pallas") at
    `problem` in `dtype` on `card` (default: this host's card, else
    `StandInCard`); nothing launches."""
    card = _card(card)
    return audit_plan(name, lambda prob, dt: kernel_plan(name, prob, dt, card),
                      problem=problem, dtype=dtype,
                      smem_budget_bytes=smem_budget_bytes,
                      lib=search.KERNELS[name].lib, check_dtype_rule=True)


def audit_kernels(problem: Problem = Problem(),
                  smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                  dtypes: Sequence[torch.dtype] = (torch.float32, torch.float64),
                  card=None) -> List[KernelAudit]:
    """Audit every kernel at every dtype (14 audits by default)."""
    card = _card(card)
    return [audit_kernel(name, problem=problem, dtype=dt,
                         smem_budget_bytes=smem_budget_bytes, card=card)
            for name in KERNELS for dt in dtypes]


# ---------------------------------------------------------------------------
# ptxas resources
# ---------------------------------------------------------------------------

def kernel_instance(mangled: str) -> str:
    """A short name of a kernel instance from its mangled name, e.g.
    "pair_kernel<double, 1>" or "point_kernel<float, 0, true>"."""
    m = re.search(r"I([fd])((?:L[ib]\d+E)*)E", mangled)
    if not m:
        return mangled
    # the template's name is the <length><name> just before its arguments
    head = mangled[:m.start()]
    names = [head[-n:] for n in range(1, len(head)) if head[:-n].endswith(str(n))]
    if not names:
        return mangled
    args = ["float" if m.group(1) == "f" else "double"]
    for kind, val in re.findall(r"L([ib])(\d+)E", m.group(2)):
        args.append(val if kind == "i" else ("true" if val == "1" else "false"))
    return f"{names[0]}<{', '.join(args)}>"


def _int(pattern: str, line: str) -> int:
    m = re.search(pattern, line)
    return int(m.group(1)) if m else 0


def parse_ptxas(report: str) -> List[Dict[str, Any]]:
    """One row per compiled entry function of an `-Xptxas -v` report:
    registers, stack frame (local memory), spill stores and loads, static
    shared memory and barriers."""
    rows: List[Dict[str, Any]] = []
    entry: Optional[str] = None
    frame: Dict[str, int] = {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = kernel_instance(line.split("'")[1])
            frame = {}
        elif "spill stores" in line:
            frame = {"stack_frame": _int(r"(\d+) bytes stack frame", line),
                     "spill_stores": _int(r"(\d+) bytes spill stores", line),
                     "spill_loads": _int(r"(\d+) bytes spill loads", line)}
        elif "Used" in line and "registers" in line and entry is not None:
            rows.append({"instance": entry,
                         "registers": _int(r"Used (\d+) registers", line),
                         "stack_frame": frame.get("stack_frame", 0),
                         "spill_stores": frame.get("spill_stores", 0),
                         "spill_loads": frame.get("spill_loads", 0),
                         "lmem": _int(r"(\d+) bytes lmem", line),
                         "smem_static": _int(r"(\d+) bytes smem", line),
                         "barriers": _int(r"used (\d+) barriers", line)})
            entry = None
    return rows


def ptxas_resources(lib: str) -> List[Dict[str, Any]]:
    """The compiled instances of library `lib` with their resources, from
    the build's `-Xptxas -v` report; [] where no report exists (no build on
    this host)."""
    report = _build.ptxas_report(lib)
    return [{"lib": lib, **row} for row in parse_ptxas(report)] if report else []


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def kernel_table(audits: Sequence[KernelAudit]) -> List[Dict[str, Any]]:
    """One JSON-ready row per audit (the counterpart of `vmem_table`)."""
    return [{
        "section": "kernel_audit",
        "kernel": a.name,
        "lib": a.lib,
        "dtype": a.dtype,
        "problem": dataclasses.asdict(a.problem),
        "passes": [{"name": p.name, "grid": list(p.grid), "block": p.block}
                   for p in a.passes],
        "splits": list(a.splits),
        "scratch_bytes": a.scratch_bytes,
        "smem_bytes": a.smem_bytes,
        "smem_budget_bytes": a.smem_budget_bytes,
        "fits": a.fits,
        "compute": dict(a.compute),
        "resources": [dict(r) for r in a.resources],
        "findings": [f.describe() for f in a.findings],
    } for a in audits]
