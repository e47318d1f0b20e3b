"""CLI for the port's analysis passes: ``python -m repro_torch.analysis``.

    python -m repro_torch.analysis --all            # every pass
    python -m repro_torch.analysis --lint           # AST rules only
    python -m repro_torch.analysis --concurrency    # lock graph / races / blocking
    python -m repro_torch.analysis --kernel-audit   # launch plans, shared
                                                    # memory, coverage, dtypes
    python -m repro_torch.analysis --trace-check    # scaling classes of the
                                                    # SGPR and GP-LVM losses
    python -m repro_torch.analysis --all --format json   # machine-readable

Exit status is the number of failing passes (0 on a clean tree). Findings
print with file:line so editors can jump to them; ``--format json`` emits
one JSON document (findings, lock graph, audit rows, scaling checks).
Suppress a lint/concurrency finding inline with ``# noqa: ANL00x``; there
is deliberately no suppression for the kernel audit or the trace check —
fix the kernel or state a wider bound instead.

The lint and concurrency passes walk every .py under src/repro_torch, or
the PATHs given. The kernel audit plans on this host's card when it has
one (`--smem-budget` overrides the block opt-in limit), else on
`kernel_audit.StandInCard`. The trace check runs the losses on the CPU,
through the plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _run_lint(paths, emit) -> tuple:
    from repro_torch.analysis.lint import lint_paths

    findings = lint_paths(paths or None)
    for f in findings:
        emit(f.describe())
    emit(f"[lint] {len(findings)} finding(s) across rules ANL001-ANL004 "
         f"(+ inferred ANL006)")
    return (1 if findings else 0), {"findings": [dataclasses.asdict(f) for f in findings]}


def _run_concurrency(paths, emit) -> tuple:
    from repro_torch.analysis.concurrency import (BLOCKING_OK, LOCK_HIERARCHY,
                                                  analyze_paths)

    model = analyze_paths(paths or None)
    for f in model.findings:
        emit(f.describe())
    emit(f"[concurrency] {len(model.defs)} lock(s), "
         f"{len(model.acquisitions)} acquisition site(s), "
         f"{len(model.edges)} order edge(s), "
         f"{len(model.findings)} finding(s) across rules ANL005-ANL007")
    payload = {
        "hierarchy": list(LOCK_HIERARCHY),
        "blocking_ok": sorted(BLOCKING_OK),
        "locks": [dataclasses.asdict(d) for d in model.defs.values()],
        "edges": [
            {"held": a, "acquired": b,
             "sites": [f"{p}:{ln}" for p, ln in sorted(sites)]}
            for (a, b), sites in sorted(model.edges.items())
        ],
        "findings": [f.as_dict() for f in model.findings],
    }
    return (1 if model.findings else 0), payload


def _run_kernel_audit(smem_budget_bytes: int, emit) -> tuple:
    from repro_torch.analysis.kernel_audit import audit_kernels, kernel_table

    audits = audit_kernels(smem_budget_bytes=smem_budget_bytes)
    bad = 0
    for a in audits:
        status = "ok" if (a.fits and not a.findings) else "FAIL"
        grids = " ".join(f"{p.name}{list(p.grid)}" for p in a.passes)
        emit(f"[kernel] {a.name:22s} {a.dtype:8s} {grids:44s} "
             f"smem {a.smem_bytes:6d} B (budget {a.smem_budget_bytes})  {status}")
        for r in a.resources:
            emit(f"         {r['instance']}: {r['registers']} registers, "
                 f"{r['spill_stores']}/{r['spill_loads']} bytes spilled "
                 f"(stores/loads), {r['stack_frame']} bytes stack, "
                 f"{r['smem_static']} bytes static smem")
        for f in a.findings:
            emit(f"         {f.describe()}")
            bad += 1
    emit(f"[kernel] {len(audits)} kernel instance(s) audited, {bad} finding(s)")
    return (1 if bad else 0), {"kernels": kernel_table(audits)}


def _trace_checks():
    """(name, loss fn, args, sizes) of each scaling check on the CPU (the
    plain versions; `chip_smoke.py` runs the check on the card's kernel
    wrappers): the SGPR and GP-LVM losses with their gradients, one-shot
    through "fused" and streamed in chunks through "jnp" and "pallas"."""
    import numpy as np
    import torch

    from repro_torch.gp import BayesianGPLVM, SparseGPRegression

    N, M, Q, D, chunk = 2048, 16, 1, 3, 512
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(-3.0, 3.0, (N, Q)))
    Y = torch.as_tensor(rng.normal(size=(N, D)))
    sizes = {"N": N, "M": M, "Q": Q, "D": D}
    for backend, ch in (("fused", None), ("jnp", chunk), ("pallas", chunk)):
        sgpr = SparseGPRegression(M=M, backend=backend, chunk=ch, device="cpu")
        yield (f"sgpr {backend}", sgpr._loss, (sgpr.init_params(X, Y), X, Y), sizes)
        gplvm = BayesianGPLVM(M=M, backend=backend, chunk=ch, device="cpu")
        yield (f"gplvm {backend}", gplvm._loss, (gplvm.init_params(Y), Y), sizes)


def _run_trace_check(emit) -> tuple:
    from repro_torch.analysis.trace_check import ScalingViolation, assert_no_scaling

    checks, bad = [], 0
    for name, loss, args, sizes in _trace_checks():
        try:
            rep = assert_no_scaling(loss, *args, axis="N", worse_than="N*M",
                                    sizes=sizes, backward=True)
        except ScalingViolation as exc:
            emit(f"[trace] {name} loss and gradients: FAIL: {exc}")
            checks.append({"name": name, "bound": "N*M", "error": str(exc)})
            bad += 1
            continue
        emit(f"[trace] {name} loss and gradients: worst intermediate "
             f"{rep.worst_class} ({rep.worst.op} at {rep.worst.source}) — below "
             f"the O(N*M) bound")
        checks.append({"name": name, "bound": "N*M", "worst_class": rep.worst_class})
    return (1 if bad else 0), {"checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static-analysis passes over the repro_torch tree")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (default when no pass is selected)")
    ap.add_argument("--lint", action="store_true", help="AST lint rules")
    ap.add_argument("--concurrency", action="store_true",
                    help="lock-acquisition graph: order cycles (ANL005), "
                         "guard-inferred races (ANL006), blocking under "
                         "locks (ANL007)")
    ap.add_argument("--kernel-audit", action="store_true",
                    help="CUDA kernel launch plans, shared memory, coverage, dtypes")
    ap.add_argument("--trace-check", action="store_true",
                    help="scaling classes of the SGPR and GP-LVM losses")
    ap.add_argument("--smem-budget", type=int, default=None, metavar="BYTES",
                    help="override the per-block shared-memory budget of the audit")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="text (default) prints findings with file:line; "
                         "json emits one machine-readable document")
    ap.add_argument("paths", nargs="*", metavar="PATH",
                    help="restrict the lint/concurrency passes to these "
                         "files (default: every .py under src/repro_torch)")
    args = ap.parse_args(argv)

    chosen = (args.lint or args.concurrency or args.kernel_audit or args.trace_check)
    run_all = args.all or not chosen
    text = args.format == "text"
    emit = print if text else (lambda *_a, **_k: None)

    failures = 0
    passes = {}
    if run_all or args.lint:
        rc, passes["lint"] = _run_lint(args.paths, emit)
        failures += rc
    if run_all or args.concurrency:
        rc, passes["concurrency"] = _run_concurrency(args.paths, emit)
        failures += rc
    if run_all or args.kernel_audit:
        from repro_torch.analysis.kernel_audit import SMEM_BUDGET_BYTES

        rc, passes["kernel_audit"] = _run_kernel_audit(
            args.smem_budget or SMEM_BUDGET_BYTES, emit)
        failures += rc
    if run_all or args.trace_check:
        rc, passes["trace_check"] = _run_trace_check(emit)
        failures += rc

    if text:
        print(f"static analysis: {failures} pass(es) failed" if failures
              else "static analysis: all passes clean")
    else:
        print(json.dumps({"passes": passes, "failures": failures,
                          "ok": failures == 0}, indent=2, sort_keys=True))
    return failures


if __name__ == "__main__":
    sys.exit(main())
