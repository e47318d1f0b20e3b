"""repro_torch.analysis — the port's static analysis (counterpart of
`repro.analysis`).

Four passes plus a runtime verifier, runnable as a library and as a CLI
(``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.trace_check` — records every intermediate of
  an eager call (op outputs and the tensors autograd saves) at two problem
  sizes and classifies each one's scaling class along an axis (O(1),
  O(N), O(N*M), ...). `assert_no_scaling` states the memory guarantee
  ("no grad-path intermediate grows like N*M").
* :mod:`repro_torch.analysis.kernel_audit` — for each of the seven CUDA
  kernels, without launching anything: its launch plan, grid and block,
  dynamic shared memory against a budget, that its N-splits cover [0, N)
  exactly once, and its compute dtype; on the card, each compiled
  instance's registers, spills and static shared memory from the
  `-Xptxas -v` report.
* :mod:`repro_torch.analysis.lint` — AST rules ANL001-ANL004 restated for
  the port (call-time device reads, locked registry access, autograd
  registration only in `kernels/ops.py`, no literal dtypes in kernel
  wrappers outside their promotion helpers).
* :mod:`repro_torch.analysis.concurrency` — the lock model of the port:
  acquisition graph, lock-order cycles / declared-hierarchy inversions
  (ANL005), guard-inferred race candidates (ANL006), blocking calls under
  locks (ANL007).
* :mod:`repro_torch.analysis.lockdep` — runtime lock-order verifier
  (``watch()`` / ``named_lock``); raises ``LockOrderViolation`` on the
  first inversion.

Submodules load lazily: ``concurrency`` and ``lockdep`` are stdlib-only
and are imported when the port's lock-holding modules load, so touching
them must not drag in torch through the heavier passes.
"""
import importlib
from typing import Dict

_EXPORTS: Dict[str, str] = {
    # trace_check
    "AnalysisError": "trace_check",
    "Intermediate": "trace_check",
    "ScalingReport": "trace_check",
    "ScalingViolation": "trace_check",
    "assert_no_scaling": "trace_check",
    "scaling_class": "trace_check",
    "scaling_report": "trace_check",
    "trace_intermediates": "trace_check",
    # lint
    "LintFinding": "lint",
    "RULES": "lint",
    "lint_paths": "lint",
    "lint_source": "lint",
    # kernel_audit
    "AuditFinding": "kernel_audit",
    "KernelAudit": "kernel_audit",
    "Problem": "kernel_audit",
    "SMEM_BUDGET_BYTES": "kernel_audit",
    "audit_kernels": "kernel_audit",
    "kernel_table": "kernel_audit",
    "ptxas_resources": "kernel_audit",
    # concurrency
    "BLOCKING_OK": "concurrency",
    "ConcurrencyFinding": "concurrency",
    "ConcurrencyModel": "concurrency",
    "LOCK_HIERARCHY": "concurrency",
    "analyze_paths": "concurrency",
    "analyze_sources": "concurrency",
    # lockdep
    "LockOrderViolation": "lockdep",
    "named_lock": "lockdep",
    "watch": "lockdep",
}

_SUBMODULES = ("concurrency", "lockdep", "trace_check", "lint", "kernel_audit")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.analysis.{name}")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"repro_torch.analysis.{mod}"), name)


def __dir__():
    return __all__
