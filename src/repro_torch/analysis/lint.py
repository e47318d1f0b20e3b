"""AST-based lint of the port: the reference's rules ANL001-ANL004
(`repro.analysis.lint`) restated for PyTorch.

  ANL001  import-time device dispatch. `torch.cuda.is_available()`,
          `device_count()`, `current_device()` or `get_device_properties()`
          at module scope bakes the device present at import into module
          state; a process that sets `CUDA_VISIBLE_DEVICES`, forks or spawns
          ranks later sees a stale snapshot. The device is read at call time
          (`repro_torch.device.resolve`, the wrappers' `card_of`).
  ANL002  alias of ANL006: any attribute written under a lock is tracked
          by `repro_torch.analysis.concurrency`'s guard inference and every
          lock-free access of it is flagged. `lint` reports those findings
          inline, and `# noqa: ANL002` keeps muting them.
  ANL003  autograd registration outside the dispatcher. Kernel modules
          must not subclass `torch.autograd.Function` or register a
          `torch.library` autograd formula themselves, nor take a reverse
          pass with `torch.func.vjp` / `torch.autograd.functional.vjp`:
          the ops in `kernels/ops.py` own the forward/reverse wiring, so
          `bwd_backend` dispatch stays the only switch.
  ANL004  hard-coded compute dtypes in kernel wrappers. A wrapper takes
          its compute dtype from its inputs; a literal float dtype passed
          as `dtype=` (`dtype=torch.float32`, `dtype="float32"`) or cast to
          (`.to(torch.bfloat16)`, `.float()` / `.double()` / `.half()` /
          `.bfloat16()`) outside the promotion helpers — functions with
          "promote" in the name or named `_compute_dtype`, as in the
          reference — silently changes a path's precision. As in the
          reference, a dtype that is only read (an entry table such as
          `{torch.float32: "f32"}`, a test `dtype == torch.float64`) is
          not flagged. One exemption of the port's own: an accumulator,
          `dtype=torch.float64` on an allocation (`empty`, `zeros`,
          `new_empty`, `new_zeros`), widens a buffer the kernel sums into
          and cannot narrow any path.

Kernel-file rules (ANL003, ANL004) apply to `repro_torch/kernels/*.py`
except the dispatcher `kernels/ops.py`, as in the reference.

Suppress a finding inline with `# noqa: ANL00x` on the offending line.
`lint_source` lints a string (used by the seeded-violation fixtures);
`lint_paths` walks the tree.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis import concurrency

__all__ = ["LintFinding", "RULES", "lint_source", "lint_paths"]

RULES: Dict[str, str] = {
    "ANL001": "import-time device dispatch (read torch.cuda at call time)",
    "ANL002": "alias of ANL006: lock-guarded attribute accessed without "
              "a lock (guard inference in repro_torch.analysis.concurrency)",
    "ANL003": "autograd registration outside the bwd_backend dispatcher "
              "(kernels/ops.py)",
    "ANL004": "hard-coded compute dtype (dtype= or a cast) in a kernel "
              "wrapper outside its promotion helpers",
}

# device-reading torch.cuda callables that must not run at import time
_DEVICE_CALLS = {"is_available", "device_count", "current_device",
                 "get_device_properties", "get_device_name",
                 "get_device_capability"}

# files whose ANL003/ANL004 rules apply (path match, forward slashes)
_KERNEL_DIR = "repro_torch/kernels/"
_DISPATCH_OWNER = "ops.py"

# float dtype names a kernel wrapper must not hard-code (ANL004)
_DTYPE_LITERALS = {"float16", "half", "bfloat16", "float32", "float",
                   "float64", "double"}
_CAST_METHODS = {"float", "double", "half", "bfloat16"}
# allocations whose float64 dtype= is an accumulator (exempt from ANL004)
_ALLOCATIONS = {"empty", "zeros", "new_empty", "new_zeros"}

# direct reverse passes that bypass the ops (ANL003)
_VJP_CALLS = {"torch.func.vjp", "torch.autograd.functional.vjp", "func.vjp"}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    code: str
    message: str

    def describe(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.is_available' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _dtype_name(node: ast.AST) -> Optional[str]:
    """'float32' for `torch.float32` (any `<name>.<float dtype>` chain
    rooted at torch) or the string "float32"; else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in _DTYPE_LITERALS else None
    dotted = _dotted(node) or ""
    head, _, leaf = dotted.rpartition(".")
    if head.split(".")[0] == "torch" and leaf in _DTYPE_LITERALS:
        return leaf
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: List[LintFinding] = []
        self._func_depth = 0
        self._in_kernel_file = (_KERNEL_DIR in relpath
                                and not relpath.endswith(_DISPATCH_OWNER))
        self._in_promotion_helper = 0

    def _add(self, node: ast.AST, code: str, message: str) -> None:
        self.findings.append(LintFinding(
            self.relpath, getattr(node, "lineno", 0), code, message))

    # -- scope tracking ----------------------------------------------------
    def _visit_func(self, node) -> None:
        self._func_depth += 1
        promo = "promote" in node.name or node.name == "_compute_dtype"
        self._in_promotion_helper += promo
        self.generic_visit(node)
        self._in_promotion_helper -= promo
        self._func_depth -= 1

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1

    # -- rules -------------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        # ANL003: an autograd.Function in a kernel file
        if self._in_kernel_file:
            for base in node.bases:
                dotted = _dotted(base) or ""
                if dotted.endswith("autograd.Function") or dotted == "Function":
                    self._add(node, "ANL003",
                              f"`{node.name}` subclasses torch.autograd."
                              f"Function; the ops in kernels/ops.py own the "
                              f"forward/reverse wiring (bwd_backend "
                              f"dispatch), not individual kernel files")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        leaf = dotted.rsplit(".", 1)[-1]

        # ANL001: device read at module scope
        if (self._func_depth == 0 and ".cuda." in f".{dotted}"
                and leaf in _DEVICE_CALLS):
            self._add(node, "ANL001",
                      f"`{dotted}()` runs at import time; read the device at "
                      f"call time (repro_torch.device.resolve)")

        if self._in_kernel_file:
            # ANL003: torch.library autograd registration / direct vjp
            if leaf == "register_autograd":
                self._add(node, "ANL003",
                          "autograd registration belongs to the ops in "
                          "kernels/ops.py (bwd_backend dispatch), not "
                          "individual kernel files")
            elif dotted in _VJP_CALLS:
                self._add(node, "ANL003",
                          "a direct vjp of a plain version bypasses "
                          "bwd_backend dispatch; take the reverse pass "
                          "through kernels/ops.py")
            # ANL004: dtype= literals and casts to a literal dtype
            if not self._in_promotion_helper:
                for kw in node.keywords:
                    name = _dtype_name(kw.value) if kw.arg == "dtype" else None
                    accumulator = leaf in _ALLOCATIONS and name in ("float64", "double")
                    if name and not accumulator:
                        self._add(node, "ANL004",
                                  f"hard-coded dtype={name}; take the compute "
                                  f"dtype from the inputs or a promotion helper")
                name = _dtype_name(node.args[0]) if leaf in ("to", "type") and node.args else None
                if name:
                    self._add(node, "ANL004",
                              f"hard-coded .{leaf}({name}); take the compute "
                              f"dtype from the inputs or a promotion helper")
                if (isinstance(node.func, ast.Attribute) and not node.args
                        and node.func.attr in _CAST_METHODS):
                    self._add(node, "ANL004",
                              f"hard-coded `.{node.func.attr}()` cast; take "
                              f"the compute dtype from the inputs or a "
                              f"promotion helper")
        self.generic_visit(node)


def lint_source(source: str, relpath: str) -> List[LintFinding]:
    """Lint one module's source text. `relpath` selects which rules apply
    (kernel-file rules key off the path) and is reported in findings.

    Unguarded-shared-state findings (the generalized ANL002) come from
    `repro_torch.analysis.concurrency.guard_findings` and are reported here
    as ANL006, so a plain `--lint` run still catches the registry-race bug
    class without the full lock-graph pass."""
    relpath = relpath.replace("\\", "/")
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as exc:
        return [LintFinding(relpath, exc.lineno or 0, "ANL000",
                            f"syntax error: {exc.msg}")]
    visitor = _Visitor(relpath)
    visitor.visit(tree)
    lines = source.splitlines()
    findings = [f for f in visitor.findings
                if f.code not in concurrency.noqa_codes(lines, f.line)]
    findings.extend(
        LintFinding(f.path, f.line, f.code, f.message)
        for f in concurrency.guard_findings(source, relpath))
    findings.sort(key=lambda f: (f.line, f.code))
    return findings


def lint_paths(paths: Optional[Iterable[pathlib.Path]] = None,
               root: Optional[pathlib.Path] = None) -> List[LintFinding]:
    """Lint a set of files (default: every .py under src/repro_torch)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[2]
    if paths is None:
        paths = sorted((root / "repro_torch").rglob("*.py"))
    findings: List[LintFinding] = []
    for path in paths:
        resolved = pathlib.Path(path).resolve()
        try:
            rel = str(resolved.relative_to(root))
        except ValueError:  # outside src/ (e.g. a fixture): report as given
            rel = str(path)
        findings.extend(lint_source(
            resolved.read_text(encoding="utf-8"), rel))
    return findings
