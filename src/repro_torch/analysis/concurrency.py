"""Static concurrency analyzer: the port's lock discipline, machine-checked
(the port's own copy of `repro.analysis.concurrency`, stdlib only).

The multithreaded modules of the port (`repro_torch.serve`,
`repro_torch.tune`, `repro_torch.checkpoint`, and the two process locks of
`repro_torch.kernels._build` and `repro_torch.core.psi_stats` that they
reach) stay deadlock- and race-free by a hand-reasoned lock protocol (the
`_budget_lock -> entry.lock -> _registry_lock` order, "registry access only
under its lock", "eviction persists under the entry lock"). This pass turns
that protocol into rules:

  ANL005  lock-order cycle. The whole-tree lock-acquisition graph (edge
          A -> B whenever B is acquired while A is held) must be acyclic,
          and every edge between locks named in `LOCK_HIERARCHY` must
          respect the declared order. An AB/BA pair is a deadlock waiting
          for the right interleaving.
  ANL006  guarded attribute touched without a lock (ANL002 is kept as its
          `# noqa` alias): any attribute that is *written under a lock*
          somewhere outside `__init__` is shared mutable state, and every
          lock-free read or write of it elsewhere is a race candidate.
  ANL007  blocking call while holding a lock. `Future.result`, queue
          `get`s, waits, file I/O, subprocesses and device synchronizations
          under a lock stall every thread behind that lock. Locks whose
          documented JOB is serializing blocking work are declared in
          `BLOCKING_OK`; `cond.wait()` on the condition you hold is the
          intended CV pattern and is exempt.

Everything here is AST work on source text: nothing imports torch, so the
runtime verifier (`repro_torch.analysis.lockdep`) and the modules that
create the locks can import the hierarchy without a cycle.

Scope (what "static" means here):

* Analysis is intraprocedural: a lock held by the *caller* is invisible
  inside the callee. Functions whose name ends in ``_locked`` are the
  declared "caller holds the lock" convention — their bodies are exempt
  from ANL006 and do not feed guard inference.
* A write under a *different* lock than usual (the mixed-guard pattern)
  is left to the runtime verifier; the static rule only flags accesses
  holding no lock at all.
* `self`-attribute inference is per-class; attributes reached through
  other objects (`entry.state`) are covered by the lock graph and lockdep,
  not by ANL006.

Suppress a finding inline with ``# noqa: ANL00x``; ``# noqa: ANL002``
still suppresses the generalized rule (alias).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "RULES",
    "LOCK_HIERARCHY",
    "BLOCKING_OK",
    "ALIASES",
    "ConcurrencyFinding",
    "LockDef",
    "Acquisition",
    "ConcurrencyModel",
    "analyze_sources",
    "analyze_paths",
    "guard_findings",
    "noqa_codes",
    "suppressed",
]

RULES: Dict[str, str] = {
    "ANL005": "lock-order cycle / declared-hierarchy inversion",
    "ANL006": "lock-guarded attribute accessed without a lock "
              "(generalizes ANL002)",
    "ANL007": "blocking call while holding a lock",
}

# Old rule IDs accepted in `# noqa:` comments for the rule that replaced
# them. ANL002 ("_models outside _registry_lock") is now derived from guard
# inference and reported as ANL006.
ALIASES: Dict[str, str] = {"ANL002": "ANL006"}

# ---------------------------------------------------------------------------
# the declared global lock hierarchy
# ---------------------------------------------------------------------------

# Total acquisition order over every named lock in the port: a thread
# holding a lock may only acquire locks FURTHER DOWN this list. The static
# pass checks every visible edge against it and `repro_torch.analysis.
# lockdep` enforces it at runtime. The first seven are the reference's
# order under the port's module names; the two locks only the port has
# were placed by reading every path that takes them:
#   _cv           never wraps another acquisition (queue ops only);
#   _budget_lock  serializes residency transitions and wraps entry locks
#                 (`_insert`, `_resident_state`, `_make_room`/`_evict`);
#   _Entry.lock   wraps store I/O (evict-persists-dirty, lazy reload) and
#                 the leaf registry lock, and reaches the tune locks, a
#                 kernel build and the pinned-precision product through
#                 `refit` / `online.update` -> `kernels.ops`;
#   tune locks    autotune's resolve-measure-store cycle wraps the cache
#                 file lock, and its measurements launch kernels (a build)
#                 and, for `best_chunk`, the statistics' products;
#   StateStore    wraps nothing but the checkpoint manager (lock-free);
#   _build._lock  held across an nvcc run and a library load; nothing is
#                 acquired under it (`build`, `library`), and it is taken
#                 under every lock above it (any first launch of a kernel);
#   _precision_lock  counts the threads inside `full_float32_matmul`;
#                 nothing is acquired under it, and the statistics'
#                 products take it under the serving and tuning locks;
#   _registry_lock is a leaf: nothing is ever acquired under it.
LOCK_HIERARCHY: Tuple[str, ...] = (
    "GPServer._cv",
    "GPServer._budget_lock",
    "_Entry.lock",
    "repro_torch.tune.autotune._LOCK",
    "repro_torch.tune.cache._LOCK",
    "StateStore._lock",
    "repro_torch.kernels._build._lock",
    "repro_torch.core.psi_stats._precision_lock",
    "GPServer._registry_lock",
)

# Locks whose declared purpose is serializing blocking work. ANL007 does not
# fire while ONLY these are held — for anything else, blocking under the
# lock is a finding:
#   StateStore._lock          checkpoint file I/O;
#   tune.cache._LOCK          the tune file's read-merge-write cycle;
#   kernels._build._lock      an nvcc run and the library load: one build
#                             per source at a time, so two threads' first
#                             launches never compile the same library
#                             twice or load a half-written one. Every
#                             thread that reaches it needs the library it
#                             builds before it can go on.
BLOCKING_OK = frozenset({
    "StateStore._lock",
    "repro_torch.tune.cache._LOCK",
    "repro_torch.kernels._build._lock",
})

_RANK: Dict[str, int] = {name: i for i, name in enumerate(LOCK_HIERARCHY)}

# ---------------------------------------------------------------------------
# noqa handling (shared with repro_torch.analysis.lint)
# ---------------------------------------------------------------------------

NOQA_RE = re.compile(r"#\s*noqa:\s*(ANL\d{3}(?:\s*,\s*ANL\d{3})*)")


def noqa_codes(source_lines: Sequence[str], line: int) -> Set[str]:
    """The ANL codes suppressed on `line` (1-indexed) of the source."""
    if 1 <= line <= len(source_lines):
        m = NOQA_RE.search(source_lines[line - 1])
        if m:
            return {c.strip() for c in m.group(1).split(",")}
    return set()


def suppressed(code: str, codes: Set[str]) -> bool:
    """Is a finding with `code` suppressed by the noqa set `codes`?
    Honors `ALIASES` in both directions (`# noqa: ANL002` mutes ANL006)."""
    if code in codes:
        return True
    return any(ALIASES.get(c) == code for c in codes)


# ---------------------------------------------------------------------------
# model dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConcurrencyFinding:
    path: str
    line: int
    code: str
    message: str

    def describe(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LockDef:
    """One lock object the repo creates: canonical name, primitive kind,
    and the definition site."""
    name: str
    kind: str  # "lock" | "rlock" | "condition"
    path: str
    line: int


@dataclasses.dataclass(frozen=True)
class Acquisition:
    """One acquisition site: the lock taken, where, and what was held."""
    lock: str
    path: str
    line: int
    held: Tuple[str, ...]


@dataclasses.dataclass
class ConcurrencyModel:
    """The whole-repo lock model the findings are derived from."""
    defs: Dict[str, LockDef] = dataclasses.field(default_factory=dict)
    acquisitions: List[Acquisition] = dataclasses.field(default_factory=list)
    # edge (held -> acquired) -> every site that witnesses it
    edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = dataclasses.field(
        default_factory=dict)
    findings: List[ConcurrencyFinding] = dataclasses.field(
        default_factory=list)


# ---------------------------------------------------------------------------
# pass 1: lock definitions
# ---------------------------------------------------------------------------

_FACTORY_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "BoundedSemaphore": "lock",
    "Semaphore": "lock",
}

_GUARD_EXEMPT_FUNCS = {"__init__", "__new__", "__post_init__"}

# attribute names treated as locks even without a visible definition
_LOCKISH = re.compile(r"lock|mutex|_cv$|cond|sem", re.IGNORECASE)

_MUTATING_METHODS = {
    "append", "appendleft", "extend", "insert", "add", "remove", "discard",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "move_to_end", "sort", "reverse",
}


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _module_qual(relpath: str) -> str:
    """'repro_torch/tune/cache.py' -> 'repro_torch.tune.cache' (best
    effort)."""
    p = relpath.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    return p.strip("/").replace("/", ".")


def _lock_factory_kind(value: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, explicit_name) if `value` constructs a lock.

    Recognizes `threading.Lock()` / `Lock()` / `RLock()` / `Condition()`
    and `lockdep.named_lock("canonical.name", kind=...)` (whose first
    argument IS the canonical name)."""
    if not isinstance(value, ast.Call):
        return None
    dotted = _dotted(value.func) or ""
    leaf = dotted.rsplit(".", 1)[-1]
    if leaf == "named_lock":
        name = None
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            name = value.args[0].value
        kind = "lock"
        for kw in value.keywords:
            if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                kind = str(kw.value.value)
        return kind, name
    if leaf in _FACTORY_KINDS and (dotted == leaf
                                   or dotted == f"threading.{leaf}"):
        return _FACTORY_KINDS[leaf], None
    return None


class _DefCollector(ast.NodeVisitor):
    """Finds every lock definition in one module: `self.X = Lock()` inside
    a class, `NAME = Lock()` at module scope, and `named_lock(...)`
    wrappers (which carry their canonical name explicitly)."""

    def __init__(self, relpath: str):
        self.relpath = relpath
        self.modqual = _module_qual(relpath)
        self._class_stack: List[str] = []
        self._func_depth = 0
        # (class, attr) -> LockDef ; (modqual, NAME) -> LockDef
        self.class_defs: Dict[Tuple[str, str], LockDef] = {}
        self.module_defs: Dict[Tuple[str, str], LockDef] = {}

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_func(self, node) -> None:
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func
    visit_Lambda = _visit_func

    def _record(self, target: ast.AST, value: ast.AST, line: int) -> None:
        got = _lock_factory_kind(value)
        if got is None:
            return
        kind, explicit = got
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self" and self._class_stack):
            cls = self._class_stack[-1]
            name = explicit or f"{cls}.{target.attr}"
            self.class_defs[(cls, target.attr)] = LockDef(
                name, kind, self.relpath, line)
        elif isinstance(target, ast.Name) and self._func_depth == 0:
            name = explicit or f"{self.modqual}.{target.id}"
            self.module_defs[(self.modqual, target.id)] = LockDef(
                name, kind, self.relpath, line)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record(t, node.value, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(node.target, node.value, node.lineno)
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# pass 2: per-function lock walking
# ---------------------------------------------------------------------------

# call leaves that block regardless of receiver
_BLOCKING_LEAVES = {
    "result",             # concurrent.futures.Future.result
    "synchronize",        # torch.cuda.synchronize, event/stream sync
    "communicate",        # subprocess.Popen.communicate
    "read_text", "write_text", "read_bytes", "write_bytes",  # pathlib I/O
    "urlopen",
}
# dotted names that block
_BLOCKING_DOTTED = {
    "time.sleep",
    "torch.save", "torch.load",
    "subprocess.run", "subprocess.check_call", "subprocess.check_output",
    "json.dump", "json.load",
    "np.savez", "numpy.savez", "np.load", "numpy.load",
    "pickle.dump", "pickle.load",
    "os.replace", "os.rename", "os.fdopen", "os.makedirs",
    "shutil.rmtree", "shutil.copy", "shutil.copytree", "shutil.move",
}
# bare callables that block
_BLOCKING_BARE = {"open", "input"}


@dataclasses.dataclass
class _Access:
    kind: str  # "read" | "write"
    line: int
    held: Tuple[str, ...]
    func: Optional[str]
    exempt: bool


def _module_global_names(tree: ast.Module) -> Set[str]:
    """Names bound by assignment at module top level — the only names the
    guard inference may treat as shared module globals."""
    out: Set[str] = set()

    def targets(node: ast.AST) -> None:
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                targets(e)

    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                targets(t)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets(stmt.target)
    return out


def _scope_locals(node) -> Set[str]:
    """Names local to a function scope: parameters plus every name bound
    anywhere in its immediate body (Python's whole-function local rule).
    Nested defs/lambdas are separate scopes and are not descended into."""
    locs: Set[str] = set()
    args = getattr(node, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            locs.add(a.arg)
        if args.vararg:
            locs.add(args.vararg.arg)
        if args.kwarg:
            locs.add(args.kwarg.arg)

    def scan(n: ast.AST) -> None:
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef)):
                    locs.add(child.name)
                continue
            if isinstance(child, ast.Name) and isinstance(
                    child.ctx, (ast.Store, ast.Del)):
                locs.add(child.id)
            elif isinstance(child, ast.ExceptHandler) and child.name:
                locs.add(child.name)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                for alias in child.names:
                    locs.add((alias.asname or alias.name).split(".")[0])
            scan(child)

    body = getattr(node, "body", None)
    if isinstance(body, list):
        for stmt in body:
            scan(stmt)
    return locs


class _FileWalker(ast.NodeVisitor):
    """Walks one module with a held-lock stack, collecting acquisitions,
    ANL007 findings, and the attribute accesses guard inference consumes."""

    def __init__(self, relpath: str,
                 class_defs: Dict[Tuple[str, str], LockDef],
                 module_defs: Dict[Tuple[str, str], LockDef],
                 attr_owners: Dict[str, Set[str]],
                 module_globals: Set[str]):
        self.relpath = relpath
        self.modqual = _module_qual(relpath)
        self.class_defs = class_defs
        self.module_defs = module_defs
        self.attr_owners = attr_owners
        self.module_globals = module_globals
        self._class_stack: List[str] = []
        self._func_stack: List[str] = []
        # per-function (locals, names declared `global`)
        self._scope_stack: List[Tuple[Set[str], Set[str]]] = []
        self._held: List[str] = []
        self.acquisitions: List[Acquisition] = []
        self.edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
        self.blocking: List[ConcurrencyFinding] = []
        # ("class", C) or ("module", modqual) -> attr -> [_Access]
        self.accesses: Dict[Tuple[str, str], Dict[str, List[_Access]]] = {}

    # -- helpers -----------------------------------------------------------

    def _func(self) -> Optional[str]:
        return self._func_stack[-1] if self._func_stack else None

    def _exempt_func(self) -> bool:
        f = self._func()
        if f is None:  # module scope: definitions, not shared mutation
            return True
        return f in _GUARD_EXEMPT_FUNCS or f.endswith("_locked")

    def _resolve_lock(self, node: ast.AST) -> Optional[str]:
        """Canonical lock name for an acquisition expression, or None if
        the expression is not a known lock."""
        if isinstance(node, ast.Name):
            d = self.module_defs.get((self.modqual, node.id))
            return d.name if d else None
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            attr = node.attr
            if node.value.id == "self" and self._class_stack:
                cls = self._class_stack[-1]
                d = self.class_defs.get((cls, attr))
                if d:
                    return d.name
                owners = self.attr_owners.get(attr, set())
                if len(owners) == 1:
                    return f"{next(iter(owners))}.{attr}"
                if _LOCKISH.search(attr):
                    # no visible definition (partial source, lock injected
                    # by a factory) but the name says lock: still model the
                    # acquisition so guard inference works on snippets
                    return f"{cls}.{attr}"
                return None
            owners = self.attr_owners.get(attr, set())
            if len(owners) == 1:
                return f"{next(iter(owners))}.{attr}"
            if len(owners) > 1:
                return f"*.{attr}"  # merged lock class (conservative)
        return None

    def _lock_kind(self, name: str) -> Optional[str]:
        for d in self.class_defs.values():
            if d.name == name:
                return d.kind
        for d in self.module_defs.values():
            if d.name == name:
                return d.kind
        return None

    def _note_acquire(self, name: str, node: ast.AST) -> None:
        site = (self.relpath, node.lineno)
        self.acquisitions.append(
            Acquisition(name, self.relpath, node.lineno, tuple(self._held)))
        for held in self._held:
            if held == name and self._lock_kind(name) == "rlock":
                continue  # re-entrant by construction
            self.edges.setdefault((held, name), []).append(site)

    # -- scope tracking ----------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_func(self, node) -> None:
        # a nested def's body does not run under the enclosing with
        saved, self._held = self._held, []
        self._func_stack.append(getattr(node, "name", "<lambda>"))
        self._scope_stack.append((_scope_locals(node), set()))
        self.generic_visit(node)
        self._scope_stack.pop()
        self._func_stack.pop()
        self._held = saved

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func
    visit_Lambda = _visit_func

    def visit_Global(self, node: ast.Global) -> None:
        if self._scope_stack:
            self._scope_stack[-1][1].update(node.names)

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            self.visit(item.context_expr)  # attr reads inside the expr
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
            name = self._resolve_lock(item.context_expr)
            if name is not None:
                self._note_acquire(name, item.context_expr)
                self._held.append(name)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        if pushed:
            del self._held[-pushed:]

    # -- rules -------------------------------------------------------------

    def _blocking_finding(self, node: ast.Call, what: str) -> None:
        self.blocking.append(ConcurrencyFinding(
            self.relpath, node.lineno, "ANL007",
            f"blocking call `{what}` while holding "
            f"{' -> '.join(self._held)}: every thread behind the lock "
            f"stalls on this operation (move it outside the critical "
            f"section, or declare the lock in BLOCKING_OK if serializing "
            f"this is its documented job)"))

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        dotted = _dotted(func) or ""
        leaf = dotted.rsplit(".", 1)[-1] if dotted else ""

        # acquire()/release() outside a with-statement
        if isinstance(func, ast.Attribute) and func.attr in ("acquire",
                                                             "release"):
            name = self._resolve_lock(func.value)
            if name is not None:
                if func.attr == "acquire":
                    self._note_acquire(name, node)
                    self._held.append(name)
                else:
                    for i in range(len(self._held) - 1, -1, -1):
                        if self._held[i] == name:
                            del self._held[i]
                            break
                self.generic_visit(node)
                return

        # ANL007: blocking work under a lock
        if self._held and not all(h in BLOCKING_OK for h in self._held):
            receiver = (self._resolve_lock(func.value)
                        if isinstance(func, ast.Attribute) else None)
            if leaf == "wait" and receiver is not None \
                    and receiver in self._held:
                pass  # cond.wait() on the held condition: the CV pattern
            elif dotted in _BLOCKING_DOTTED:
                self._blocking_finding(node, dotted)
            elif dotted in _BLOCKING_BARE:
                self._blocking_finding(node, dotted)
            elif leaf in _BLOCKING_LEAVES and isinstance(func, ast.Attribute):
                self._blocking_finding(node, dotted or leaf)
            elif leaf == "wait" and isinstance(func, ast.Attribute):
                self._blocking_finding(node, dotted or leaf)
            elif (leaf == "get" and isinstance(func, ast.Attribute)
                  and "queue" in (_dotted(func.value) or "").lower()):
                self._blocking_finding(node, dotted or leaf)

        # attribute-mutating method calls count as writes for inference
        if isinstance(func, ast.Attribute) and func.attr in _MUTATING_METHODS:
            self._note_attr(func.value, "write")

        self.generic_visit(node)

    # -- attribute accesses (guard inference input) ------------------------

    def _owner_key(self, node: ast.AST) -> Optional[Tuple[Tuple[str, str], str]]:
        """((scope-kind, scope-name), attr) for self.X; module-global NAME.

        A bare name only counts as a module global if it is bound at
        module top level AND (per Python's scoping rules) not shadowed by
        a local of the enclosing function — unless declared ``global``."""
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self" and self._class_stack):
            return ("class", self._class_stack[-1]), node.attr
        if isinstance(node, ast.Name) and node.id in self.module_globals:
            for locs, gdecls in self._scope_stack:
                if node.id in gdecls:
                    continue
                if node.id in locs:
                    return None  # a function local shadows the global
            return ("module", self.modqual), node.id
        return None

    def _note_attr(self, node: ast.AST, kind: str,
                   line: Optional[int] = None) -> None:
        got = self._owner_key(node)
        if got is None:
            return
        owner, attr = got
        self.accesses.setdefault(owner, {}).setdefault(attr, []).append(
            _Access(kind, line or node.lineno, tuple(self._held),
                    self._func(), self._exempt_func()))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
        self._note_attr(node, kind)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self._models[k] = v  /  _MEMO[key] = v  are writes to the mapping
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self._note_attr(node.value, "write", line=node.lineno)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if not self._func_stack:
            return  # module scope: definitions, not shared mutation
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self._note_attr(node, "write")
        elif isinstance(node.ctx, ast.Load):
            self._note_attr(node, "read")


# ---------------------------------------------------------------------------
# guard inference (ANL006) — shared with repro_torch.analysis.lint
# ---------------------------------------------------------------------------

def _infer_findings(relpath: str,
                    accesses: Dict[Tuple[str, str], Dict[str, List[_Access]]],
                    ) -> List[ConcurrencyFinding]:
    findings: List[ConcurrencyFinding] = []
    for (scope_kind, scope_name), attrs in accesses.items():
        for attr, acc in attrs.items():
            guarded_writes = [a for a in acc
                              if a.kind == "write" and a.held and not a.exempt]
            if not guarded_writes:
                continue  # not shared mutable state under a lock: untracked
            guards = sorted({h for a in guarded_writes for h in a.held})
            gsite = guarded_writes[0]
            what = f"self.{attr}" if scope_kind == "class" else attr
            flagged_lines: Set[int] = set()
            for a in acc:
                if a.held or a.exempt:
                    continue
                # one finding per line: a mutating-method call records both
                # the write and the receiver read at the same site
                if a.line in flagged_lines:
                    continue
                flagged_lines.add(a.line)
                findings.append(ConcurrencyFinding(
                    relpath, a.line, "ANL006",
                    f"`{what}` {a.kind} without a lock, but it is written "
                    f"under {' / '.join(f'`{g}`' for g in guards)} "
                    f"(e.g. line {gsite.line}) — lock-free access races "
                    f"the guarded writers"))
    findings.sort(key=lambda f: f.line)
    return findings


def guard_findings(source: str, relpath: str) -> List[ConcurrencyFinding]:
    """ANL006 findings for one module (noqa already applied). This is the
    generalized ANL002: guards are INFERRED from where attributes are
    written under locks, not hardcoded per attribute."""
    model = analyze_sources([(relpath, source)])
    return [f for f in model.findings if f.code == "ANL006"]


# ---------------------------------------------------------------------------
# cycles + hierarchy (ANL005)
# ---------------------------------------------------------------------------

def _sccs(nodes: Sequence[str],
          adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan SCCs, iterative (analysis code must not recurse on repo
    size)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work: List[Tuple[str, Iterable[str]]] = [(root, iter(adj.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _cycle_findings(edges: Dict[Tuple[str, str], List[Tuple[str, int]]],
                    ) -> List[ConcurrencyFinding]:
    findings: List[ConcurrencyFinding] = []
    adj: Dict[str, Set[str]] = {}
    nodes: List[str] = []
    for (a, b) in edges:
        if a not in adj:
            adj[a] = set()
            nodes.append(a)
        if b not in adj:
            adj[b] = set()
            nodes.append(b)
        adj[a].add(b)

    def _fmt(a: str, b: str) -> str:
        path, line = sorted(edges[(a, b)])[0]
        return f"{a} -> {b} ({path}:{line})"

    # self-deadlock: non-reentrant lock re-acquired while held
    for (a, b), sites in sorted(edges.items()):
        if a == b:
            path, line = sorted(sites)[0]
            findings.append(ConcurrencyFinding(
                path, line, "ANL005",
                f"`{a}` acquired while already held by the same thread "
                f"(non-reentrant lock: guaranteed self-deadlock)"))

    # cycles across locks
    for comp in _sccs(nodes, adj):
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        cyc_edges = sorted((a, b) for (a, b) in edges
                           if a in comp_set and b in comp_set and a != b)
        detail = "; ".join(_fmt(a, b) for a, b in cyc_edges)
        path, line = sorted(edges[cyc_edges[0]])[0]
        findings.append(ConcurrencyFinding(
            path, line, "ANL005",
            f"lock-order cycle between {', '.join(sorted(comp_set))}: "
            f"{detail} — two threads interleaving these acquisitions "
            f"deadlock"))

    # declared-hierarchy inversions (no cycle needed: the declared order
    # is the contract even before the reverse edge ships)
    for (a, b), sites in sorted(edges.items()):
        ra, rb = _RANK.get(a), _RANK.get(b)
        if ra is not None and rb is not None and rb < ra:
            path, line = sorted(sites)[0]
            findings.append(ConcurrencyFinding(
                path, line, "ANL005",
                f"`{b}` acquired while holding `{a}` inverts the declared "
                f"lock hierarchy (LOCK_HIERARCHY ranks {b} before {a})"))
    return findings


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def analyze_sources(sources: Sequence[Tuple[str, str]]) -> ConcurrencyModel:
    """Build the lock model and findings for (relpath, source) pairs.
    Definitions are collected across ALL files first, so `entry.lock` in
    one module resolves against `_Entry.__init__` in another."""
    model = ConcurrencyModel()
    parsed: List[Tuple[str, str, ast.AST]] = []
    class_defs: Dict[Tuple[str, str], LockDef] = {}
    module_defs: Dict[Tuple[str, str], LockDef] = {}
    for relpath, source in sources:
        relpath = relpath.replace("\\", "/")
        try:
            tree = ast.parse(source, filename=relpath)
        except SyntaxError as exc:
            model.findings.append(ConcurrencyFinding(
                relpath, exc.lineno or 0, "ANL000",
                f"syntax error: {exc.msg}"))
            continue
        parsed.append((relpath, source, tree))
        coll = _DefCollector(relpath)
        coll.visit(tree)
        class_defs.update(coll.class_defs)
        module_defs.update(coll.module_defs)

    attr_owners: Dict[str, Set[str]] = {}
    for (cls, attr) in class_defs:
        attr_owners.setdefault(attr, set()).add(cls)
    for d in list(class_defs.values()) + list(module_defs.values()):
        model.defs[d.name] = d

    raw: List[ConcurrencyFinding] = []
    for relpath, source, tree in parsed:
        walker = _FileWalker(relpath, class_defs, module_defs, attr_owners,
                             _module_global_names(tree))
        walker.visit(tree)
        model.acquisitions.extend(walker.acquisitions)
        for edge, sites in walker.edges.items():
            model.edges.setdefault(edge, []).extend(sites)
        raw.extend(walker.blocking)
        raw.extend(_infer_findings(relpath, walker.accesses))

    raw.extend(_cycle_findings(model.edges))

    # noqa filtering, per file
    lines_by_path = {relpath: source.splitlines()
                     for relpath, source, _ in parsed}
    for f in raw:
        codes = noqa_codes(lines_by_path.get(f.path, ()), f.line)
        if not suppressed(f.code, codes):
            model.findings.append(f)
    model.findings.sort(key=lambda f: (f.path, f.line, f.code))
    return model


def analyze_paths(paths: Optional[Iterable[pathlib.Path]] = None,
                  root: Optional[pathlib.Path] = None) -> ConcurrencyModel:
    """Analyze a set of files (default: every .py under src/repro_torch —
    the same walk as `repro_torch.analysis.lint.lint_paths`)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[2]
    if paths is None:
        paths = sorted((root / "repro_torch").rglob("*.py"))
    sources: List[Tuple[str, str]] = []
    for path in paths:
        resolved = pathlib.Path(path).resolve()
        try:
            rel = str(resolved.relative_to(root))
        except ValueError:  # outside src/ (e.g. a fixture): report as given
            rel = str(path)
        sources.append((rel, resolved.read_text(encoding="utf-8")))
    return analyze_sources(sources)
