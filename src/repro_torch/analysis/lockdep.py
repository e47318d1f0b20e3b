"""Runtime lock-order verification (lockdep) for the port (its own copy of
`repro.analysis.lockdep`, stdlib only).

The static pass (`repro_torch.analysis.concurrency`) sees every acquisition
the AST shows; it cannot see orders that only materialize through dynamic
dispatch, callbacks, or cross-object calls. This module closes that gap
the way the kernel's lockdep does: instrument the lock primitives, record
the acquisition-order digraph each thread actually performs, and fail the
FIRST time an edge inverts either the declared hierarchy
(`concurrency.LOCK_HIERARCHY`) or an order some thread already observed
(the AB/BA pattern) — instead of waiting for the scheduler to interleave
two threads into the real deadlock.

Two entry points:

* ``watch()`` — opt-in context manager that monkeypatches
  ``threading.Lock/RLock/Condition`` so every lock **created under the
  repo root while watching** is wrapped. Locks created by stdlib or torch
  internals (Future conditions, Thread events) are left untouched — the
  creation frame's file decides. The port's serve tests run under
  ``watch()`` through an autouse fixture in their files, so every
  fault-injection and load test doubles as a deadlock check.
* ``named_lock(name, kind=...)`` — replacement for module-level
  ``threading.Lock()``s created at import time (before any ``watch()``
  could patch the factory). The wrapper carries its canonical hierarchy
  name permanently and participates in whichever ``watch()`` is active
  when it is acquired. `repro_torch.tune.cache`, `repro_torch.tune.
  autotune`, `repro_torch.kernels._build` and `repro_torch.core.psi_stats`
  route their process locks through this.

Checks are performed BEFORE the underlying acquire, so a genuine ABBA
interleaving raises :class:`LockOrderViolation` instead of hanging the
test run. Violations are also appended to the recorder — worker threads
that funnel exceptions into Futures (GPServer's serve loop) cannot
swallow the evidence; the fixtures assert the recorder is clean at
teardown.

Overhead when no ``watch()`` is active is one attribute read per
acquisition on wrapped locks, and zero on unwrapped ones.
"""
from __future__ import annotations

import linecache
import pathlib
import re
import sys
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.concurrency import LOCK_HIERARCHY

__all__ = [
    "LockOrderViolation",
    "Recorder",
    "watch",
    "named_lock",
    "current_recorder",
]

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
_SRC_ROOT = _REPO_ROOT / "src"
_THIS_FILE = str(pathlib.Path(__file__).resolve())

_RANK: Dict[str, int] = {name: i for i, name in enumerate(LOCK_HIERARCHY)}

# genuine primitives, captured before any watch() can patch the module
_RawLock = threading.Lock
_RawRLock = threading.RLock
_RawCondition = threading.Condition


class LockOrderViolation(RuntimeError):
    """A lock acquisition inverted the declared hierarchy or an
    already-observed acquisition order."""

    def __init__(self, message: str, *, lock: str, held: Tuple[str, ...]):
        super().__init__(message)
        self.lock = lock
        self.held = held


class Recorder:
    """Observed acquisition-order digraph + violations for one watch()."""

    def __init__(self, raise_on_violation: bool = True):
        self.raise_on_violation = raise_on_violation
        # (held_name, acquired_name) -> first site "thread @ file:line"
        self.edges: Dict[Tuple[str, str], str] = {}
        self.violations: List[LockOrderViolation] = []
        self.acquisitions: int = 0
        self._mu = _RawLock()

    def assert_clean(self) -> None:
        if self.violations:
            lines = "\n  ".join(str(v) for v in self.violations)
            raise AssertionError(
                f"lockdep recorded {len(self.violations)} lock-order "
                f"violation(s):\n  {lines}")

    # -- internal ----------------------------------------------------------

    def _site(self) -> str:
        f = sys._getframe(3)
        while f is not None and f.f_code.co_filename == _THIS_FILE:
            f = f.f_back
        where = (f"{pathlib.Path(f.f_code.co_filename).name}:{f.f_lineno}"
                 if f is not None else "?")
        return f"{threading.current_thread().name} @ {where}"

    def _fail(self, message: str, lock: str,
              held: Tuple[str, ...]) -> None:
        exc = LockOrderViolation(message, lock=lock, held=held)
        with self._mu:
            self.violations.append(exc)
        if self.raise_on_violation:
            raise exc

    def note_acquire(self, wrapper: "_Instrumented",
                     held: List["_Instrumented"]) -> None:
        """Check-then-record for one acquisition. Called with the
        thread's current held stack, BEFORE the underlying acquire."""
        site = self._site()
        with self._mu:
            self.acquisitions += 1
        name = wrapper.name

        # self-deadlock: non-reentrant lock already held by this thread
        if wrapper.kind == "lock" and any(w is wrapper for w in held):
            self._fail(
                f"`{name}` acquired while already held by this thread "
                f"({site}): non-reentrant lock, guaranteed self-deadlock",
                name, tuple(w.name for w in held))
            return
        if wrapper.kind != "lock" and any(w is wrapper for w in held):
            return  # re-entrant re-acquire: no new ordering information

        held_names = tuple(w.name for w in held)
        rank = _RANK.get(name)
        for h in held_names:
            if h == name:
                continue  # same-name sibling (two _Entry.locks): allowed
            # declared hierarchy
            hrank = _RANK.get(h)
            if rank is not None and hrank is not None and rank < hrank:
                self._fail(
                    f"`{name}` acquired while holding `{h}` ({site}) "
                    f"inverts the declared hierarchy "
                    f"(LOCK_HIERARCHY ranks {name} before {h})",
                    name, held_names)
                return
            # observed order (AB/BA)
            with self._mu:
                prior = self.edges.get((name, h))
            if prior is not None:
                self._fail(
                    f"`{name}` acquired while holding `{h}` ({site}), "
                    f"but the opposite order was observed earlier "
                    f"({prior}): AB/BA deadlock candidate",
                    name, held_names)
                return
        with self._mu:
            for h in held_names:
                if h != name:
                    self.edges.setdefault((h, name), site)


# the active recorder; read lock-free on the acquire fast path
_active: Optional[Recorder] = None
_watch_mu = _RawLock()

_held_local = threading.local()


def current_recorder() -> Optional[Recorder]:
    return _active


def _held_stack() -> List["_Instrumented"]:
    try:
        return _held_local.stack
    except AttributeError:
        _held_local.stack = []
        return _held_local.stack


class _Instrumented:
    """Proxy around a real Lock/RLock/Condition that reports to the
    active recorder. Transparent when no watch() is active."""

    __slots__ = ("name", "kind", "_raw")

    def __init__(self, name: str, kind: str, raw):
        self.name = name
        self.kind = kind
        self._raw = raw

    def __repr__(self) -> str:
        return f"<lockdep {self.kind} {self.name!r} {self._raw!r}>"

    # -- core protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        rec = _active
        held = _held_stack()
        if rec is not None and blocking:
            rec.note_acquire(self, held)
        got = self._raw.acquire(blocking, timeout)
        if got:
            held.append(self)
        return got

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._raw.locked()

    # -- condition protocol (delegates; wait releases the lock) -----------

    def wait(self, timeout: Optional[float] = None):
        held = _held_stack()
        idx = next((i for i in range(len(held) - 1, -1, -1)
                    if held[i] is self), None)
        if idx is not None:
            del held[idx]
        try:
            return self._raw.wait(timeout)
        finally:
            if idx is not None:
                held.append(self)  # wait() re-acquired before returning

    def wait_for(self, predicate, timeout: Optional[float] = None):
        held = _held_stack()
        idx = next((i for i in range(len(held) - 1, -1, -1)
                    if held[i] is self), None)
        if idx is not None:
            del held[idx]
        try:
            return self._raw.wait_for(predicate, timeout)
        finally:
            if idx is not None:
                held.append(self)

    def notify(self, n: int = 1) -> None:
        self._raw.notify(n)

    def notify_all(self) -> None:
        self._raw.notify_all()

    def __getattr__(self, item):
        return getattr(self._raw, item)


def named_lock(name: str, kind: str = "lock") -> _Instrumented:
    """A permanently-instrumented lock with an explicit canonical
    hierarchy name. Use for module-level locks, which are created at
    import time — before any ``watch()`` could patch the factories."""
    if kind == "lock":
        raw = _RawLock()
    elif kind == "rlock":
        raw = _RawRLock()
    elif kind == "condition":
        raw = _RawCondition()
    else:
        raise ValueError(f"unknown lock kind {kind!r}")
    return _Instrumented(name, kind, raw)


# ---------------------------------------------------------------------------
# creation-site naming for watch()-patched factories
# ---------------------------------------------------------------------------

_ASSIGN_RE = re.compile(
    r"(?:self\.(?P<attr>\w+)|(?P<global>[A-Za-z_]\w*))\s*=\s*threading\.")


def _infer_name(frame) -> Optional[str]:
    """Canonical name for a lock created at `frame`, or None when the
    creation site is outside the repo (leave the lock raw)."""
    filename = frame.f_code.co_filename
    try:
        resolved = pathlib.Path(filename).resolve()
        resolved.relative_to(_REPO_ROOT)
    except (ValueError, OSError):
        return None
    if str(resolved) == _THIS_FILE:
        return None
    line = linecache.getline(filename, frame.f_lineno).strip()
    m = _ASSIGN_RE.search(line)
    if m and m.group("attr") and "self" in frame.f_locals:
        cls = type(frame.f_locals["self"]).__name__
        return f"{cls}.{m.group('attr')}"
    if m and m.group("global"):
        try:
            mod = resolved.relative_to(_SRC_ROOT)
            qual = str(mod.with_suffix("")).replace("/", ".")
        except ValueError:
            qual = resolved.stem
        return f"{qual}.{m.group('global')}"
    try:
        rel = resolved.relative_to(_REPO_ROOT)
    except ValueError:
        rel = resolved
    return f"{rel}:{frame.f_lineno}"


def _factory(kind: str, raw_factory):
    def make(*args, **kwargs):
        if args or kwargs:  # Condition(lock=...) etc: don't second-guess
            return raw_factory(*args, **kwargs)
        name = _infer_name(sys._getframe(1))
        if name is None:
            return raw_factory()
        return _Instrumented(name, kind, raw_factory())
    return make


@contextmanager
def watch(raise_on_violation: bool = True):
    """Instrument every repo-created lock for the duration of the block.

    Yields the :class:`Recorder`; check ``recorder.violations`` (or call
    ``recorder.assert_clean()``) at exit — a violation raised inside a
    worker thread may have been routed into a Future, but it is always
    recorded.
    """
    global _active
    with _watch_mu:
        if _active is not None:
            raise RuntimeError("lockdep.watch() is already active "
                               "(nesting is not supported)")
        rec = Recorder(raise_on_violation=raise_on_violation)
        _active = rec
    patched = {
        "Lock": _factory("lock", _RawLock),
        "RLock": _factory("rlock", _RawRLock),
        "Condition": _factory("condition", _RawCondition),
    }
    saved = {k: getattr(threading, k) for k in patched}
    for k, v in patched.items():
        setattr(threading, k, v)
    try:
        yield rec
    finally:
        for k, v in saved.items():
            setattr(threading, k, v)
        with _watch_mu:
            _active = None
