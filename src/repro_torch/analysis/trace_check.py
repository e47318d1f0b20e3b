"""Eager-trace invariant checker: classify every intermediate's scaling class
(the port's counterpart of `repro.analysis.jaxpr_check`).

The streaming statistics' contract — "no grad path materializes an
O(N * M) intermediate" — is a statement about scaling, not about a byte
threshold. This module states it that way for eager PyTorch: run the
function at TWO problem sizes, record every intermediate each run makes,
pair the records of the two runs, and read each intermediate's growth
exponent off the size ratio. An (N, M) buffer is then "scaling class
O(N * M)" whatever sizes the test picked.

What is recorded, for one call ``fn(*args)`` (and its backward when
asked):

  * every op output that owns new memory, through a `TorchDispatchMode`
    (views and in-place results alias an existing buffer and are skipped);
  * every tensor autograd saves for the backward pass, through
    `torch.autograd.graph.saved_tensors_hooks`, as the storage it keeps
    alive (a checkpointed region installs its own hooks and saves only its
    inputs here, as it should; the call's own inputs live anyway and are
    not counted);

each with its op and the Python source line that made it. A backward op
run by one of autograd's own nodes has no Python frame of its own: it is
attributed to the line that created the node in the forward pass
(autograd's anomaly-mode traceback).

Eager tracing unrolls loops — a chunked pass over N makes N / chunk
copies of its body's ops, so the two sizes record different numbers of
ops. Records are therefore paired by (op, call site) — the innermost
Python frames outside torch. A site's op outputs count by their largest
buffer (each is a temporary), so a fixed-size chunk buffer reads O(1) in N
however many chunks ran; the tensors saved for backward at a site count
by their sum (all stay alive until the backward pass), so a chunk loop
that saves each chunk's activations reads as the O(N * M) it is. A call
site that exists at one size only means a size-dependent branch sits
between the two sizes; that is an `AnalysisError`, as in the reference.

Entry points, named as in the reference:

  * `scaling_report(fn, *args, axis="N", sizes=...)` — every call site with
    its scaling class, largest class first.
  * `assert_no_scaling(fn, *args, axis="N", worse_than="N*M", sizes=...)` —
    raise `ScalingViolation` (with the offending op and source line) if any
    intermediate reaches the named class within `margin`.
  * `trace_intermediates(fn, *args)` — the single-run walk
    `repro_torch.launch.memory` wraps.

Runs on any device: on CPU tensors it traces the plain versions, on CUDA
tensors the kernels' wrappers (whose scratch is recorded where it is
allocated; a kernel's own work never shows as an op).
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "AnalysisError",
    "ScalingViolation",
    "Intermediate",
    "ScalingReport",
    "trace_intermediates",
    "scaling_report",
    "scaling_class",
    "assert_no_scaling",
]

# Python frames a call site is named by: the innermost ones outside torch,
# the standard library and this module
SITE_DEPTH = 3

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_STDLIB_DIR = os.path.dirname(os.__file__) + os.sep
_THIS_FILE = os.path.abspath(__file__)
_FRAME_RE = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
# the op name of a tensor autograd saves
SAVED = "saved_for_backward"


class AnalysisError(RuntimeError):
    """The analyzer itself cannot proceed (e.g. the program changed
    structure between the two problem sizes — a size-dependent dispatch
    branch sits between them; pick sizes on the same side of it)."""


class ScalingViolation(AssertionError):
    """An intermediate reached a forbidden scaling class."""

    def __init__(self, message: str, violations: Sequence["Intermediate"]):
        super().__init__(message)
        self.violations = list(violations)


# ---------------------------------------------------------------------------
# recording one call
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Record:
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    op: str
    site: Tuple[Tuple[str, int], ...]  # (file, line) innermost first
    source: str  # "file.py:line in fn", the innermost frame
    storage: int = 0  # a saved tensor's storage (its address)


def _user_file(filename: str) -> bool:
    path = os.path.abspath(filename)
    return not (path.startswith(_TORCH_DIR) or path.startswith(_STDLIB_DIR)
                or path == _THIS_FILE or filename.startswith("<"))


def _live_frames() -> Tuple[List[Tuple[str, int, str]], bool]:
    """(the innermost user frames of this thread, whether autograd's own
    Python code comes before the first of them): the latter marks an op run
    by a backward node, or by autograd itself."""
    frames: List[Tuple[str, int, str]] = []
    f = sys._getframe(1)
    engine_first = False
    while f is not None and len(frames) < SITE_DEPTH:
        name = f.f_code.co_filename
        if _user_file(name):
            frames.append((name, f.f_lineno, f.f_code.co_name))
        elif not frames and os.sep + "autograd" + os.sep in name:
            engine_first = True
        f = f.f_back
    return frames, engine_first


def _node_frames() -> List[Tuple[str, int, str]]:
    """The forward-pass creation frames of the autograd node running now
    (anomaly mode's traceback), innermost first; [] outside a backward."""
    node = torch._C._current_autograd_node()
    if node is None:
        return []
    stack = node.metadata.get("traceback_") or []
    frames = []
    for entry in reversed(stack):
        m = _FRAME_RE.search(entry)
        if m and _user_file(m.group(1)):
            frames.append((m.group(1), int(m.group(2)), m.group(3)))
            if len(frames) == SITE_DEPTH:
                break
    return frames


def _site() -> Tuple[Tuple[Tuple[str, int], ...], str]:
    frames, engine_first = _live_frames()
    if engine_first or not frames:
        node_frames = _node_frames()
        if node_frames:
            f, line, fn = node_frames[0]
            return (tuple((a, b) for a, b, _ in node_frames),
                    f"{os.path.basename(f)}:{line} in {fn} (backward: "
                    f"{torch._C._current_autograd_node().name()})")
    if not frames:
        return (), "<unknown>"
    f, line, fn = frames[0]
    return (tuple((a, b) for a, b, _ in frames),
            f"{os.path.basename(f)}:{line} in {fn}")


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def _record(t: torch.Tensor, op: str, nbytes: Optional[int] = None,
            storage: int = 0) -> _Record:
    site, source = _site()
    return _Record(tuple(int(d) for d in t.shape), str(t.dtype).removeprefix("torch."),
                   int(t.numel()) * t.element_size() if nbytes is None else nbytes,
                   op, site, source, storage)


class _Recorder(TorchDispatchMode):
    """Records every op output that owns new memory."""

    def __init__(self, out: List[_Record]):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        outs = result if isinstance(result, (list, tuple)) else (result,)
        for i, t in enumerate(outs):
            aliased = i < len(returns) and returns[i].alias_info is not None
            if isinstance(t, torch.Tensor) and not aliased:
                self.out.append(_record(t, str(func.overloadpacket.__name__)))
        return result


def _float_leaves(tree) -> List[torch.Tensor]:
    return [t for t in _tensors(tree) if t.is_floating_point()]


def _with_grad(tree):
    """`tree` with every floating-point tensor a fresh leaf that requires
    grad (the inputs the backward pass differentiates against)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().requires_grad_(True) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _with_grad(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_grad(v) for v in tree)
    return tree


def _run(fn: Callable, args, kwargs, backward: bool) -> List[_Record]:
    out: List[_Record] = []
    if backward:
        args = _with_grad(args)
    inputs = {t.untyped_storage().data_ptr() for t in _tensors(args)}

    def pack(t):
        # what a saved tensor keeps alive is its whole storage; the inputs'
        # storages live anyway
        ptr = t.untyped_storage().data_ptr()
        if ptr not in inputs:
            out.append(_record(t, SAVED, t.untyped_storage().nbytes(), ptr))
        return t

    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        with _Recorder(out), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            result = fn(*args, **kwargs)
            if backward:
                loss = _tensors(result)[0]
                leaves = [t for t in _float_leaves(args) if t.requires_grad]
                torch.autograd.grad(loss, leaves, allow_unused=True)
    return out


def trace_intermediates(fn: Callable, *args, backward: bool = False,
                        **kwargs) -> List[Tuple[Tuple[int, ...], str, int, str, str]]:
    """One-run walk: [(shape, dtype, nbytes, op, source)] for every
    intermediate of ``fn(*args, **kwargs)`` (and, with `backward`, of the
    reverse pass of its first output against every floating-point input)."""
    return [(r.shape, r.dtype, r.nbytes, r.op, r.source)
            for r in _run(fn, args, kwargs, backward)]


# ---------------------------------------------------------------------------
# two-size scaling classification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Intermediate:
    """One call site's largest intermediate with its scaling class along
    the grown axis."""

    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    op: str
    source: str
    growth_exp: int  # p in elements ~ coeff * axis^p
    coeff: float     # elements / axis^p at the base size
    label: str       # human class label, e.g. "O(N*M)"

    def describe(self) -> str:
        return (f"{self.label:<12} {self.shape!s:<20} {self.dtype:<8} "
                f"{self.nbytes / 1e6:>10.2f} MB  {self.op}  [{self.source}]")


@dataclasses.dataclass(frozen=True)
class ScalingReport:
    """The call sites of one traced function, worst class first."""

    axis: str
    axis_size: int
    sizes: Dict[str, int]
    entries: Tuple[Intermediate, ...]

    @property
    def worst(self) -> Optional[Intermediate]:
        return self.entries[0] if self.entries else None

    @property
    def worst_class(self) -> str:
        return self.entries[0].label if self.entries else "O(1)"

    def format(self, top: int = 10) -> str:
        head = (f"scaling report along axis {self.axis!r} "
                f"({self.axis} = {self.axis_size}, "
                f"{', '.join(f'{k} = {v}' for k, v in self.sizes.items() if k != self.axis)})")
        return "\n".join([head] + [e.describe() for e in self.entries[:top]])


def _class_label(axis: str, exp: int, coeff: float,
                 sizes: Dict[str, int]) -> str:
    """Express the per-axis coefficient through the named sizes: coeff ~ M
    becomes "O(N*M)", coeff ~ M*Q becomes "O(N*M*Q)". Falls back to the
    numeric coefficient when no product of named sizes is within 2x."""
    axis_part = [] if exp == 0 else [axis if exp == 1 else f"{axis}^{exp}"]
    if exp == 0 and coeff <= 2.0:
        return "O(1)"
    names = [(k, v) for k, v in sizes.items() if k != axis and v > 1]
    best: Tuple[float, List[str]] = (abs(math.log(max(coeff, 1.0))), [])
    for mask in range(3 ** len(names)):
        prod, parts, m = 1.0, [], mask
        for name, value in names:
            power, m = m % 3, m // 3
            if power:
                prod *= value ** power
                parts.append(name if power == 1 else f"{name}^{power}")
        err = abs(math.log(max(coeff, 1.0) / prod))
        if err < best[0] - 1e-9:
            best = (err, parts)
    if best[0] <= math.log(2.0):
        return "O(" + ("*".join(axis_part + best[1]) or "1") + ")"
    if exp == 0:
        return f"O({coeff:.0f})"
    return "O(" + "*".join(axis_part + [f"{coeff:.0f}"]) + ")"


def _grow(tree, axis_size: int, factor: int):
    """`tree` with every tensor dimension equal to `axis_size` repeated
    `factor` times along it (the data duplicated, so values stay what a
    caller would pass)."""
    if isinstance(tree, torch.Tensor):
        out = tree.detach()
        for dim, d in enumerate(tree.shape):
            if d == axis_size:
                out = torch.cat([out] * factor, dim=dim)
        return out.contiguous() if out is not tree else tree
    if isinstance(tree, dict):
        return {k: _grow(v, axis_size, factor) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_grow(v, axis_size, factor) for v in tree)
    return tree


def _by_site(records: List[_Record]) -> Dict[tuple, _Record]:
    """One record per (op, call site): an op output's largest (a
    temporary, freed before the next one at that site is made), and the
    SUM of the storages saved for the backward pass there, each once (all
    of them live until the backward pass frees them)."""
    best: Dict[tuple, _Record] = {}
    seen = set()
    for r in records:
        key = (r.op, r.site)
        old = best.get(key)
        if r.op == SAVED:
            if (key, r.storage) in seen:
                continue
            seen.add((key, r.storage))
        if old is None:
            best[key] = r
        elif r.op == SAVED:
            best[key] = dataclasses.replace(old, nbytes=old.nbytes + r.nbytes)
        elif r.nbytes > old.nbytes:
            best[key] = r
    return best


def scaling_report(fn: Callable, *args, axis: str = "N",
                   sizes: Optional[Dict[str, int]] = None, factor: int = 2,
                   backward: bool = False) -> ScalingReport:
    """Classify every intermediate of ``fn(*args)`` by how it scales along
    `axis`.

    `sizes` names the problem dimensions, e.g. ``{"N": 4096, "M": 32}``; it
    must contain `axis`. The function runs at the given arguments and again
    with every tensor dimension equal to ``sizes[axis]`` grown by `factor`
    (the data repeated along it); each call site's growth exponent is read
    off the size ratio of its largest buffer. Dimensions that
    coincidentally equal ``sizes[axis]`` are grown too — pick sizes where
    the streaming axis is unambiguous. `backward` adds the reverse pass of
    the first output against every floating-point input.
    """
    if sizes is None or axis not in sizes:
        raise ValueError(
            f"sizes= must name the grown axis, e.g. sizes={{{axis!r}: <N>, 'M': <M>}}")
    axis_size = int(sizes[axis])
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    base = _by_site(_run(fn, args, {}, backward))
    grown = _by_site(_run(fn, _grow(args, axis_size, factor), {}, backward))
    only = sorted({r.source + f" ({r.op})" for k, r in
                   list(base.items()) + list(grown.items())
                   if (k in base) != (k in grown)})
    if only:
        raise AnalysisError(
            f"program structure changed between {axis} = {axis_size} and "
            f"{axis} = {factor * axis_size}: {len(only)} call site(s) ran at "
            f"one size only (e.g. {only[0]}) — a size-dependent dispatch "
            f"branch sits between the two sizes; pick sizes on the same "
            f"side of it")
    log_factor = math.log(factor)
    entries = []
    for key, r1 in base.items():
        r2 = grown[key]
        s1 = max(r1.nbytes // _itemsize(r1), 1)
        s2 = max(r2.nbytes // _itemsize(r2), 1)
        exp = max(int(round(math.log(s2 / s1) / log_factor)), 0)
        coeff = s1 / float(axis_size ** exp)
        entries.append(Intermediate(
            shape=r1.shape, dtype=r1.dtype, nbytes=r1.nbytes, op=r1.op,
            source=r1.source, growth_exp=exp, coeff=coeff,
            label=_class_label(axis, exp, coeff, sizes)))
    entries.sort(key=lambda e: (e.growth_exp, e.coeff, e.nbytes), reverse=True)
    return ScalingReport(axis=axis, axis_size=axis_size, sizes=dict(sizes),
                         entries=tuple(entries))


def _itemsize(r: _Record) -> int:
    return max(torch.empty((), dtype=getattr(torch, r.dtype)).element_size(), 1)


def scaling_class(fn: Callable, *args, axis: str = "N",
                  sizes: Optional[Dict[str, int]] = None, factor: int = 2,
                  backward: bool = False) -> str:
    """The worst scaling-class label of ``fn(*args)`` along `axis`."""
    return scaling_report(fn, *args, axis=axis, sizes=sizes, factor=factor,
                          backward=backward).worst_class


# ---------------------------------------------------------------------------
# the named-bound assertion the tests state their guarantee through
# ---------------------------------------------------------------------------

def _parse_bound(worse_than: str, axis: str,
                 sizes: Dict[str, int]) -> Tuple[int, float]:
    """Parse "N*M" / "N" / "N^2" / "N*M*Q" into (axis exponent, coefficient
    in elements). Every non-axis token must be a named size or an integer."""
    exp, coeff = 0, 1.0
    for token in worse_than.replace(" ", "").split("*"):
        if not token:
            continue
        name, _, power = token.partition("^")
        p = int(power) if power else 1
        if name == axis:
            exp += p
        elif name in sizes:
            coeff *= float(sizes[name]) ** p
        elif name.isdigit():
            coeff *= float(name) ** p
        else:
            raise ValueError(
                f"worse_than={worse_than!r} names {name!r}, which is neither "
                f"the axis {axis!r} nor in sizes={sorted(sizes)}")
    if exp == 0:
        raise ValueError(
            f"worse_than={worse_than!r} must involve the grown axis {axis!r}")
    return exp, coeff


def assert_no_scaling(fn: Callable, *args, axis: str = "N",
                      worse_than: str = "N*M",
                      sizes: Optional[Dict[str, int]] = None,
                      margin: float = 4.0, factor: int = 2,
                      budget_bytes: Optional[int] = None,
                      backward: bool = False) -> ScalingReport:
    """Assert no intermediate of ``fn(*args)`` reaches the scaling class
    `worse_than` along `axis`.

    An intermediate violates the bound when its growth exponent along `axis`
    exceeds the bound's, or when it matches the bound's exponent and its
    per-``axis^p`` coefficient comes within `margin` of the bound's — the
    default ``margin=4.0`` with ``worse_than="N*M"`` reads "nothing within
    4x of an (N, M) array". ``margin < 1`` loosens the bound instead:
    ``margin=0.5`` allows up to a 2x-the-bound buffer (for ops whose OUTPUT
    cotangent is itself (N, M)). `budget_bytes`, when given, additionally
    caps every intermediate's absolute size. Both bounds are checked
    before either size runs out of arguments (the sizes are validated
    first). Returns the full `ScalingReport` on success.
    """
    if sizes is None or axis not in sizes:
        raise ValueError(
            f"sizes= must name the grown axis, e.g. sizes={{{axis!r}: <N>, 'M': <M>}}")
    bound_exp, bound_coeff = _parse_bound(worse_than, axis, dict(sizes))
    rep = scaling_report(fn, *args, axis=axis, sizes=sizes, factor=factor,
                         backward=backward)
    violations = [
        e for e in rep.entries
        if e.growth_exp > bound_exp
        or (e.growth_exp == bound_exp and e.coeff * margin >= bound_coeff)
        or (budget_bytes is not None and e.nbytes > budget_bytes)
    ]
    if violations:
        listing = "\n".join("  " + v.describe() for v in violations[:8])
        raise ScalingViolation(
            f"{len(violations)} intermediate(s) reach scaling class "
            f"O({worse_than}) along {axis} (margin {margin:g}"
            + (f", budget {budget_bytes / 1e6:.0f} MB" if budget_bytes else "")
            + f"):\n{listing}",
            violations)
    return rep
