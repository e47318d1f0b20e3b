"""A step's work, counted (the port's counterpart of `repro.launch.hlo_cost`,
which parses the compiled HLO; eager PyTorch has no HLO to parse).

Two counts live here. An LM step is counted op by op (`lower`, which
`StepBundle.lower()` and the LM dry run call): one rank's local ops traced
on meta tensors under `OpCounter`, each layer loop traced at two repeats
and multiplied (`_LoopRunner`). A GP-LVM step is counted from its parts,
as below.

A GP-LVM step is, per rank:

  * its statistics passes: each kernel launch (or plain version on the
    CPU) the ops note inside `kernels.ops.recording()`, counted by the
    kernel's least work at that pass's (N, M, Q, D, dtype)
    (`launch.roofline.KERNEL_WORK`);
  * the O(M^3) epilogue: two Cholesky factors, two M x M triangular
    solves and the bound's O(M^2 (Q + D)) terms, forward and reverse
    (reverse ~2x forward): ~8 M^3 flops, 2 M^2 exps (K_uu and the psi2
    prefactor), ~24 M x M matrices moved;
  * the per-point work outside the kernels (S = exp(q_logS), the KL and
    their cotangents, y . y);
  * Adam over every parameter element: p, g, m and v read, p, m and v
    written, g read again for the global norm; ~14 flops an element;
  * with W > 1 ranks, one ring all-reduce of the statistics forward
    (psi0, psi2, psiY, yy, n and the GP-LVM's KL) and one of the global
    parameters' cotangents in reverse (`core.distributed`).

The counts are least work, like the kernels' bounds: a plain version or
an eager epilogue moves more. `StepCost` names its parts, so a reader sees
what binds; `terms` gives the roofline terms of the whole step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.launch import roofline
from repro_torch.launch.roofline import Work

__all__ = ["Part", "StepCost", "kernel_parts", "epilogue_part", "pointwise_part",
           "adam_part", "allreduce_part", "gplvm_param_count", "gplvm_step_cost",
           "Tally", "OpCounter", "Lowered", "counting", "lower"]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


@dataclasses.dataclass(frozen=True)
class Part:
    """One part of a step: its name, least work, and the collective bytes
    a rank sends."""
    name: str
    work: Work
    collective_bytes: float = 0.0


@dataclasses.dataclass(frozen=True)
class StepCost:
    """A step's parts and their totals, per rank."""
    parts: Tuple[Part, ...]
    dtype: torch.dtype

    @property
    def flops(self) -> float:
        return sum(p.work.flops for p in self.parts)

    @property
    def exps(self) -> float:
        return sum(p.work.exps for p in self.parts)

    @property
    def nbytes(self) -> float:
        return sum(p.work.nbytes for p in self.parts)

    @property
    def collective_bytes(self) -> float:
        return sum(p.collective_bytes for p in self.parts)

    def terms(self) -> Dict:
        """The step's roofline terms (`launch.roofline.roofline_terms`)."""
        return roofline.roofline_terms(self.flops, self.exps, self.nbytes,
                                       self.collective_bytes, self.dtype)

    def table(self) -> List[Dict]:
        """One JSON-ready row per part, with its own bound in ms."""
        return [{"part": p.name, "flops": p.work.flops, "exps": p.work.exps,
                 "bytes": p.work.nbytes, "collective_bytes": p.collective_bytes,
                 "bound_ms": roofline.bound(p.work, self.dtype)[0]}
                for p in self.parts]


def kernel_parts(passes: Iterable) -> List[Part]:
    """One part per statistics pass (`kernels.ops.StatsPass`), by its
    kernel's least work at its shapes and dtype."""
    return [Part(f"{p.lib} N={p.N} M={p.M} Q={p.Q}" + (f" D={p.D}" if p.D else ""),
                 roofline.KERNEL_WORK[p.lib](p.N, p.M, p.Q, p.D, p.dtype))
            for p in passes]


def epilogue_part(M: int, Q: int, D: int, dtype: torch.dtype) -> Part:
    """The O(M^3) epilogue, forward and reverse (module docstring)."""
    flops = 8 * M**3 + 6 * M * M * (3 * Q + 2 + D)
    return Part("epilogue", Work(flops, 2 * M * M,
                                 _itemsize(dtype) * (24 * M * M + 4 * M * D)))


def pointwise_part(N: int, Q: int, D: int, dtype: torch.dtype) -> Part:
    """The GP-LVM's per-point work outside the kernels: y . y (2D flops a
    point, Y read), S = exp(q_logS), the KL (5 flops an element) and the
    two cotangents dq_logS = dS S + (S - 1) / 2 and dq_mu = dmu + mu (6
    flops), ~11 elements moved per (point, q)."""
    return Part("pointwise", Work(11 * N * Q + 2 * N * D, N * Q,
                                  _itemsize(dtype) * (11 * N * Q + N * D)))


def adam_part(n_elements: int, dtype: torch.dtype) -> Part:
    """Adam over `n_elements` parameter elements (moments in the
    parameters' dtype): 8 elements moved and ~14 flops each."""
    return Part("adam", Work(14 * n_elements, 0, 8 * _itemsize(dtype) * n_elements))


def allreduce_part(M: int, Q: int, D: int, world: int, dtype: torch.dtype) -> Part:
    """The GP-LVM's statistics all-reduce forward and the global
    cotangents' all-reduce in reverse, as ring traffic a rank sends; no
    work."""
    size = _itemsize(dtype)
    stats = size * (M * M + M * D + 5)  # psi0, psi2, psiY, yy, n and the KL
    grads = size * (M * Q + Q + 2)  # Z, kern (variance, lengthscales), log_beta
    traffic = (roofline.ring_allreduce_bytes(stats, world)
               + roofline.ring_allreduce_bytes(grads, world))
    return Part(f"all-reduce W={world}", Work(0, 0, 0), traffic)


def gplvm_param_count(N: int, M: int, Q: int) -> int:
    """Parameter elements of a GP-LVM shard of N points: q_mu, q_logS, Z,
    the kernel's variance and Q lengthscales, log_beta."""
    return 2 * N * Q + M * Q + Q + 2


def gplvm_step_cost(passes: Iterable, *, N: int, M: int, Q: int, D: int,
                    dtype: torch.dtype, world: int = 1) -> StepCost:
    """One GP-LVM Adam step of a rank holding N points: its statistics
    passes (the step's `kernels.ops.recording()` log), the epilogue, the
    per-point work, Adam and, with W > 1, the two all-reduces."""
    parts = kernel_parts(passes) + [
        epilogue_part(M, Q, D, dtype),
        pointwise_part(N, Q, D, dtype),
        adam_part(gplvm_param_count(N, M, Q), dtype),
    ]
    if world > 1:
        parts.append(allreduce_part(M, Q, D, world, dtype))
    return StepCost(tuple(parts), dtype)


# ---------------------------------------------------------------------------
# an LM step, counted op by op: one rank's local operations traced on the
# meta device (the counterpart of `repro.launch.hlo_cost` over the compiled
# HLO of the reference's dry run)
# ---------------------------------------------------------------------------

_COLLECTIVE_KINDS = (  # op name fragment -> the reference's kind
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("broadcast", "collective-permute"),
)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor")
# ops whose real kernel returns its input, which their meta kernels do not
_ALIASES = {"_wrap_tensor_autograd"}
# ops that write their output and read nothing (bytes: the output; no flops)
_WRITES = {"zeros", "ones", "full", "fill_", "zero_", "zeros_like", "ones_like",
           "full_like", "arange", "scalar_tensor", "new_zeros", "new_ones", "new_full",
           "fill", "randn", "rand", "normal_", "uniform_", "randint"}
# ops that move no bytes: allocations, aliases, metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_wrap_tensor_autograd",
         "_unsafe_view", "detach", "alias", "lift_fresh", "set_", "resize_",
         "wait_tensor", "sym_size", "sym_stride", "sym_numel", "_local_scalar_dense",
         "is_same_size", "_has_compatible_shallow_copy_type"}
# gathers: read what they write (and the index)
_GATHERS = {"index_select", "gather", "embedding", "index"}
# in-place writes of a part of their target: read and write the values
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_", "scatter_add_",
             "index_add_", "scatter_reduce_"}
# copies and layout changes: bytes, no flops
_MOVES = {"copy_", "_to_copy", "clone", "cat", "stack", "constant_pad_nd", "slice_scatter",
          "select_scatter", "as_strided_scatter", "contiguous", "index_fill_", "index_fill",
          "masked_fill_", "repeat", "flip", "roll", "sort", "argsort", "topk", "tril", "triu",
          "unbind_copy", "split_with_sizes_copy", "embedding_dense_backward",
          "_unsafe_index_put", "index_put", "scatter", "scatter_add", "index_copy"}


def _tbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _round_alloc(n: int) -> int:
    """Bytes the CUDA caching allocator hands out for a request of n:
    whole 512-byte blocks (what `torch.cuda.max_memory_allocated` counts)."""
    return 0 if n == 0 else -(-n // 512) * 512


@dataclasses.dataclass
class Tally:
    """A rank's counts: matrix-product and other operations by dtype name,
    bytes moved (each op's operands and result), and collectives by the
    reference's kind (count, result bytes) with their ring traffic by link
    ("nvlink" or "network", `roofline.link_of`)."""

    matmul_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    other_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    nbytes: float = 0.0
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_raw: Dict[str, float] = dataclasses.field(default_factory=dict)
    traffic: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return sum(self.matmul_flops.values()) + sum(self.other_flops.values())

    @property
    def traffic_bytes(self) -> float:
        return sum(self.traffic.values())

    def terms(self) -> Dict:
        """The step's roofline terms on the H100 (`roofline.lm_roofline_terms`)."""
        return roofline.lm_roofline_terms(self.matmul_flops, self.other_flops, self.nbytes,
                                          self.traffic)

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "matmul_flops": dict(self.matmul_flops),
                "other_flops": dict(self.other_flops), "bytes": self.nbytes,
                "collectives": {"counts": dict(self.coll_counts),
                                "raw_bytes_per_chip": dict(self.coll_raw),
                                "traffic_bytes_per_chip": self.traffic_bytes,
                                "traffic_by_link": dict(self.traffic)}}


def _add(d: Dict[str, float], k: str, v: float) -> None:
    d[k] = d.get(k, 0.0) + v


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flat_tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat_tensors(v)]
    return []


def _group_ranks(args) -> Optional[List[int]]:
    """The ranks of the process group a collective's arguments name (a
    group name, or a boxed ProcessGroup), in the order of the world."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        pg = None
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                pg = None
        elif isinstance(a, str):
            try:
                pg = _resolve_process_group(a)
            except (RuntimeError, KeyError, ValueError):
                pg = None
        if pg is not None:
            return dist.get_process_group_ranks(pg)
    return None


class OpCounter:
    """A dispatch-level counter of one rank's local operations, and a
    tracker of its live bytes.

    It sits below DTensor: an op on DTensors is left to DTensor
    (NotImplemented), which runs the rank's local op, and that op is what
    is counted, so nothing is counted at the global shape and nothing
    twice. Only ops on plain meta-device tensors count: DTensor's own
    bookkeeping (real CPU tensors) and the global-shape fake tensors its
    sharding propagation runs on are left out.

      * Matrix products: `torch.utils.flop_counter`'s formulas, at the
        product's dtype (its first operand's).
      * Every other op that computes: one operation an output element, a
        reduction one an input element (`repro.launch.hlo_cost`'s
        convention). Copies, gathers, scatters, fills and layout changes
        move bytes and do no operations; views and allocations do neither.
      * Bytes: each op's tensor operands and its result, each tensor once
        (an in-place result is its operand); a gather reads what it writes
        (and its index), an in-place scatter reads and writes its values.
        Eager PyTorch has no fusion boundaries, so this is what the port
        moves, not what a compiler that fuses elementwise chains would.
      * Collectives (the functional ones DTensor calls and the c10d ones
        `parallel.collectives` and flash-decode call): by the reference's
        kind, their result bytes, and the ring traffic of
        `roofline.ring_traffic` over the group's size, on the link
        `roofline.link_of` gives the group's ranks.

    Each op is added to `total` with the current weight (n - 1 in the
    last repeat of an n-repeat layer loop, `_LoopRunner`), and once to
    `once`.

    Live bytes: every storage an op creates on the meta device, rounded to
    the CUDA allocator's 512-byte blocks, from its creation to its death
    (a weak-reference finalizer), and the arguments' storages from the
    start; `peak` is their most, or a layer loop's reconstruction of the
    repeats it stood in for, where larger (`_LoopRunner`).
    """

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.total = Tally()
        self.once = Tally()
        self.weights = [1]  # the current weight last
        self.quiet = 0  # > 0: ops counted for memory only
        self.live = 0
        self.peak = 0
        self.regions: List[List[int]] = []  # [live at start, most since] per open region
        self._sizes: Dict[int, tuple] = {}  # storage id -> (bytes, the op that made it)
        self.live_by_op: Dict[str, int] = {}
        self.peak_by_op: Dict[str, int] = {}  # live bytes by op at the traced peak
        self._keep: Dict[int, Any] = {}

    # --- memory -----------------------------------------------------------
    def track(self, t: torch.Tensor, owner: str = "arguments") -> None:
        """Count `t`'s storage as live until it dies, under the op that made
        it (`owner`)."""
        import weakref

        if type(t) is not torch.Tensor or not t.is_meta:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = _round_alloc(st.nbytes())
        self._sizes[key] = (n, owner)
        weakref.finalize(st, self._free, key)
        self.live += n
        self.live_by_op[owner] = self.live_by_op.get(owner, 0) + n
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by_op = {k: v for k, v in self.live_by_op.items() if v}
        for reg in self.regions:
            reg[1] = max(reg[1], self.live)

    def _free(self, key: int) -> None:
        n, owner = self._sizes.pop(key)
        self.live -= n
        self.live_by_op[owner] -= n

    @contextlib.contextmanager
    def quietly(self):
        """Ops in this context count for memory only (a stand-in's)."""
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1

    def candidate(self, live: float) -> None:
        """A peak the trace did not reach itself (a repeat stood in for);
        `peak_by_op` stays the traced peak's."""
        self.peak = max(self.peak, int(live))

    # --- counting ---------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> Tally:
        t = Tally()
        name = func._schema.name.split("::")[-1]
        ins = _flat_tensors(args) + _flat_tensors(kwargs)
        outs = _flat_tensors(out)
        for kind_frag, kind in _COLLECTIVE_KINDS:
            if func.namespace in _COLLECTIVE_NAMESPACES and kind_frag in name:
                ranks = _group_ranks(list(args) + list(kwargs.values())) or [0]
                # the result: the functional op's output; a c10d op's first
                # tensor argument (its output buffer, or the tensors reduced
                # in place)
                res = outs if func.namespace != "c10d" else _flat_tensors(args[0])
                nb = float(sum(_tbytes(x) for x in res))
                P = len(ranks)
                if P > 1:
                    t.coll_counts[kind] = 1.0
                    t.coll_raw[kind] = nb
                    t.traffic[roofline.link_of(ranks)] = roofline.ring_traffic(kind, nb, P)
                t.nbytes = float(sum(_tbytes(x) for x in ins)) + nb
                return t
        if name in _FREE or func.is_view:
            return t
        packet = func.overloadpacket
        if packet in self.flop_registry:
            f = self.flop_registry[packet](*args, **kwargs, out_val=out)
            _add(t.matmul_flops, _dtype_name(ins[0].dtype), float(f))
            t.nbytes = float(sum(_tbytes(x) for x in ins) + sum(_tbytes(x) for x in outs))
            return t
        if name in _WRITES:
            t.nbytes = float(sum(_tbytes(x) for x in outs))
            return t
        if name in _GATHERS:
            idx = [x for x in ins if not x.is_floating_point()]
            t.nbytes = float(2 * sum(_tbytes(x) for x in outs) + sum(_tbytes(x) for x in idx))
            return t
        if name in _SCATTERS:  # indices and values read, the values written
            others = ins[1:]
            t.nbytes = float(sum(_tbytes(x) for x in others)
                             + sum(_tbytes(x) for x in others if x.dtype == ins[0].dtype))
            return t
        seen = {id(x) for x in ins}
        t.nbytes = float(sum(_tbytes(x) for x in {id(x): x for x in ins}.values())
                         + sum(_tbytes(x) for x in outs if id(x) not in seen))
        if name in _MOVES or not outs:
            return t
        dtype = _dtype_name(outs[0].dtype if outs[0].is_floating_point() or not ins
                            else ins[0].dtype)
        if torch.Tag.reduction in func.tags:
            _add(t.other_flops, dtype, float(max(x.numel() for x in ins)))
        else:
            _add(t.other_flops, dtype, float(sum(x.numel() for x in outs)))
        return t

    def record(self, func, args, kwargs, out) -> None:
        if func.namespace == "prim":
            return
        from torch._subclasses.fake_tensor import FakeTensor

        ts = _flat_tensors(args) + _flat_tensors(kwargs) + _flat_tensors(out)
        if any(isinstance(x, FakeTensor) for x in ts) or not any(
                type(x) is torch.Tensor and x.is_meta for x in ts):
            return  # DTensor's sharding propagation (fakes), or its bookkeeping
        if func.namespace in _COLLECTIVE_NAMESPACES and func._opname in _ALIASES:
            # the real op returns its input (wrapped); its meta kernel makes
            # a new tensor, whose bytes are the input's: the input is kept
            # alive as long as the result, and nothing new is counted
            out._dry_run_alias_of = args[0]
        elif not func.is_view:  # a view allocates nothing
            for x in _flat_tensors(out):
                self.track(x, "stand-ins" if self.quiet else str(func))
        if self.quiet:
            return
        t = self._count(func, args, kwargs or {}, out)
        for tally, w in ((self.total, self.weights[-1]), (self.once, 1)):
            for src, dst in ((t.matmul_flops, tally.matmul_flops),
                             (t.other_flops, tally.other_flops),
                             (t.coll_counts, tally.coll_counts),
                             (t.coll_raw, tally.coll_raw), (t.traffic, tally.traffic)):
                for k, v in src.items():
                    _add(dst, k, w * v)
            tally.nbytes += w * t.nbytes


def counting(counter: OpCounter):
    """A context in which every local op on meta tensors is counted by
    `counter` (`lower` runs the step in one)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented  # DTensor runs the local op, which comes back here
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            counter.record(func, args, kwargs, out)
            return out

    return _Mode()


def _like(t: torch.Tensor) -> tuple:
    """What `_new_like` needs to make a tensor like `t`: shape, dtype and,
    for a DTensor, its mesh and placements."""
    from repro_torch.parallel import sharding as shd

    if shd.is_dtensor(t):
        return tuple(t.shape), t.dtype, t.device_mesh, tuple(t.placements)
    return tuple(t.shape), t.dtype, None, None


def _new_like(like: tuple) -> torch.Tensor:
    from repro_torch.parallel import sharding as shd

    shape, dtype, mesh, pls = like
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return shd.meta_shard(shape, dtype, mesh, pls)


def _no_grad_where_none(ctx, ins, outs) -> None:
    """Outputs of a custom Function whose input needs no gradient need none
    either (autograd would otherwise give every output one, and the loss
    would run reverses the real step does not), and a gradient that is
    None stays None."""
    ctx.mark_non_differentiable(*[o for o, t in zip(outs, ins) if not t.requires_grad])
    ctx.set_materialize_grads(False)  # no zeros made for the gradients that are None


def _identity(ctx, ts) -> tuple:
    outs = tuple(t.view_as(t) for t in ts)
    _no_grad_where_none(ctx, ts, outs)
    return outs


class _Loop:
    """One layer loop's record while it is counted: the weight of its last
    repeat (the repeats it stands for), that repeat's reverse transient
    above the live bytes at its start, and the gradients its carry and its
    operands received (shapes, dtypes, placements), which the stand-ins'
    reverses give theirs."""

    def __init__(self, counter: OpCounter, weight: int):
        self.counter, self.weight = counter, weight
        self.bwd_transient = 0
        self.carry_grads: List[Optional[tuple]] = []
        self.operand_grads: Dict[int, tuple] = {}


class _Enter(torch.autograd.Function):
    """Identity on the last repeat's carry; its reverse closes that repeat's
    reverse region (weight, transient) and notes the carry's gradients."""

    @staticmethod
    def forward(ctx, loop, *ts):
        ctx.loop = loop
        return _identity(ctx, ts)

    @staticmethod
    def backward(ctx, *grads):
        loop = ctx.loop
        c = loop.counter
        start, most = c.regions.pop()
        c.weights.pop()
        loop.bwd_transient = most - start
        loop.carry_grads = [None if g is None else _like(g) for g in grads]
        return (None, *grads)


class _Exit(torch.autograd.Function):
    """Identity on the last repeat's result; its reverse opens that repeat's
    reverse region: every op until `_Enter`'s reverse is the repeat's own
    (the autograd engine runs the ready node of the highest sequence
    number first, and the repeat's nodes lie between the two)."""

    @staticmethod
    def forward(ctx, loop, *ts):
        ctx.loop = loop
        return _identity(ctx, ts)

    @staticmethod
    def backward(ctx, *grads):
        c = ctx.loop.counter
        c.weights.append(c.weights[-1] * ctx.loop.weight)
        c.regions.append([c.live, c.live])
        return (None, *grads)


class _Tap(torch.autograd.Function):
    """Identity on the last repeat's operands; its reverse notes the
    gradients they receive (it runs after `_Enter`'s reverse and before
    any stand-in's: it was made after the stand-ins, before `_Enter`)."""

    @staticmethod
    def forward(ctx, loop, *ts):
        ctx.loop = loop
        return _identity(ctx, ts)

    @staticmethod
    def backward(ctx, *grads):
        for i, g in enumerate(grads):
            if g is not None:
                ctx.loop.operand_grads[i] = _like(g)
        return (None, *grads)


class _StandIn(torch.autograd.Function):
    """A repeat that is not traced: its carry out (new tensors like the
    carry, which the traced repeat 0 made). Where autograd records it, it
    keeps its input for its reverse, and `_LoopRunner` hangs on it
    (`ctx.phantom`) the bytes the last repeat kept besides. Its reverse
    gives gradients like those the last repeat's carry and operands
    received. Nothing of it is counted but its memory."""

    @staticmethod
    def forward(ctx, loop, n_carry, *ts):
        ctx.loop = loop
        with loop.counter.quietly():
            outs = tuple(torch.empty_like(t) for t in ts[:n_carry])
        _no_grad_where_none(ctx, ts, outs)
        ctx.keep, ctx.n_carry, ctx.phantom = ts[:n_carry], n_carry, None
        return outs

    @staticmethod
    def backward(ctx, *grads):
        loop = ctx.loop
        c = loop.counter
        c.candidate(c.live + loop.bwd_transient)
        needs = ctx.needs_input_grad[2:]
        with c.quietly():
            gs = [_new_like(loop.carry_grads[i]) if need and i < len(loop.carry_grads)
                  and loop.carry_grads[i] is not None else None
                  for i, need in enumerate(needs[:ctx.n_carry])]
            gs += [_new_like(loop.operand_grads[i]) if need and i in loop.operand_grads
                   else None for i, need in enumerate(needs[ctx.n_carry:])]
        ctx.keep = ctx.phantom = None
        return (None, None, *gs)


class _LoopRunner:
    """The runner `models.layers.layer_loop` calls while a step is counted,
    for a loop of n > 2 repeats: it traces repeat 0 as it is (its input may
    be laid out as no later repeat's is), stands in for repeats 1 .. n - 2
    (`_StandIn`), and traces repeat n - 1 with every op weighted n - 1, its
    reverse too (between `_Exit`'s and `_Enter`'s reverses).

    Memory: every model keeps a layer's input for its reverse (its norm's
    input), and a stand-in keeps its own where autograd records it. Once
    the last repeat has run, what it kept besides (its live bytes' growth
    less its result) is hung on each stand-in; the forward's peak is then
    the last repeat's plus what the stand-ins should have held meanwhile.
    In reverse the last repeat runs first, with every stand-in's bytes
    live, and each stand-in's reverse adds that repeat's reverse transient
    to the live bytes at its start (`OpCounter.candidate`)."""

    def __init__(self, counter: OpCounter):
        self.c = counter

    def __call__(self, step, carry, n: int, operands):
        if n <= 2:
            for r in range(n):
                carry = step(carry, r, operands(r))
            return carry
        c = self.c
        single = isinstance(carry, torch.Tensor)
        out = step(carry, 0, operands(0))
        outs = (out,) if single else tuple(out)
        loop = _Loop(c, n - 1)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in outs)
        nodes = []
        for r in range(1, n - 1):
            outs = _tuple(_StandIn.apply(loop, len(outs), *outs, *_flat_tensors(operands(r))))
            if grad:
                nodes.append(next(t.grad_fn for t in outs if t.grad_fn is not None))
        ops = operands(n - 1)
        if grad:
            ops = _rebuild(ops, iter(_tuple(_Tap.apply(loop, *_flat_tensors(ops)))))
        start = c.live
        c.regions.append([start, start])
        c.weights.append(c.weights[-1] * (n - 1))
        try:
            inp = _tuple(_Enter.apply(loop, *outs)) if grad else outs
            out = step(inp[0] if single else type(carry)(inp), n - 1, ops)
            outs = (out,) if single else tuple(out)
            outs = _tuple(_Exit.apply(loop, *outs)) if grad else outs
        finally:
            c.weights.pop()
            _, most = c.regions.pop()
        if grad:
            out_bytes = sum(_round_alloc(_tbytes(t)) for t in _local(outs))
            saved = max(0, c.live - start - out_bytes)
            c.candidate(most + len(nodes) * saved)
            with c.quietly():
                for node in nodes:
                    node.phantom = torch.empty(saved, dtype=torch.uint8, device="meta")
        return outs[0] if single else type(carry)(outs)


def _rebuild(tree, it):
    """`tree` (dicts, lists, tuples of tensors) with its tensors, in
    `_flat_tensors`' order, taken from the iterator `it`."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def _tuple(x) -> tuple:
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _local(ts) -> List[torch.Tensor]:
    from repro_torch.parallel import sharding as shd

    return [shd.local(t) for t in ts]


@dataclasses.dataclass
class Lowered:
    """`StepBundle.lower()`'s record of one rank's step: its counts with
    each layer loop's repeat counted its trip count times (`total`) and
    once (`once`, as XLA's own cost analysis counts a scan's body), its
    memory (the reference's `memory_analysis()` keys, in bytes), the
    seconds the trace took, and the mesh's rank count. `compile_s` is None:
    eager code has no compile step."""

    total: Tally
    once: Tally
    memory: Dict[str, int]
    lower_s: float
    n_ranks: int
    compile_s: Optional[float] = None
    peak_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)

    def terms(self) -> Dict:
        return self.total.terms()


def _abstract(tree, shardings):
    """`tree`'s meta stand-ins as a rank's abstract arguments: a DTensor
    whose local shard is a meta tensor of its own (`sharding.meta_shard`)
    where its sharding spans a mesh of more than one rank, a meta tensor
    otherwise."""
    from repro_torch.parallel import sharding as shd

    def one(t, sh):
        if sh is None or not shd.is_distributed(sh.mesh):
            return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
        return shd.meta_shard(tuple(t.shape), t.dtype, sh.mesh, sh.placements)

    if isinstance(shardings, shd.Sharding):
        return shd.map_with_path(lambda _, t: one(t, shardings), tree)
    flat = dict(shd.leaves_with_path(shardings, is_leaf=lambda x: isinstance(x, shd.Sharding)))
    return shd.map_with_path(lambda p, t: one(t, flat.get(p)), tree)


def lower(bundle, *, multiply: bool = True) -> Lowered:
    """Trace `bundle`'s step (`jitted()`: arguments placed, the step run,
    results placed) on one rank's abstract arguments, on the meta device,
    and count it (`OpCounter`). With `multiply`, each layer loop runs one
    repeat and counts it its trip count times (`_LoopRunner`); without,
    every repeat runs (the whole trace, for checking the multiplied one).

    Memory: `argument_bytes` are the rank's shards of the arguments,
    `output_bytes` of the results, `alias_bytes` the results that are an
    argument's own storage (decode's states, advanced in place; nothing
    for train and prefill: the port donates nothing, and Adam returns new
    moments beside the old), `peak_hbm_bytes_est` the most live bytes the
    trace saw (or reconstructed, `_LoopRunner`), and `temp_bytes` that
    peak above the arguments and the results."""
    import time

    from repro_torch.models import layers
    from repro_torch.parallel import sharding as shd

    t0 = time.perf_counter()
    args = tuple(_abstract(a, s) for a, s in zip(bundle.abstract_args, bundle.in_shardings))
    arg_ts = _local(_flat_tensors(list(args)))
    counter = OpCounter()
    for t in arg_ts:
        counter.track(t)
    runner = _LoopRunner(counter)
    if multiply:
        layers.LAYER_LOOP.append(runner)
    try:
        with counting(counter):
            out = bundle.jitted()(*args)
    finally:
        if multiply:
            layers.LAYER_LOOP.remove(runner)
    out_ts = _local(_flat_tensors(out))
    arg_storages = {id(t.untyped_storage()) for t in arg_ts}
    argument = sum(_tbytes(t) for t in arg_ts)
    output = sum(_tbytes(t) for t in out_ts)
    alias = sum(_tbytes(t) for t in out_ts if id(t.untyped_storage()) in arg_storages)
    peak = max(counter.peak, argument + output - alias)
    memory = {"argument_bytes": argument, "output_bytes": output,
              "temp_bytes": peak - (argument + output - alias), "alias_bytes": alias,
              "peak_hbm_bytes_est": peak}
    return Lowered(counter.total, counter.once, memory, time.perf_counter() - t0,
                   shd.mesh_size(bundle.mesh) if bundle.mesh is not None else 1,
                   peak_by_op=counter.peak_by_op)
