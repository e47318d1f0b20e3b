"""Logical-axis sharding rules over a torch `DeviceMesh` (counterpart of
`repro.parallel.sharding`): one table maps every parameter, activation
tag, optimizer slot and decode-state leaf to a `Spec`, and each spec to
DTensor placements.

Scheme (MaxText-style FSDP + TP, DP over the pod axis by default):

  batch axes   = ("pod", "data"): all data parallelism
  "model" axis = tensor parallel (attention heads / ffn hidden / vocab /
                 MoE experts)
  FSDP         = parameters also sharded over "data" on a non-TP dim; a
                 product that needs the whole parameter gathers it (DTensor
                 redistributes the operand, where XLA all-gathers it per
                 scan step)

The reference writes each step for global arrays and lets XLA partition
it from this table. The port keeps that design: parameters, Adam's
moments, decode states and batches are DTensors placed by the table, each
op propagates placements as DTensor's rules say, and each model hook
`constrain(t, tag)` redistributes to the tag's placements.

A `Spec` is a tuple with one entry per tensor dim, like `PartitionSpec`:
None, a mesh-axis name, or a tuple of names (the dim split over all of
them, the first the major one), so a spec compares entry by entry with
the reference's. Placements go the other way, one per mesh dim: a tensor
dim over ("pod", "data") is `Shard(d)` on both mesh dims, and DTensor
splits it over the mesh dims in mesh order, first dim major. So an entry
must name its axes in mesh order, or DTensor would hold other slices than
`NamedSharding` (`placements` raises).

On a mesh of one rank every placement is `Replicate`: `place` and
`constrain` leave plain tensors alone, as the reference's jit on one
device compiles the same program with no collectives, and no op pays
DTensor's dispatch.

Param rules are keyed on the "/"-joined leaf path (the reference's keys:
"seg0/0/attn/wq"; a NamedTuple's fields by name, "seg0/0/kv/k") and
match the trailing dims only, so stacked leading layer axes are
transparent.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

Tree = Any

BATCH = ("pod", "data")  # collapses to ("data",) on single-pod meshes


class Spec(tuple):
    """Per-tensor-dim mesh axes: `Spec(("pod", "data"), None, "model")`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


# (path regex, spec for the TRAILING dims; leading dims padded with None)
PARAM_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"embed/table$", ("model", "data")),  # (V, d): vocab-TP + FSDP
    (r"unembed/w$", ("data", "model")),  # (d, V)
    (r"(attn|xattn)/w[qkv]$", ("data", "model")),  # (d, H*hd)
    (r"(attn|xattn)/wo$", ("model", "data")),  # (H*hd, d)
    (r"moe/router$", (None, None)),  # (d, E) replicated: loss-bearing fp32
    (r"moe/w_(gate|up)$", ("model", "data", None)),  # (E, d, f): EP + FSDP
    (r"moe/w_down$", ("model", None, "data")),  # (E, f, d)
    (r"mlp/w_(gate|up)$", ("data", "model")),  # (d, f)
    (r"mlp/w_down$", ("model", "data")),  # (f, d)
    (r"rwkv/(wr|wk|wv|wg)$", ("data", "model")),  # (d, d): channels TP
    (r"rwkv/wo$", ("model", "data")),
    (r"rwkv/lora_wA$", ("data", None)),
    (r"rwkv/lora_wB$", (None, "model")),
    (r"cmix/(wk|wr)$", ("data", "model")),
    (r"cmix/wv$", ("model", "data")),
    (r"rglru/(w_gate|w_x|w_a|w_i)$", ("data", "model")),  # (d, d): channels TP
    (r"rglru/w_out$", ("model", "data")),
    (r"rglru/conv_w$", (None, "model")),  # (4, d) depthwise
    # GP core (data-parallel local params live on the batch axes)
    (r"q_(mu|logS)$", (BATCH, None)),
    (r"^Z$", (None, None)),
)

# decode-state rules (path, trailing spec). KV caches shard batch + SLOTS
# (sequence) over the model axis, flash-decode style: each model rank
# scores its slots, and the softmax's max and sum and the (tiny) output
# are combined over the model axis (`attention.attn_apply_decode`).
STATE_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"kv/[kv]$", (BATCH, "model", None, None)),  # (B, slots, Kv, hd)
    (r"kv/pos$", (BATCH, "model")),  # (B, slots)
    (r"cross_[kv]$", (BATCH, "model", None, None)),  # (B, F, Kv, hd); F=1500 -> replicated
    (r"enc_pos$", (BATCH, None)),
    (r"rwkv_tm/S$", (BATCH, "model", None, None)),  # (B, H, K, V)
    (r"rwkv_tm/x_prev$", (BATCH, "model")),
    (r"rglru/h$", (BATCH, "model")),  # (B, d)
    (r"rglru/conv$", (BATCH, None, "model")),  # (B, 3, d)
    (r"cmix_prev$", (BATCH, "model")),
)

# activation tags used by the models' `constrain` hooks
ACT_RULES = {
    # residual stream: sequence-parallel over the model axis (Megatron SP);
    # attention/FFN internals reshard to head/ffn layouts
    "act_embed": (BATCH, "model", None),  # (B, S, d)
    "act_heads": (BATCH, None, "model", None),  # (B, S, H, hd)
    "act_kv_heads": (BATCH, None, "model", None),
    "ffn": (BATCH, None, "model"),  # (B, S, f)
    "logits": (BATCH, None, "model"),  # (B, c, V); rank-2 keeps the tail
    "moe_tokens": ("model", None, None),  # (E, C, d)
    "moe_ffn": ("model", None, None),  # (E, C, f)
    # blockwise-attention internals: blocked q/k/v/acc and softmax stats
    "attn_blocks": (None, BATCH, "model", None, None),  # (n, B, H, blk, hd)
    "attn_carry": (None, BATCH, "model", None),  # (n_q, B, H, bq)
    "attn_carry_q": (BATCH, "model", None),  # (B, H, bq) per-q-block stats
    "attn_carry_qa": (BATCH, "model", None, None),  # (B, H, bq, hd)
    # rwkv wkv internals: heads over model
    "rwkv_chunks": (None, BATCH, None, "model", None),  # (n, B, c, H, K)
    "rwkv_state": (BATCH, "model", None, None),  # (B, H, K, V)
    # per-channel activations (rglru branch tensors): (B, S, d) channels-TP
    "act_chan": (BATCH, None, "model"),
    # MoE entry: (T, d) tokens on the batch axes, replicated over model
    "moe_input": (BATCH, None),
    # a2a-EP entry: tokens sharded over batch AND model axes
    "moe_input_a2a": (BATCH + ("model",), None),
}


# ---------------------------------------------------------------------------
# meshes: a torch DeviceMesh, or anything with axis_names and a shape dict
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of a stand-in whose `shape` is
    that dict already)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


def is_distributed(mesh) -> bool:
    """True for a DeviceMesh of more than one rank: the one kind whose
    tensors are DTensors."""
    return mesh is not None and hasattr(mesh, "mesh_dim_names") and mesh_size(mesh) > 1


_DTENSOR = []  # DTensor's class, imported at the first call


def is_dtensor(t) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def _resolve(entry, mesh) -> Optional[Any]:
    """Map a rule entry (axis name / axis tuple / None) to mesh axes,
    dropping axes the mesh doesn't have (e.g. "pod" on single-pod)."""
    if entry is None:
        return None
    names = axis_names(mesh)
    if isinstance(entry, str):
        return entry if entry in names else None
    axes = tuple(a for a in entry if a in names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _spec_from_trailing(trailing: Tuple, shape: Tuple[int, ...], mesh) -> Spec:
    """Resolve a trailing-dims rule against a concrete shape; any axis whose
    size does not evenly divide the dim is dropped (every shard is the same
    size, as jit arguments must be; padding is the models' business)."""
    rank = len(shape)
    resolved = [_resolve(e, mesh) for e in trailing]
    if rank < len(resolved):  # tag reused on a lower-rank tensor: keep tail
        resolved = resolved[len(resolved) - rank:]
    resolved = [None] * (rank - len(resolved)) + resolved
    for i, (dim, ax) in enumerate(zip(shape, resolved)):
        if ax is not None and dim % _axes_size(mesh, ax) != 0:
            resolved[i] = None
    return Spec(*resolved)


# ---------------------------------------------------------------------------
# trees with paths
# ---------------------------------------------------------------------------

def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def map_with_path(fn: Callable[[str, Any], Any], tree: Tree, prefix: str = "",
                  is_leaf: Callable[[Any], bool] = lambda x: False) -> Tree:
    """`fn(path, leaf)` over a tree of dicts, tuples, lists and NamedTuples
    (fields by name, as `jax.tree_util` names them); None stays None."""
    if tree is None:
        return None
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k), is_leaf) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, join(f), is_leaf)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, join(i), is_leaf) for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves_with_path(tree: Tree, is_leaf: Callable[[Any], bool] = lambda x: False) -> list:
    """[(path, leaf)] in `map_with_path`'s order."""
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf=is_leaf)
    return out


def _rules_spec(rules, path: str, shape: Tuple[int, ...], mesh) -> Spec:
    for pat, trailing in rules:
        if re.search(pat, path):
            return _spec_from_trailing(trailing, shape, mesh)
    return Spec()  # replicate (norm scales, gates, scalars, biases)


def param_specs(params: Tree, mesh) -> Tree:
    return map_with_path(lambda p, x: _rules_spec(PARAM_RULES, p, tuple(x.shape), mesh), params)


def state_specs(states: Tree, mesh) -> Tree:
    return map_with_path(lambda p, x: _rules_spec(STATE_RULES, p, tuple(x.shape), mesh), states)


def batch_specs(batch: Tree, mesh) -> Tree:
    def leaf(_, x):
        shape = tuple(x.shape)
        if not shape:
            return Spec()
        return _spec_from_trailing((BATCH,) + (None,) * (len(shape) - 1), shape, mesh)

    return map_with_path(leaf, batch)


def act_spec(tag: str, shape: Tuple[int, ...], mesh) -> Optional[Spec]:
    trailing = ACT_RULES.get(tag)
    return None if trailing is None else _spec_from_trailing(trailing, shape, mesh)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """One placement per mesh dim: `Shard(d)` where tensor dim d is split
    over that mesh axis, `Replicate()` elsewhere. A dim over several axes
    must name them in mesh order (DTensor's order of splits)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh axes out of mesh order "
                             f"{names}: DTensor would split dim {d} another way")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims in {spec}")
            if sizes[names[i]] > 1:  # a split in one part is no split
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec resolved on a mesh (the counterpart of `NamedSharding`)."""

    mesh: Any
    spec: Spec
    placements: tuple


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def to_shardings(specs: Tree, mesh) -> Tree:
    return map_with_path(lambda _, s: Sharding(mesh, s, placements(s, mesh)), specs,
                         is_leaf=_is_spec)


def _is_sharding(x) -> bool:
    return isinstance(x, Sharding)


def _place_one(t, sh: Optional[Sharding]):
    if sh is None or not isinstance(t, torch.Tensor) or not is_distributed(sh.mesh):
        return t
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(sh.mesh, sh.placements)
    # every rank holds the same full tensor: keep its own slices, no scatter
    return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)


def place(tree: Tree, shardings: Tree) -> Tree:
    """Each tensor of `tree` as a DTensor placed by its `Sharding` (a plain
    tensor is the same full tensor on every rank; a DTensor is
    redistributed). On a one-rank mesh, the tree as it is. `shardings` is
    a tree of the same structure, or one `Sharding` for every leaf."""
    if _is_sharding(shardings):
        return map_with_path(lambda _, t: _place_one(t, shardings), tree)
    if shardings is None:
        return tree
    flat = dict(leaves_with_path(shardings, is_leaf=_is_sharding))
    return map_with_path(lambda p, t: _place_one(t, flat.get(p)), tree)


def full(t):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if is_dtensor(t) else t


def gather(tree: Tree) -> Tree:
    return map_with_path(lambda _, t: full(t), tree)


def local(t):
    """A DTensor's local shard (a plain tensor as it is)."""
    return t.to_local() if is_dtensor(t) else t


def replicate(t, mesh):
    """`t` as a DTensor replicated over `mesh`, or as it is where it is one
    already or the mesh has one rank. A plain tensor must hold the same
    value on every rank (made from the same inputs)."""
    if not is_distributed(mesh):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def no_constrain(t, tag: str):
    """The hook of a model run off any mesh: the identity (tp 1, no mesh)."""
    return t


no_constrain.tp = 1
no_constrain.mesh = None


def make_constrain(mesh):
    """The `constrain(tensor, tag)` callback threaded through the models:
    redistributes a DTensor to the tag's placements (a plain tensor made
    inside the model enters as replicated). Carries `tp` (the model-axis
    size) so attention can pad query heads to an evenly shardable count,
    and `mesh`. On a one-rank mesh: the identity."""
    tp = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    if not is_distributed(mesh):
        def constrain(t, tag: str):
            return t
    else:
        def constrain(t, tag: str):
            spec = act_spec(tag, tuple(t.shape), mesh)
            if spec is None:
                return t
            return replicate(t, mesh).redistribute(mesh, placements(spec, mesh))

    constrain.tp = tp
    constrain.mesh = mesh
    return constrain


# ---------------------------------------------------------------------------
# ops run on local shards or re-laid out by hand, where DTensor's own rules
# fail (they differ between torch 2.11 and 2.13)
# ---------------------------------------------------------------------------

def unshard(t, dim: int):
    """`t` with tensor dim `dim` whole on every rank: each mesh dim that
    shards it turns `Replicate` (an all-gather). A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    dim = dim % t.ndim
    pl = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def split_last(t, dims: Tuple[int, ...]):
    """`t.reshape(*t.shape[:-1], *dims)`. DTensor can split a sharded last
    dim only where the mesh dims sharding it divide dims[0]; otherwise the
    dim is gathered first (smollm's 15 query heads over a model axis of 2:
    the reference's GSPMD regathers them the same way before the pad)."""
    if is_dtensor(t):
        n = 1
        for i, p in enumerate(t.placements):
            if p.is_shard(t.ndim - 1):
                n *= t.device_mesh.size(i)
        if dims[0] % n:
            t = unshard(t, -1)
    return t.reshape(*t.shape[:-1], *dims)


def init_states(make: Callable[[Any], Tree], device, mesh) -> Tree:
    """Decode states: `make(device)` off a mesh or on one rank. On a mesh
    each rank allocates only its own shards of the tree that `make("meta")`
    describes, placed by the state rules (DTensor's `full`), so no rank
    ever holds the whole states. The values are the models'
    `init_decode_state`'s: -1 (an empty slot) in the caches' positions,
    zeros elsewhere."""
    if not is_distributed(mesh):
        return make(device)
    from torch.distributed import tensor as dtensor
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():  # shapes only, no work of the step: an op counter's
        described = make("meta")  # mode (`launch.cost`) must not take it for allocations

    def leaf(path, t):
        spec = _rules_spec(STATE_RULES, path, tuple(t.shape), mesh)
        fill = -1 if re.search(r"kv/pos$", path) else 0
        pl = placements(spec, mesh)
        if torch.device(device).type == "meta":  # a dry run: the shard alone, no storage
            return meta_shard(tuple(t.shape), t.dtype, mesh, pl, fill)
        return dtensor.full(tuple(t.shape), fill, dtype=t.dtype, device_mesh=mesh,
                            placements=pl)

    return map_with_path(leaf, described)


def local_shape(shape: Tuple[int, ...], pls: tuple, mesh) -> Tuple[int, ...]:
    """A rank's shard shape of a tensor of `shape` placed by `pls` on
    `mesh` (the rules table shards only dims the mesh axes divide)."""
    out = list(shape)
    for i, p in enumerate(pls):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def meta_shard(shape: Tuple[int, ...], dtype: torch.dtype, mesh, pls: tuple, fill=None):
    """A DTensor of global `shape` placed by `pls` whose local shard is a
    meta tensor of the shard's own shape (filled with `fill` where given):
    what a dry run traces with. Nothing of the global size is made, not
    even on the meta device, so a storage's size is a shard's."""
    from torch.distributed.tensor import DTensor

    shard = local_shape(shape, pls, mesh)
    t = (torch.empty(shard, dtype=dtype, device="meta") if fill is None
         else torch.full(shard, fill, dtype=dtype, device="meta"))
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return DTensor.from_local(t, mesh, pls, run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def place_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` placed as the DTensor `ref` is (as it is where `ref` is plain)."""
    if not is_dtensor(ref):
        return t
    return _place_one(t, Sharding(ref.device_mesh, None, tuple(ref.placements)))


def mesh_context(mesh):
    """The context a step runs in on `mesh`: on more than one rank,
    DTensor's `implicit_replication`, so a plain tensor the step makes for
    itself (positions, masks, RoPE tables, softmax carries; the same on
    every rank by construction) enters a DTensor op as replicated, in the
    forward and in the backward alike. Off a mesh, nothing."""
    import contextlib

    if not is_distributed(mesh):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def replicated(t):
    """A DTensor made whole on every rank (partial sums reduced, shards
    gathered), still a DTensor; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    rep = [Replicate()] * t.device_mesh.ndim
    return t if list(t.placements) == rep else t.redistribute(t.device_mesh, rep)


def whole_rows(x):
    """x (B, S, d) with S whole on every rank (an all-gather where the
    residual stream's sequence is split over the model axis): the input
    of a projection. DTensor flattens (B, S) for the product, and a
    flattened dim split over two mesh dims (B over data, S over model)
    takes a layout whose backward redistribution it gets wrong; the
    reference's GSPMD gathers S before the product the same way."""
    return unshard(x, 1) if is_dtensor(x) and x.ndim == 3 else x


def pointwise(fn, t):
    """`fn` of `t` run on each rank's local shard for a DTensor (placed as
    `t` in and out), for an op that acts on each shard alone: elementwise
    ones whose backward DTensor has no rule for (`log_sigmoid_backward`),
    and a zero pad of a dim no mesh dim splits (torch 2.11's rule for
    `constant_pad_nd` returns too few placements)."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor.experimental import local_map

    pl = list(t.placements)  # a list: one output's placements (a tuple is one per output)
    return local_map(fn, out_placements=pl, in_placements=(pl,), device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t)


def mesh_barrier(mesh) -> None:
    """Every rank of `mesh` waits for every other: one barrier per mesh
    dim, in order (after the last, each rank knows all have arrived)."""
    import torch.distributed as dist

    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


def pad(t, widths: Tuple[int, ...], value: float = 0.0):
    """`F.pad(t, widths, value=value)` (constant), on each rank's shard for a
    DTensor (`pointwise`); a padded dim must not be split (torch 2.11's
    DTensor rule for `constant_pad_nd` returns too few placements, so the
    pad is taken out of DTensor's hands)."""
    import torch.nn.functional as F

    if is_dtensor(t):
        padded = {t.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
        split = {p.dim for p in t.placements if p.is_shard()}
        if padded & split:
            raise ValueError(f"pad of dims {sorted(padded & split)} split over the mesh")
    return pointwise(lambda u: F.pad(u, widths, value=value), t)


class _RowsWholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return unshard(g, 1)


def grad_rows_whole(y):
    """y as it is; its gradient gathered along dim 1 on the way back. A
    projection's output (B, S, d) joins the sequence-split residual
    stream, so its gradient arrives with S split over the model axis, and
    the product's backward flattens (B, S): torch 2.11's DTensor refuses
    to flatten a split second dim (2.13 takes it as a strided shard)."""
    return _RowsWholeGrad.apply(y) if is_dtensor(y) and y.ndim == 3 else y


def gather_rows(table, idx):
    """table[idx] with `table` a DTensor: every rank looks its own batch
    rows (idx's placement over the batch axes) up in the whole table (an
    all-gather of the table). Its gradient leaves as a partial sum over
    the batch axes and whole over the others, where every rank saw the
    same rows. DTensor's own rules for this fail in torch 2.11 and 2.13
    (the indexing's backward, index_put; the embedding's vocab mask)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    idx = replicate(idx, mesh)
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in idx.placements]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p.is_shard(0) else Replicate() for p in rows]
    fn = local_map(lambda t, i: t[i], out_placements=rows, in_placements=(whole, rows),
                   in_grad_placements=(grad, rows), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, idx)
