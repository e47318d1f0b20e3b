"""Mixture-of-Experts FFN with permutation-gather token dispatch and
expert parallelism (counterpart of `repro.models.moe`).

  * Dispatch and combine are row gathers through a precomputed
    slot <-> (token, choice) permutation, wrapped in an autograd function
    whose backward is a gather by the inverse permutation: the mapping is
    injective, so no scatter-add appears in either pass.
  * Slot assignment is sort-based (a stable argsort over expert ids and
    each expert's segment start), so no (T, E) cumsum tensor exists.
  * The router runs in float32, breaks a tie between two probabilities
    toward the lower expert id (as `lax.top_k` does) and gives a
    Switch-style load-balance aux loss.

Capacity: C = max(8, int(cf T k / E)) rounded up to 8 slots an expert; a
(token, choice) pair past its expert's C slots is dropped and contributes
a zero row.

On a device mesh whose model axis divides the experts, experts shard over
the model axis (EP) and `moe_apply` takes one of the reference's two
shard_map paths, written here on each rank's local shards
(`DTensor.to_local` / `from_local`) with explicit collectives over the
model axis's process group (`parallel.collectives`):

  * `moe_apply_ep`: every model rank holds a full replica of its data
    shard's tokens and E/tp experts, slots its tokens for its experts, and
    one all-reduce over the model axis (in the compute dtype) sums the
    outputs;
  * `moe_apply_ep_a2a`: tokens split over the batch and model axes; one
    all-to-all sends each (token, choice) pair to its expert's owner, and
    one brings the results back.

Gradients leave each path as DTensor partial sums where ranks hold parts
of one sum (the router over every axis, an expert's weights over the data
axes, the replicated tokens over the model axis), and DTensor reduces
them into the parameters' placements.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dt, normal
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import no_constrain


def moe_init(gen, cfg: ModelConfig, device):
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def expert_mats(din, dout):  # scaled in place: one float32 copy at a time
        return normal(gen, (E, din, dout), device).mul_(din**-0.5).to(dt(cfg))

    return {
        "router": normal(gen, (d, E), device) * d**-0.5,  # float32
        "w_gate": expert_mats(d, f),
        "w_up": expert_mats(d, f),
        "w_down": expert_mats(f, d),
    }


# ---------------------------------------------------------------------------
# permutation gather with a gather-based backward
# ---------------------------------------------------------------------------

def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] by rows, a zero row where idx is out of range (the sentinel)."""
    n = x.shape[0]
    valid = idx < n
    rows = x[torch.where(valid, idx, 0)]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return _take_rows(x, fwd_idx)

    @staticmethod
    def backward(ctx, g):
        (inv_idx,) = ctx.saved_tensors
        return _take_rows(g, inv_idx), None, None


def permute_rows(x: torch.Tensor, fwd_idx: torch.Tensor, inv_idx: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """out[j] = x[fwd_idx[j]] (rows); an out-of-range index gives a zero row.

    fwd_idx: (n_out,) indices into x's rows (sentinel = x.shape[0]).
    inv_idx: (x.shape[0],) the inverse mapping (sentinel = n_out), used only
    by the backward pass. The mapping must be injective on valid entries."""
    if fwd_idx.shape != (n_out,):
        raise ValueError(f"fwd_idx has shape {tuple(fwd_idx.shape)}, want ({n_out},)")
    return _PermuteRows.apply(x, fwd_idx, inv_idx)


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor  # load-balance loss (Switch LB: E * sum_e f_e * p_e)


def _top_k(probs: torch.Tensor, k: int) -> tuple:
    """`lax.top_k`: the k largest along the last axis, a tie going to the
    lower index (a stable descending sort; `torch.topk` promises no order
    among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xt: torch.Tensor, E: int, k: int) -> tuple:
    """float32 routing: (top_p, top_e, aux)."""
    T = xt.shape[0]
    router = params["router"]  # float32 (float64 where a caller widens the tree)
    logits = xt.to(torch.promote_types(torch.float32, router.dtype)) @ router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)  # (T, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)
    # bincount as a scatter-add: the counts' shape is static (E), so the
    # routing traces on fake tensors too
    counts = torch.zeros(E, dtype=torch.int64, device=top_e.device)
    ce = counts.scatter_add_(0, top_e[:, 0], torch.ones_like(top_e[:, 0])).float() / T
    aux = E * torch.sum(me * ce)
    return top_p, top_e, aux


def _expert_ffn(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: xe (E, C, d) -> (E, C, d). It runs on plain
    tensors only: on a mesh the EP paths and the dense path's `local_map`
    hand it local shards (the reference's "moe_tokens" / "moe_ffn" layouts
    are theirs)."""
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    return torch.bmm(h, wd)


def _slot(ids: torch.Tensor, n_buckets: int, cap: int, n_items: int) -> tuple:
    """Sort-based slotting: ids (n_items,) in [0, n_buckets), or >= for
    "drop". Returns (slot_of_item, item_of_slot) with sentinels
    n_buckets * cap and n_items."""
    key = torch.where(ids < n_buckets, ids, n_buckets)
    order = torch.argsort(key, stable=True)
    sorted_b = key[order]
    seg = torch.searchsorted(sorted_b, torch.arange(n_buckets, device=ids.device))
    pos = torch.arange(n_items, device=ids.device) - seg[torch.clamp(sorted_b, max=n_buckets - 1)]
    keep = (sorted_b < n_buckets) & (pos < cap)
    slot_sorted = torch.where(keep, sorted_b * cap + pos, n_buckets * cap)
    slot_of_item = torch.empty_like(slot_sorted)
    slot_of_item[order] = slot_sorted
    # the dropped items write the extra sentinel row, cut off after
    item_of_slot = torch.full((n_buckets * cap + 1,), n_items, dtype=order.dtype,
                              device=ids.device)
    item_of_slot[slot_sorted] = order
    return slot_of_item, item_of_slot[:n_buckets * cap]


class _Layout:
    """The mesh axes an EP path reads: the batch axes' mesh dims and sizes,
    the model axis's dim, size, group and this rank's index on it."""

    def __init__(self, mesh):
        names = shd.axis_names(mesh)
        self.mesh = mesh
        self.batch_dims = [names.index(a) for a in shd.BATCH if a in names]
        self.dp = 1
        for i in self.batch_dims:
            self.dp *= mesh.size(i)
        self.model_dim = names.index("model")
        self.tp = mesh.size(self.model_dim)
        self.group = mesh.get_group(self.model_dim)
        self.model_rank = mesh.get_local_rank(self.model_dim)

    def sum_all(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over every rank of the mesh: one all-reduce per mesh dim."""
        for i in range(self.mesh.ndim):
            t = collectives.all_reduce_sum(t, self.mesh.get_group(i))
        return t

    def placements(self, batch=None, model=None) -> list:
        """Per mesh dim: `batch` on the batch dims, `model` on the model
        dim, Replicate elsewhere."""
        from torch.distributed.tensor import Replicate

        out = [Replicate()] * self.mesh.ndim
        for i in self.batch_dims:
            out[i] = batch or Replicate()
        out[self.model_dim] = model or Replicate()
        return out


def _local_inputs(params, x, lay: _Layout, x_pl, x_grad_pl, cdt) -> tuple:
    """x and the MoE parameters as this rank's local tensors: x placed by
    x_pl; the router whole (its gradient a partial sum over every axis);
    the expert weights with this rank's E/tp experts whole over the data
    axes (their gradients partial sums over the data axes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = lay.mesh
    x = shd.replicate(x, mesh)
    x_loc = x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad_pl)
    router = shd.replicate(params["router"], mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=[Partial()] * mesh.ndim)
    w_pl = lay.placements(Replicate(), Shard(0))
    w_grad_pl = lay.placements(Partial(), Shard(0))
    ws = [shd.replicate(params[k], mesh).redistribute(mesh, w_pl).to_local(
        grad_placements=w_grad_pl).to(cdt) for k in ("w_gate", "w_up", "w_down")]
    return x_loc, router, ws


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, constrain=no_constrain) -> MoEOut:
    """x: (B, S, d) -> (B, S, d). Dispatch, as the reference's: the
    all-to-all EP path when tokens divide over the batch and model axes
    with at least 64 a rank (training / prefill), the all-reduce EP path
    otherwise (decode, small batches), the dense path off the mesh or
    where the model axis is 1 or does not divide the experts."""
    mesh = constrain.mesh
    sizes = shd.axis_sizes(mesh) if shd.is_distributed(mesh) else {}
    tp = sizes.get("model", 1)
    if tp > 1 and cfg.num_experts % tp == 0:
        dp = 1
        for a in shd.BATCH:
            dp *= sizes.get(a, 1)
        B, S, _ = x.shape
        T_loc = (B // dp) * S if B % dp == 0 else 0
        if T_loc and T_loc % tp == 0 and T_loc // tp >= 64:
            return moe_apply_ep_a2a(params, x, cfg, constrain)
        return moe_apply_ep(params, x, cfg, constrain)
    return moe_apply_dense(params, x, cfg)


def moe_apply_ep(params, x: torch.Tensor, cfg: ModelConfig, constrain) -> MoEOut:
    """Expert-parallel MoE, the paper's local-compute + one-all-reduce
    pattern: tokens stay on their batch shard, every model rank holds E/tp
    experts and a full replica of its data shard's tokens, slots them for
    its own experts (1-D sort/gather work only), runs the expert FFN,
    combines locally, and one all-reduce over the model axis, in the
    compute dtype, sums the outputs. No all-to-all, no cross-rank gathers.

    Capacity is per (data shard, expert): C_loc = cf T_loc k / E. The aux
    loss is averaged over every rank (each model rank holds 1/tp of it),
    so its gradient is not counted tp times."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh = constrain.mesh
    if not shd.is_distributed(mesh):
        raise ValueError("moe_apply_ep needs a device mesh of more than one rank")
    lay = _Layout(mesh)
    cdt = dt(cfg, "compute")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    E_loc = E // lay.tp
    T_loc = (B // lay.dp) * S  # tokens per data shard
    C = max(8, int(cfg.capacity_factor * T_loc * k / E))
    C = -(-C // 8) * 8

    x_pl = lay.placements(Shard(0))
    x_loc, router, (wg, wu, wd) = _local_inputs(
        params, x, lay, x_pl, lay.placements(Shard(0), Partial()), cdt)
    xt = x_loc.reshape(T_loc, d)
    top_p, top_e, aux = _route({"router": router}, xt, E, k)
    flat_e = top_e.reshape(T_loc * k) - lay.model_rank * E_loc  # local ids
    mine = (flat_e >= 0) & (flat_e < E_loc)
    slot_of_pair, pair_of_slot = _slot(torch.where(mine, flat_e, E_loc), E_loc, C, T_loc * k)

    xp = torch.repeat_interleave(xt.to(cdt), k, dim=0)  # (T_loc*k, d)
    xe = permute_rows(xp, pair_of_slot, slot_of_pair, E_loc * C)
    ye = _expert_ffn(xe.reshape(E_loc, C, d), wg, wu, wd)
    ye_pairs = permute_rows(ye.reshape(E_loc * C, d), slot_of_pair, pair_of_slot, T_loc * k)
    w = (top_p.reshape(T_loc * k) * (slot_of_pair < E_loc * C)).to(cdt)
    y = torch.sum((ye_pairs * w[:, None]).reshape(T_loc, k, d), dim=1)
    y = collectives.all_reduce_sum(y.to(cdt), lay.group)  # the one collective
    aux = lay.sum_all(aux / lay.tp) / lay.dp
    y = DTensor.from_local(y.reshape(x_loc.shape), mesh, x_pl, run_check=False)
    aux = shd.replicate(aux.float(), mesh)
    return MoEOut(y, aux)


def moe_apply_ep_a2a(params, x: torch.Tensor, cfg: ModelConfig, constrain) -> MoEOut:
    """All-to-all expert parallelism (GLaM-style). Tokens split over the
    batch and model axes, each rank routing T_chip = T/(dp tp) tokens.
    Pairs sort by destination model rank into fixed (tp, C_send, d)
    buffers; one all-to-all delivers them to the expert owner, which
    re-sorts them into per-expert queues and runs the FFN, and a reverse
    all-to-all returns the results to the token owners. Two capacity
    stages (send side C_send a destination rank, expert side C_recv an
    expert) bound the buffers."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = constrain.mesh
    if not shd.is_distributed(mesh):
        raise ValueError("moe_apply_ep_a2a needs a device mesh of more than one rank")
    lay = _Layout(mesh)
    tp = lay.tp
    cdt = dt(cfg, "compute")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    E_loc = E // tp
    T_chip = (B // lay.dp) * S // tp
    cf = cfg.capacity_factor
    C_send = -(-max(8, int(cf * T_chip * k / tp)) // 8) * 8
    C_recv = -(-max(8, int(cf * tp * C_send / E_loc)) // 8) * 8

    x = constrain(x, "act_embed")  # (B, S, d): batch x seq(model) sharded
    x_pl = lay.placements(Shard(0), Shard(1))
    x_loc, router, (wg, wu, wd) = _local_inputs(params, x, lay, x_pl, x_pl, cdt)
    xt = x_loc.reshape(T_chip, d)
    top_p, top_e, aux = _route({"router": router}, xt, E, k)
    flat_e = top_e.reshape(T_chip * k)
    dest = flat_e // E_loc  # destination model rank of each pair

    # ---- send side: pairs -> (tp, C_send) buffers -------------------
    s_of_pair, pair_of_s = _slot(dest, tp, C_send, T_chip * k)
    xp = torch.repeat_interleave(xt.to(cdt), k, dim=0)
    send = permute_rows(xp, pair_of_s, s_of_pair, tp * C_send)  # (tp*C_send, d)
    # the expert-local id rides along (sentinel E_loc for empty slots)
    e_send = torch.full((tp * C_send + 1,), E_loc, dtype=flat_e.dtype, device=x_loc.device)
    e_send[s_of_pair] = flat_e % E_loc
    e_send = e_send[:tp * C_send]

    recv = collectives.all_to_all(send.reshape(tp, C_send, d), lay.group)
    e_recv = collectives.all_to_all(e_send.reshape(tp, C_send), lay.group).reshape(tp * C_send)

    # ---- expert side: recv slots -> per-expert queues ---------------
    r_of_slotq, slotq_of_r = _slot(e_recv, E_loc, C_recv, tp * C_send)
    xe = permute_rows(recv.reshape(tp * C_send, d), slotq_of_r, r_of_slotq, E_loc * C_recv)
    ye = _expert_ffn(xe.reshape(E_loc, C_recv, d), wg, wu, wd)
    back = permute_rows(ye.reshape(E_loc * C_recv, d), r_of_slotq, slotq_of_r, tp * C_send)

    # ---- reverse all-to-all + combine ---------------------------------
    ret = collectives.all_to_all(back.reshape(tp, C_send, d), lay.group).reshape(tp * C_send, d)
    y_pairs = permute_rows(ret, s_of_pair, pair_of_s, T_chip * k)
    w = (top_p.reshape(T_chip * k) * (s_of_pair < tp * C_send)).to(cdt)
    y = torch.sum((y_pairs * w[:, None]).reshape(T_chip, k, d), dim=1)
    aux = lay.sum_all(aux) / (lay.dp * tp)
    y = DTensor.from_local(y.reshape(x_loc.shape), mesh, x_pl, run_check=False)
    return MoEOut(y, shd.replicate(aux.float(), mesh))


def moe_apply_dense(params, x: torch.Tensor, cfg: ModelConfig) -> MoEOut:
    """Single-device / no-EP path: global-capacity slotting. On a device
    mesh (a model axis of 1, or one that does not divide the experts) the
    sort, bincount and index writes have no DTensor rule: the layer runs
    whole on every rank on gathered tokens and parameters (`local_map`,
    replicated in and out), the reference's global-capacity semantics."""
    if shd.is_dtensor(x):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map

        mesh = x.device_mesh
        rep = [Replicate()] * mesh.ndim
        names = ("router", "w_gate", "w_up", "w_down")
        fn = local_map(lambda xx, *ws: tuple(moe_apply_dense(dict(zip(names, ws)), xx, cfg)),
                       out_placements=(rep, rep), in_placements=(rep,) * 5,
                       device_mesh=mesh, redistribute_inputs=True)
        y, aux = fn(x, *(shd.replicate(params[n], mesh) for n in names))
        return MoEOut(y, aux)
    cdt = dt(cfg, "compute")
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = max(8, int(cfg.capacity_factor * T * k / E))
    C = -(-C // 8) * 8
    xt = x.reshape(T, d)
    top_p, top_e, aux = _route(params, xt, E, k)

    # --- sort-based slot assignment: all 1-D integer work ---
    slot_of_pair, pair_of_slot = _slot(top_e.reshape(T * k), E, C, T * k)

    # --- dispatch: gather pair rows into (E, C, d) slots ---
    xp = torch.repeat_interleave(xt.to(cdt), k, dim=0)  # (T*k, d)
    xe = permute_rows(xp, pair_of_slot, slot_of_pair, E * C).reshape(E, C, d)

    # --- expert FFN, batched over E ---
    ye = _expert_ffn(xe, params["w_gate"].to(cdt), params["w_up"].to(cdt),
                     params["w_down"].to(cdt)).reshape(E * C, d)

    # --- combine: gather each pair's slot row; dropped pairs -> zero row ---
    ye_pairs = permute_rows(ye, slot_of_pair, pair_of_slot, T * k)  # (T*k, d)
    w = (top_p.reshape(T * k) * (slot_of_pair < E * C)).to(cdt)
    y = torch.sum((ye_pairs * w[:, None]).reshape(T, k, d), dim=1)
    return MoEOut(y.reshape(B, S, d), aux.float())
