"""Mixture-of-Experts FFN with permutation-gather token dispatch
(counterpart of `repro.models.moe`, its single-device path).

  * Dispatch and combine are row gathers through a precomputed
    slot <-> (token, choice) permutation, wrapped in an autograd function
    whose backward is a gather by the inverse permutation: the mapping is
    injective, so no scatter-add appears in either pass.
  * Slot assignment is sort-based (a stable argsort over expert ids and
    each expert's segment start), so no (T, E) cumsum tensor exists.
  * The router runs in float32, breaks a tie between two probabilities
    toward the lower expert id (as `lax.top_k` does) and gives a
    Switch-style load-balance aux loss.

Capacity is global: C = max(8, int(cf T k / E)) rounded up to 8 slots an
expert; a (token, choice) pair past its expert's C slots is dropped and
contributes a zero row. The reference's two expert-parallel paths (one
psum over the model axis, or an all-to-all) need a device mesh and wait
for `parallel/sharding`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dt, normal

WAITS_FOR = "parallel/sharding"


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
    ce = torch.bincount(top_e[:, 0], minlength=E).float() / T
    aux = E * torch.sum(me * ce)
    return top_p, top_e, aux


def _expert_ffn(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: xe (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    return torch.bmm(h, wd)


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig) -> MoEOut:
    """x: (B, S, d) -> (B, S, d). With no device mesh (the port has none
    yet) the reference takes the dense gather path, as here."""
    return moe_apply_dense(params, x, cfg)


def moe_apply_ep(params, x: torch.Tensor, cfg: ModelConfig, mesh) -> MoEOut:
    """The reference's expert-parallel path (one psum over the model axis)."""
    raise NotImplementedError(f"expert-parallel MoE (one psum over the model axis) waits "
                              f"for {WAITS_FOR}")


def moe_apply_ep_a2a(params, x: torch.Tensor, cfg: ModelConfig, mesh) -> MoEOut:
    """The reference's expert-parallel path through an all-to-all."""
    raise NotImplementedError(f"expert-parallel MoE (all-to-all dispatch) waits for "
                              f"{WAITS_FOR}")


def moe_apply_dense(params, x: torch.Tensor, cfg: ModelConfig) -> MoEOut:
    """Single-device path: global-capacity slotting."""
    cdt = dt(cfg, "compute")
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = max(8, int(cfg.capacity_factor * T * k / E))
    C = -(-C // 8) * 8
    xt = x.reshape(T, d)
    top_p, top_e, aux = _route(params, xt, E, k)

    # --- sort-based slot assignment: all 1-D integer work ---
    flat_e = top_e.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)  # (T*k,)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))  # (E,)
    pos_sorted = torch.arange(T * k, device=x.device) - seg_start[sorted_e]
    keep_sorted = pos_sorted < C
    slot_sorted = torch.where(keep_sorted, sorted_e * C + pos_sorted, E * C)
    # the slot of each (token, choice) pair, in pair order
    slot_of_pair = torch.empty_like(slot_sorted)
    slot_of_pair[order] = slot_sorted
    # the inverse: which pair fills each slot (sentinel T*k = empty); the
    # dropped pairs write the extra sentinel row, cut off after
    pair_of_slot = torch.full((E * C + 1,), T * k, dtype=order.dtype, device=x.device)
    pair_of_slot[slot_sorted] = order
    pair_of_slot = pair_of_slot[:E * C]

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
