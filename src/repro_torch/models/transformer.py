"""Decoder-only LM assembly with pattern-period layer segments
(counterpart of `repro.models.transformer`).

Heterogeneous layer patterns (gemma3's 5 local : 1 global, recurrentgemma's
rglru rglru attn) tile across num_layers and split into *segments* of
repeated periods —

    gemma3-4b (34L, pattern LLLLLG):  [5 x (L L L L L G)] + [1 x (L L L L)]

Parameters are stacked (repeat, *param) per segment, as in the reference,
so its parameter trees and checkpoints cross one to one (`convert`). The
reference scans each segment; here a loop over the repeats runs the
period's layers on each repeat's slice of the stacked leaves (one
`unbind` a leaf, so the backward stacks the slices' gradients once).
Under cfg.remat in training, each repeat runs under
`torch.utils.checkpoint`, as the reference checkpoints its scan body.

A layer's temporal mixer is attention, RG-LRU (`models.rglru`) or the
RWKV-6 time-mix (`models.rwkv6`, with its channel-mix in place of the
MLP); a MoE config's FFN is `models.moe` (plus the dense MLP as a
residual where cfg.moe_dense_residual). A `frontend_embeds` batch entry
(the vlm family) is a multimodal prefix before the tokens. The
encoder-decoder family is `models.encdec`.

Every entry point takes the reference's `constrain` hook
(`parallel.sharding.make_constrain`): on a device mesh the tensors are
DTensors and the hook pins the residual stream, the attention heads and
the FFN hidden to the rules table's placements; off any mesh it is the
identity.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (chunked_softmax_xent, dt, embed_init,
                                       embed_lookup, layer_loop, logits_from,
                                       mlp_apply, mlp_init, rmsnorm, rmsnorm_init,
                                       unembed_init)
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import no_constrain

Tree = Any
AUX_LOSS_WEIGHT = 0.01


class Segment(NamedTuple):
    repeat: int
    windows: Tuple[int, ...]  # per position in the period
    mixers: Tuple[str, ...]  # "attn" | "rglru" | "rwkv"


def segments(cfg: ModelConfig) -> List[Segment]:
    windows = cfg.layer_windows()
    mixers = cfg.layer_mixers()
    L = cfg.num_layers
    if not cfg.scan_layers:  # fully unrolled: one repeat-1 segment per layer
        return [Segment(1, (windows[i],), (mixers[i],)) for i in range(L)]
    p = max(len(cfg.window_pattern), len(cfg.mixer_pattern))
    k, r = divmod(L, p)
    segs = []
    if k:
        segs.append(Segment(k, windows[:p], mixers[:p]))
    if r:
        segs.append(Segment(1, windows[L - r:], mixers[L - r:]))
    return segs


# ---------------------------------------------------------------------------
# per-layer init/apply
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ModelConfig, mixer: str, device) -> Tree:
    d = cfg.d_model
    p: Dict[str, Tree] = {"ln1": rmsnorm_init(d, cfg, device),
                          "ln2": rmsnorm_init(d, cfg, device)}
    if mixer == "attn":
        p["attn"] = attn.attn_init(gen, cfg, device)
    elif mixer == "rglru":
        p["rglru"] = rglru_mod.rglru_init(gen, cfg, device)
    elif mixer == "rwkv":
        p["rwkv"] = rwkv_mod.timemix_init(gen, cfg, device)
    else:
        raise ValueError(mixer)
    if mixer == "rwkv":
        p["cmix"] = rwkv_mod.chanmix_init(gen, cfg, device)
    elif cfg.num_experts:
        p["moe"] = moe_mod.moe_init(gen, cfg, device)
        if cfg.moe_dense_residual:
            p["mlp"] = mlp_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


class LayerState(NamedTuple):
    """Decode-time state for one layer (exactly one of the first three
    fields is set, by the layer's mixer; rwkv layers also carry the
    channel-mix's last token)."""

    kv: Optional[attn.KVCache]
    rglru: Optional[rglru_mod.RGLRUState]
    rwkv_tm: Optional[rwkv_mod.TimeMixState]
    cmix_prev: Optional[torch.Tensor]


def _layer_state_init(cfg: ModelConfig, mixer: str, window: int, B: int, S_ctx: int,
                      device) -> LayerState:
    cdt = dt(cfg, "compute")
    if mixer == "attn":
        return LayerState(attn.init_cache(cfg, B, S_ctx, window, cdt, device), None, None, None)
    if mixer == "rglru":
        return LayerState(None, rglru_mod.rglru_state_init(cfg, B, cdt, device), None, None)
    return LayerState(None, None, rwkv_mod.timemix_state_init(cfg, B, cdt, device),
                      torch.zeros((B, cfg.d_model), dtype=cdt, device=device))


def _layer_apply(params: Tree, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                 *, mixer: str, window: int, mode: str, state: Optional[LayerState],
                 cur_pos, constrain=no_constrain) -> tuple:
    """Returns (x_out, new_state, aux_loss). mode "train" with a state is the
    prefill; "decode" runs one token against the state."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the norm's output pinned to the sequence-sharded layout, so the
    # float32 norm runs on 1/tp of the sequence
    h = constrain(rmsnorm(params["ln1"], x, cfg.norm_eps), "act_embed")
    new_state = state
    if mixer == "attn":
        if mode == "train":
            if state is not None:  # prefill: also build the cache
                out, (k, v) = attn.attn_apply_train(params["attn"], h, positions, cfg,
                                                    window=window, constrain=constrain,
                                                    return_kv=True)
                new_state = state._replace(kv=attn.cache_from_prefill(state.kv, k, v,
                                                                      positions, window))
            else:
                out = attn.attn_apply_train(params["attn"], h, positions, cfg, window=window,
                                            constrain=constrain)
        else:
            out, kv = attn.attn_apply_decode(params["attn"], h, cur_pos, state.kv, cfg,
                                             window=window, constrain=constrain)
            new_state = state._replace(kv=kv)
    elif mixer == "rglru":
        st = state.rglru if state is not None else rglru_mod.rglru_state_init(
            cfg, x.shape[0], x.dtype, x.device)
        fn = rglru_mod.rglru_apply_train if mode == "train" else rglru_mod.rglru_apply_decode
        out, st = fn(params["rglru"], h, st, cfg, constrain=constrain)
        new_state = state._replace(rglru=st) if state is not None else None
    elif mixer == "rwkv":
        st = state.rwkv_tm if state is not None else rwkv_mod.timemix_state_init(
            cfg, x.shape[0], x.dtype, x.device)
        fn = rwkv_mod.timemix_apply_chunked if mode == "train" else rwkv_mod.timemix_apply_decode
        out, st = fn(params["rwkv"], h, st, cfg, constrain=constrain)
        new_state = state._replace(rwkv_tm=st) if state is not None else None
    else:
        raise ValueError(mixer)
    x = constrain(x + shd.grad_rows_whole(out.to(x.dtype)), "act_embed")

    h = constrain(rmsnorm(params["ln2"], x, cfg.norm_eps), "act_embed")
    if mixer == "rwkv":
        prev = state.cmix_prev if state is not None else torch.zeros_like(h[:, -1])
        out, prev = rwkv_mod.chanmix_apply(params["cmix"], h, prev, cfg)
        if state is not None:
            new_state = new_state._replace(cmix_prev=prev)
    elif cfg.num_experts:
        moe_out = moe_mod.moe_apply(params["moe"], h, cfg, constrain=constrain)
        out, aux = moe_out.y, moe_out.aux_loss
        if cfg.moe_dense_residual:
            out = out + mlp_apply(params["mlp"], h, cfg, constrain=constrain)
    else:
        out = mlp_apply(params["mlp"], h, cfg, constrain=constrain)
    x = x + shd.grad_rows_whole(out.to(x.dtype))
    return constrain(x, "act_embed"), new_state, aux


# ---------------------------------------------------------------------------
# stacked leaves
# ---------------------------------------------------------------------------

def _stack(trees: list) -> Tree:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if len(trees) == 1:  # a lone layer: a (1, ...) view, no second copy of it
        return first.unsqueeze(0)
    return torch.stack(trees)


def _unstack(tree: Tree, n: int) -> list:
    """The n slices of a tree of stacked (n, ...) leaves, each leaf split by
    one `unbind`."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _state_map(fn, st):
    """`fn` over the tensors of a (possibly nested) state NamedTuple; None
    fields stay None."""
    if st is None:
        return None
    if isinstance(st, tuple):
        return type(st)(*(_state_map(fn, t) for t in st))
    return fn(st)


def _store(view, new) -> None:
    """Write a layer's new state into its slice of the stacked states; a
    field advanced in place (a KV cache) is that slice already."""
    if isinstance(view, tuple):
        for v, n in zip(view, new):
            _store(v, n)
    elif view is not None and view is not new:
        view.copy_(new)


# ---------------------------------------------------------------------------
# whole-model init / apply
# ---------------------------------------------------------------------------

def _resolve(device) -> torch.device:
    """The meta device as it is; any other through `device.resolve` (which
    raises on a CUDA device the host does not have)."""
    device = torch.device(device)
    return device if device.type == "meta" else _device.resolve(device)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Tree:
    """Random parameters from `seed`, drawn on `device` (on the meta device:
    the shapes and dtypes alone, nothing allocated). The draws are the
    port's own: `jax.random` has no torch counterpart, so trees cross from
    the reference through `convert`, not through a seed."""
    device = _resolve(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    params: Dict[str, Tree] = {"embed": embed_init(gen, cfg, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = unembed_init(gen, cfg, device)
    params["final_norm"] = rmsnorm_init(cfg.d_model, cfg, device)
    for si, seg in enumerate(segments(cfg)):
        rows = [[_layer_init(gen, cfg, seg.mixers[j], device) for j in range(len(seg.windows))]
                for _ in range(seg.repeat)]
        params[f"seg{si}"] = tuple(_stack([rows[r][j] for r in range(seg.repeat)])
                                   for j in range(len(seg.windows)))
    return params


def _backbone(params: Tree, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
              *, mode: str, states: Optional[Tree], cur_pos, constrain=no_constrain):
    """Runs all segments. states (if given) mirrors the segment structure:
    states[f"seg{si}"] = tuple over period positions of stacked LayerStates,
    filled (prefill) or advanced (decode) in place: KV caches by the
    attention's own writes, recurrent states copied into their slices."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, seg in enumerate(segments(cfg)):
        per_pos = [_unstack(p, seg.repeat) for p in params[f"seg{si}"]]  # [j][r]
        seg_state = states[f"seg{si}"] if states is not None else None

        def body(xc, r, p, _seg=seg, _seg_state=seg_state):
            aux_r = torch.zeros((), dtype=torch.float32, device=xc.device)
            for j in range(len(_seg.windows)):
                st = None
                if _seg_state is not None:  # repeat r's slice of the stacked state
                    st = _state_map(lambda t: t[r], _seg_state[j])
                xc, new_st, aux = _layer_apply(p[j], xc, positions, cfg,
                                               mixer=_seg.mixers[j], window=_seg.windows[j],
                                               mode=mode, state=st, cur_pos=cur_pos,
                                               constrain=constrain)
                if st is not None:
                    _store(st, new_st)
                aux_r = aux_r + aux
            return xc, aux_r

        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()

        def step(carry, r, p, _body=body, _remat=remat):
            # the reference's optimization_barrier (which keeps XLA from
            # widening the saved residual) has no eager counterpart: eager
            # autograd saves each layer's input in its own dtype
            xc, aux_acc = carry
            if _remat:
                xc, aux = checkpoint(_body, xc, r, p, use_reentrant=False)
            else:
                xc, aux = _body(xc, r, p)
            return xc, aux_acc + aux

        x, aux_total = layer_loop(step, (x, aux_total), seg.repeat,
                                  lambda r, _per_pos=per_pos: [pj[r] for pj in _per_pos])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, states, aux_total


def init_decode_state(cfg: ModelConfig, B: int, S_ctx: int, *, device="cuda") -> Tree:
    """Stacked per-segment decode states (KV caches with positions -1 =
    empty, zero recurrent states)."""
    device = _resolve(device)
    states: Dict[str, Tree] = {}
    for si, seg in enumerate(segments(cfg)):
        per_pos = []
        for j in range(len(seg.windows)):
            one = _layer_state_init(cfg, seg.mixers[j], seg.windows[j], B, S_ctx, device)
            per_pos.append(_state_map(
                lambda t, n=seg.repeat: t.unsqueeze(0).repeat(n, *([1] * t.ndim)), one))
        states[f"seg{si}"] = tuple(per_pos)
    return states


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _input_embeddings(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token embeddings, after the multimodal prefix of `frontend_embeds`
    (stub frontends) where the batch has one, scaled by sqrt(d) as the
    token embeddings are."""
    x = embed_lookup(params["embed"], batch["tokens"], cfg)
    if "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(x.dtype) * (cfg.d_model**0.5)
        x = torch.cat([fe, x], dim=1)
    return x


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               constrain=no_constrain) -> tuple:
    """Next-token CE over the text positions (+ the MoE aux term, 0
    without experts). batch: tokens (B, S) [, frontend_embeds (B, P, d)].
    Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    x = constrain(_input_embeddings(params, batch, cfg), "act_embed")
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, _, aux = _backbone(params, x, positions, cfg, mode="train", states=None, cur_pos=None,
                          constrain=constrain)
    x = x[:, S - tokens.shape[1]:]  # the text after the frontend prefix
    labels = shd.pad(tokens[:, 1:], (0, 1))
    mask = batch.get("loss_mask")
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device) \
        if mask is None else mask.to(torch.float32).clone()
    mask[:, -1] = 0.0
    ce = chunked_softmax_xent(x, labels, mask, params["embed"], params.get("unembed"), cfg,
                              constrain=constrain)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            constrain=no_constrain, total_slots: int | None = None):
    """Full-context forward building decode caches; returns (last_logits,
    states). total_slots: KV-cache capacity (>= prefill length + planned
    decode steps); defaults to prefill length + 1. On a device mesh the
    states are placed by the state rules."""
    x = _input_embeddings(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    states = shd.init_states(
        lambda dev: init_decode_state(cfg, B, total_slots or S + 1, device=dev), x.device,
        constrain.mesh)
    x, states, _ = _backbone(params, x, positions, cfg, mode="train", states=states,
                             cur_pos=None, constrain=constrain)
    logits = logits_from(params["embed"], params.get("unembed"), x[:, -1:, :], cfg)
    return logits[:, 0], states


def decode_step(params, tokens: torch.Tensor, cur_pos, states: Tree, cfg: ModelConfig,
                constrain=no_constrain):
    """One-token serve step. tokens: (B, 1); cur_pos: absolute position (an
    int or a 0-dim integer tensor). Returns (logits (B, V) float32, states),
    the states advanced in place."""
    x = embed_lookup(params["embed"], tokens, cfg)
    B = x.shape[0]
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=x.device).reshape(())
    positions = cur.expand(B, 1)
    x, states, _ = _backbone(params, x, positions, cfg, mode="decode", states=states,
                             cur_pos=cur, constrain=constrain)
    logits = logits_from(params["embed"], params.get("unembed"), x, cfg)
    return constrain(logits[:, 0].float(), "logits"), states
