"""Encoder-decoder transformer, the whisper-small family (counterpart of
`repro.models.encdec`).

The mel-spectrogram conv frontend is a stub (`models.frontends`): the
batch carries precomputed post-conv frame embeddings (B, frames, d); the
encoder is a bidirectional transformer over them and the decoder adds
cross-attention. RoPE stands in for whisper's learned positions, as in the
reference.

Layers are homogeneous, so each stack is one (L, ...) tree of stacked
leaves, run layer by layer (under `torch.utils.checkpoint` when cfg.remat
and autograd records, as the reference checkpoints its scan bodies). The
decode state keeps each layer's self-attention KV cache and the
cross-attention K/V, computed once at prefill; decode writes its KV slot
in place. The `constrain` hooks sit where the reference's do (the
residual stream after each block, the cross-attention's queries, the
decode logits); on a device mesh the decode state is placed by the state
rules.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_rope, chunked_softmax_xent, dt,
                                       embed_init, embed_lookup, layer_loop,
                                       logits_from, mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.transformer import Tree, _resolve, _stack, _unstack
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import no_constrain


def _enc_layer_init(gen, cfg: ModelConfig, device) -> Tree:
    return {"ln1": rmsnorm_init(cfg.d_model, cfg, device),
            "attn": attn.attn_init(gen, cfg, device),
            "ln2": rmsnorm_init(cfg.d_model, cfg, device),
            "mlp": mlp_init(gen, cfg, device)}


def _dec_layer_init(gen, cfg: ModelConfig, device) -> Tree:
    return {"ln1": rmsnorm_init(cfg.d_model, cfg, device),
            "attn": attn.attn_init(gen, cfg, device),
            "lnx": rmsnorm_init(cfg.d_model, cfg, device),
            "xattn": attn.attn_init(gen, cfg, device, cross=True),
            "ln2": rmsnorm_init(cfg.d_model, cfg, device),
            "mlp": mlp_init(gen, cfg, device)}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Tree:
    """Random parameters from `seed` on `device` (on the meta device, shapes
    and dtypes only). Trees cross from the reference through `convert`."""
    device = _resolve(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return {
        "embed": embed_init(gen, cfg, device),
        "enc_layers": _stack([_enc_layer_init(gen, cfg, device)
                              for _ in range(cfg.encoder_layers)]),
        "enc_norm": rmsnorm_init(cfg.d_model, cfg, device),
        "dec_layers": _stack([_dec_layer_init(gen, cfg, device)
                              for _ in range(cfg.num_layers)]),
        "dec_norm": rmsnorm_init(cfg.d_model, cfg, device),
    }


def _frame_positions(B: int, F_: int, device) -> torch.Tensor:
    return torch.arange(F_, dtype=torch.int32, device=device)[None].expand(B, F_)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, constrain=no_constrain,
           mode: str = "train") -> torch.Tensor:
    """frames: (B, F, d) stub-frontend embeddings -> (B, F, d) encodings."""
    B, F_, _ = frames.shape
    x = frames.to(dt(cfg, "compute"))
    positions = _frame_positions(B, F_, x.device)
    tp = constrain.tp
    kv_map = attn.head_to_kv_map(cfg, tp)
    layers = _unstack(params["enc_layers"], cfg.encoder_layers)

    def body(xc, i, layer):
        h = rmsnorm(layer["ln1"], xc, cfg.norm_eps)
        q, k, v = attn._qkv(layer["attn"], h, positions, cfg, tp, constrain)
        out = attn.blockwise_attention(q, k, v, positions, positions, window=-1,
                                       causal=False, mode=mode, kv_map=kv_map)
        out = attn._unpad_heads(out, cfg, tp) @ layer["attn"]["wo"].to(out.dtype)
        xc = constrain(xc + shd.grad_rows_whole(out.to(xc.dtype)), "act_embed")
        h = rmsnorm(layer["ln2"], xc, cfg.norm_eps)
        out = mlp_apply(layer["mlp"], h, cfg, constrain=constrain)
        xc = xc + shd.grad_rows_whole(out.to(xc.dtype))
        return constrain(xc, "act_embed")

    remat = cfg.remat and torch.is_grad_enabled()
    x = layer_loop(
        lambda xc, i, layer: (checkpoint(body, xc, i, layer, use_reentrant=False) if remat
                              else body(xc, i, layer)),
        x, cfg.encoder_layers, lambda i: layers[i])
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


class DecState(NamedTuple):
    self_kv: attn.KVCache  # stacked (L, ...)
    cross_k: torch.Tensor  # (L, B, F, Kv, hd), computed at prefill
    cross_v: torch.Tensor
    enc_pos: torch.Tensor  # (B, F) int32


def _cross_kv(layer, enc_out: torch.Tensor, enc_pos: torch.Tensor, cfg: ModelConfig):
    cdt = dt(cfg, "compute")
    B, F_, _ = enc_out.shape
    hd = cfg.resolved_head_dim()
    # split_last: on a mesh whose model axis does not divide the kv heads the
    # (Kv * hd) dim is gathered before it is split (whisper's 12 over 16)
    k = shd.split_last(enc_out.to(cdt) @ layer["xattn"]["wk"].to(cdt), (cfg.num_kv_heads, hd))
    v = shd.split_last(enc_out.to(cdt) @ layer["xattn"]["wv"].to(cdt), (cfg.num_kv_heads, hd))
    return apply_rope(k, enc_pos, cfg.rope_theta), v


def _decoder(params, x, positions, enc_out, enc_pos, cfg: ModelConfig, *,
             states: DecState | None, cur_pos, mode: str, constrain=no_constrain):
    """mode "train" without states: training; "train" with states: prefill,
    filling them in place; "decode": one token against them."""
    cdt = dt(cfg, "compute")
    hd = cfg.resolved_head_dim()
    H = cfg.num_heads
    tp = constrain.tp
    Hp = cfg.padded_heads(tp)
    kv_map = attn.head_to_kv_map(cfg, tp)
    layers = _unstack(params["dec_layers"], cfg.num_layers)
    xmode = "train" if (mode == "train" and states is None) else "infer"

    def body(xc, i, ops):
        layer, enc = ops
        kv = None if states is None else attn.KVCache(
            states.self_kv.k[i], states.self_kv.v[i], states.self_kv.pos[i])
        # self attention
        h = rmsnorm(layer["ln1"], xc, cfg.norm_eps)
        if mode == "train":
            if kv is not None:
                out, (k, v) = attn.attn_apply_train(layer["attn"], h, positions, cfg,
                                                    constrain=constrain, return_kv=True)
                attn.cache_from_prefill(kv, k, v, positions, -1)
            else:
                out = attn.attn_apply_train(layer["attn"], h, positions, cfg,
                                            constrain=constrain)
        else:
            out, _ = attn.attn_apply_decode(layer["attn"], h, cur_pos, kv, cfg,
                                            constrain=constrain)
        xc = constrain(xc + shd.grad_rows_whole(out.to(xc.dtype)), "act_embed")

        # cross attention
        h = rmsnorm(layer["lnx"], xc, cfg.norm_eps)
        B, S, _ = h.shape
        q = shd.split_last(h.to(cdt) @ layer["xattn"]["wq"].to(cdt), (H, hd))
        if Hp != H:  # H is then not split (see split_last): the pad is local
            q = shd.pad(q, (0, 0, 0, Hp - H))
        q = constrain(apply_rope(q, positions, cfg.rope_theta), "act_heads")
        if mode == "train":
            kx, vx = _cross_kv(layer, enc, enc_pos, cfg)
            if states is not None:
                states.cross_k[i].copy_(kx)
                states.cross_v[i].copy_(vx)
        else:
            kx, vx = states.cross_k[i], states.cross_v[i]
        out = attn.blockwise_attention(q, kx, vx, positions, enc_pos, window=-1,
                                       causal=False, mode=xmode, kv_map=kv_map)
        out = attn._unpad_heads(out, cfg, tp) @ layer["xattn"]["wo"].to(cdt)
        xc = constrain(xc + shd.grad_rows_whole(out.to(xc.dtype)), "act_embed")

        # mlp
        h = rmsnorm(layer["ln2"], xc, cfg.norm_eps)
        out = mlp_apply(layer["mlp"], h, cfg, constrain=constrain)
        xc = xc + shd.grad_rows_whole(out.to(xc.dtype))
        return constrain(xc, "act_embed")

    remat = cfg.remat and mode == "train" and states is None and torch.is_grad_enabled()
    # the encodings are each repeat's operand too: every layer reads them
    x = layer_loop(
        lambda xc, i, ops: (checkpoint(body, xc, i, ops, use_reentrant=False) if remat
                            else body(xc, i, ops)),
        x, cfg.num_layers, lambda i: (layers[i], enc_out))
    return rmsnorm(params["dec_norm"], x, cfg.norm_eps), states


def _causal_labels(batch: Dict[str, torch.Tensor], device) -> tuple:
    tokens = batch["tokens"]
    labels = shd.pad(tokens[:, 1:], (0, 1))
    mask = batch.get("loss_mask")
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=device) \
        if mask is None else mask.to(torch.float32).clone()
    mask[:, -1] = 0.0
    return labels, mask


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               constrain=no_constrain) -> tuple:
    """Next-token CE of the decoder given the frames. batch: tokens (B, S),
    encoder_frames (B, F, d). Returns (loss, {"ce", "aux"}), aux = 0."""
    enc_out = encode(params, batch["encoder_frames"], cfg, constrain, mode="train")
    B, F_, _ = enc_out.shape
    enc_pos = _frame_positions(B, F_, enc_out.device)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, _ = _decoder(params, x, positions, enc_out, enc_pos, cfg, states=None, cur_pos=None,
                    mode="train", constrain=constrain)
    labels, mask = _causal_labels(batch, x.device)
    ce = chunked_softmax_xent(x, labels, mask, params["embed"], None, cfg,
                              constrain=constrain)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}


def init_decode_state(cfg: ModelConfig, B: int, S_ctx: int, *, device="cuda") -> DecState:
    device = _resolve(device)
    cdt = dt(cfg, "compute")
    hd = cfg.resolved_head_dim()
    L, F_, Kv = cfg.num_layers, cfg.encoder_frames, cfg.num_kv_heads
    one = attn.init_cache(cfg, B, S_ctx, -1, cdt, device)
    return DecState(
        self_kv=attn.KVCache(*(t.unsqueeze(0).repeat(L, *([1] * t.ndim)) for t in one)),
        cross_k=torch.zeros((L, B, F_, Kv, hd), dtype=cdt, device=device),
        cross_v=torch.zeros((L, B, F_, Kv, hd), dtype=cdt, device=device),
        enc_pos=torch.zeros((B, F_), dtype=torch.int32, device=device),
    )


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            constrain=no_constrain, total_slots: int | None = None):
    """Encode the frames and run the prompt, building the decode state;
    returns (last_logits, states). total_slots: self-attention KV capacity
    (defaults to the prompt length + 1)."""
    enc_out = encode(params, batch["encoder_frames"], cfg, constrain, mode="infer")
    B, F_, _ = enc_out.shape
    enc_pos = _frame_positions(B, F_, enc_out.device)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    states = shd.init_states(
        lambda dev: init_decode_state(cfg, B, total_slots or S + 1, device=dev), x.device,
        constrain.mesh)
    states = states._replace(enc_pos=shd.place_like(enc_pos, states.enc_pos))
    x, states = _decoder(params, x, positions, enc_out, enc_pos, cfg, states=states,
                         cur_pos=None, mode="train", constrain=constrain)
    logits = logits_from(params["embed"], None, x[:, -1:, :], cfg)
    return logits[:, 0], states


def decode_step(params, tokens: torch.Tensor, cur_pos, states: DecState, cfg: ModelConfig,
                constrain=no_constrain):
    """One-token serve step; returns (logits (B, V) float32, states), the
    self-attention caches advanced in place."""
    x = embed_lookup(params["embed"], tokens, cfg)
    B = x.shape[0]
    cur = torch.as_tensor(cur_pos, dtype=torch.int32, device=x.device).reshape(())
    positions = cur.expand(B, 1)
    x, states = _decoder(params, x, positions, None, states.enc_pos, cfg, states=states,
                         cur_pos=cur, mode="decode", constrain=constrain)
    logits = logits_from(params["embed"], None, x, cfg)
    return constrain(logits[:, 0].float(), "logits"), states
