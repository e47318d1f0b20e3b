"""Grouped-query attention with blockwise (flash-style) softmax, sliding
windows, and ring-buffer KV caches (counterpart of
`repro.models.attention`, the reference's algorithm in plain PyTorch).

  * Train/prefill attention is blockwise: an online softmax over
    (q-block, kv-block) pairs, the pair list built statically as the lower
    block-triangle (causal) or a clipped band (sliding window), so the work
    is about causal-optimal.
  * Scores and the PV accumulator are float32, as the reference's einsums
    ask with preferred_element_type=float32: the blocks are widened to
    float32 before each product. A bfloat16 (or float16) value is exact in
    float32, and in TF32, so the product is the reference's
    low-precision-in, float32-accumulate one.
  * Decode uses a KV cache with absolute positions stored per slot;
    windowed layers get a ring buffer of exactly `window` slots. The
    decode step writes its slot in place: the reference's serve step
    donates the states it is given, so no caller keeps the old ones.

This is the reference's algorithm, not a fused attention kernel: a faster
attention (`scaled_dot_product_attention` or a kernel of its own) is a
later performance change.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, dt

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 512
NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, device, d: int | None = None, *, cross: bool = False):
    """wq, wk, wv, wo from width d (cfg.d_model by default). `cross` is the
    reference's flag for a cross-attention block: its projections are the
    same four, the keys and values taken from the encoder's output."""
    d = d or cfg.d_model
    hd = cfg.resolved_head_dim()
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, d, H * hd, cfg, device),
        "wk": dense_init(gen, d, Kv * hd, cfg, device),
        "wv": dense_init(gen, d, Kv * hd, cfg, device),
        "wo": dense_init(gen, H * hd, d, cfg, device, scale=(H * hd) ** -0.5),
    }


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_slots, Kv, hd) — roped keys
    v: torch.Tensor  # (B, S_slots, Kv, hd)
    pos: torch.Tensor  # (B, S_slots) int32 absolute position per slot; -1 = empty


def _qkv(params, x, positions, cfg: ModelConfig, tp: int = 1):
    """Projections + RoPE. Query heads are flat-padded with zero heads to
    cfg.padded_heads(tp); `head_to_kv_map` routes each (possibly padded)
    query head to its kv head inside blockwise_attention, and the pads are
    sliced off before w_o. The port has no tensor parallelism yet (tp = 1,
    no pad), so the reference's sharding constraints have no counterpart."""
    cdt = dt(cfg, "compute")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    Hp = cfg.padded_heads(tp)
    x = x.to(cdt)
    q = (x @ params["wq"].to(cdt)).reshape(B, S, H, hd)
    if Hp != H:
        q = torch.nn.functional.pad(q, (0, 0, 0, Hp - H))
    k = (x @ params["wk"].to(cdt)).reshape(B, S, Kv, hd)
    v = (x @ params["wv"].to(cdt)).reshape(B, S, Kv, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def head_to_kv_map(cfg: ModelConfig, tp: int) -> np.ndarray:
    """Static (Hp,) map: query head -> kv head (pads point at kv head 0)."""
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    G = H // Kv
    Hp = cfg.padded_heads(tp)
    return np.asarray([h // G if h < H else 0 for h in range(Hp)], np.int32)


def _unpad_heads(out_flat: torch.Tensor, cfg: ModelConfig, tp: int) -> torch.Tensor:
    """(.., Hp*hd) -> (.., H*hd): drop flat-padded query heads before w_o."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim()
    Hp = cfg.padded_heads(tp)
    if Hp == H:
        return out_flat
    lead = out_flat.shape[:-1]
    return out_flat.reshape(*lead, Hp, hd)[..., :H, :].reshape(*lead, H * hd)


def _pair_list(n_q: int, n_kv: int, n_kv_per_q: Optional[int], causal: bool) -> np.ndarray:
    """Static (iq, ikv) block pairs: full grid (bidirectional/cross), lower
    triangle (causal), or a clipped band ending at the diagonal (windowed)."""
    pairs = []
    for iq in range(n_q):
        if not causal:
            lo, hi = 0, n_kv - 1
        else:
            lo = 0 if n_kv_per_q is None else max(0, iq - n_kv_per_q + 1)
            hi = iq
        for ikv in range(lo, hi + 1):
            pairs.append((iq, ikv))
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, hd) — H already padded by _qkv
    k: torch.Tensor,  # (B, S_kv, Kv, hd)
    v: torch.Tensor,
    q_positions: torch.Tensor,  # (B, S)
    kv_positions: torch.Tensor,  # (B, S_kv)
    *,
    window: int,  # -1 = full causal
    causal: bool = True,  # False: bidirectional/cross attention
    block_q: int = DEFAULT_BLOCK_Q,
    block_kv: int = DEFAULT_BLOCK_KV,
    mode: str = "train",  # "train": per-step checkpointed; "infer": pair loop
    kv_map: Optional[np.ndarray] = None,  # (H,) query-head -> kv-head
) -> torch.Tensor:
    """KV heads are gathered up to the (padded) query-head axis before the
    block loop, so every block tensor has a single head axis."""
    B, S, H, hd = q.shape
    S_kv, Kv = k.shape[1], k.shape[2]
    if kv_map is None:
        kv_map = np.repeat(np.arange(Kv, dtype=np.int32), H // Kv)
    if len(kv_map) != H:
        raise ValueError(f"kv_map has {len(kv_map)} heads, q has {H}")
    if Kv != H or not np.array_equal(kv_map, np.arange(H)):
        idx = torch.as_tensor(kv_map, dtype=torch.long, device=k.device)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
    bq = min(block_q, S)
    bk = min(block_kv, S_kv)
    pad_q = (-S) % bq  # uneven q: pad + slice off
    S_orig = S
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = torch.nn.functional.pad(q_positions, (0, pad_q), value=-1)
        S += pad_q
    pad_kv = (-S_kv) % bk  # uneven kv: pad + mask (padded slots carry pos -1)
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad_kv), value=-1)
        S_kv += pad_kv
    n_q, n_kv = S // bq, S_kv // bk
    # fold the softmax scale into q, rounded to q's dtype as the reference does
    q = q * torch.tensor(hd**-0.5, dtype=q.dtype, device=q.device)

    qb = q.reshape(B, n_q, bq, H, hd).permute(1, 0, 3, 2, 4)  # (n_q, B, H, bq, hd)
    kb = k.reshape(B, n_kv, bk, H, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, n_kv, bk, H, hd).permute(1, 0, 3, 2, 4)
    qpb = q_positions.reshape(B, n_q, bq).transpose(0, 1)  # (n_q, B, bq)
    kpb = kv_positions.reshape(B, n_kv, bk).transpose(0, 1)

    n_kv_per_q = None if window < 0 else (window + bq - 1) // bk + 1

    def block_scores(qi, ki, qp, kp):
        s = torch.matmul(qi.float(), ki.float().transpose(-1, -2))  # float32 scores
        ok = kp[:, None, :] >= 0  # kv-slot validity (padded slots carry -1)
        if causal:
            ok = ok & (qp[:, :, None] >= kp[:, None, :])
        if window > 0:
            ok = ok & (qp[:, :, None] - kp[:, None, :] < window)
        return torch.where(ok[:, None, :, :], s, NEG_INF)

    def online_update(mi, li, ai, qi, ki, vi, qp, kp):
        s = block_scores(qi, ki, qp, kp)
        m_new = torch.maximum(mi, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(mi - m_new)
        l_new = li * corr + p.sum(dim=-1)
        # p rounded to v's dtype, then a float32-accumulated product
        a_new = ai * corr[..., None] + torch.matmul(p.to(vi.dtype).float(), vi.float())
        return m_new, l_new, a_new

    m0 = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=q.device)
    l0 = torch.zeros((B, H, bq), dtype=torch.float32, device=q.device)
    a0 = torch.zeros((B, H, bq, hd), dtype=torch.float32, device=q.device)
    if mode == "train":
        # one kv loop per q block, each step checkpointed: the backward
        # recomputes each (bq, bk) probability block instead of saving it
        outs = []
        for iq in range(n_q):
            if not causal:
                kv_idx = range(n_kv)
            else:
                lo = 0 if n_kv_per_q is None else max(0, iq - n_kv_per_q + 1)
                kv_idx = range(lo, iq + 1)
            m, l, acc = m0, l0, a0
            for ikv in kv_idx:
                args = (m, l, acc, qb[iq], kb[ikv], vb[ikv], qpb[iq], kpb[ikv])
                if torch.is_grad_enabled():
                    m, l, acc = checkpoint(online_update, *args, use_reentrant=False)
                else:
                    m, l, acc = online_update(*args)
            outs.append(acc / torch.clamp(l[..., None], min=1e-30))
        out = torch.stack(outs)  # (n_q, B, H, bq, hd)
    elif mode == "infer":
        # one loop over the static (iq, ikv) pair list
        ms, ls_, accs = [m0] * n_q, [l0] * n_q, [a0] * n_q
        for iq, ikv in _pair_list(n_q, n_kv, n_kv_per_q, causal):
            ms[iq], ls_[iq], accs[iq] = online_update(
                ms[iq], ls_[iq], accs[iq], qb[iq], kb[ikv], vb[ikv], qpb[iq], kpb[ikv])
        out = torch.stack([a / torch.clamp(l[..., None], min=1e-30)
                           for a, l in zip(accs, ls_)])
    else:
        raise ValueError(f"mode must be 'train' or 'infer', got {mode!r}")

    out = out.permute(1, 0, 3, 2, 4).reshape(B, S, H * hd)  # (B, S, H*hd)
    return out[:, :S_orig].to(q.dtype)


def attn_apply_train(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                     *, window: int = -1, tp: int = 1, return_kv: bool = False):
    """Full-sequence attention (training / prefill)."""
    q, k, v = _qkv(params, x, positions, cfg, tp)
    # prefill (return_kv) is forward-only: the pair-loop layout
    out = blockwise_attention(q, k, v, positions, positions, window=window,
                              mode="infer" if return_kv else "train",
                              kv_map=head_to_kv_map(cfg, tp))
    out = _unpad_heads(out, cfg, tp) @ params["wo"].to(dt(cfg, "compute"))
    if return_kv:
        return out, (k, v)
    return out


def init_cache(cfg: ModelConfig, B: int, S_ctx: int, window: int, dtype,
               device) -> KVCache:
    """Cache for one layer. Windowed layers allocate only `window` slots."""
    slots = S_ctx if window < 0 else min(window, S_ctx)
    hd = cfg.resolved_head_dim()
    return KVCache(
        k=torch.zeros((B, slots, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        v=torch.zeros((B, slots, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        pos=torch.full((B, slots), -1, dtype=torch.int32, device=device),
    )


def attn_apply_decode(params, x: torch.Tensor, cur_pos, cache: KVCache, cfg: ModelConfig,
                      *, window: int = -1):
    """One-token decode against the cache; returns (out, cache). x: (B, 1, d);
    cur_pos: the new token's absolute position (an int or a 0-dim integer
    tensor). The cache's slot cur_pos % slots is written in place."""
    cdt = dt(cfg, "compute")
    B = x.shape[0]
    hd = cfg.resolved_head_dim()
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    G = H // Kv  # decode: no padded heads
    cur = torch.as_tensor(cur_pos, dtype=torch.long, device=x.device).reshape(())
    positions = cur.expand(B, 1)
    q, k_new, v_new = _qkv(params, x, positions, cfg, tp=1)

    slots = cache.k.shape[1]
    slot = (cur % slots).reshape(1)  # identity when slots covers the context
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    cache.pos.index_fill_(1, slot, cur.to(torch.int32))

    qg = q.reshape(B, Kv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), cache.k.to(cdt).float()) * hd**-0.5
    valid = (cache.pos >= 0) & (cache.pos <= cur)
    if window > 0:
        valid = valid & (cur - cache.pos < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cdt).float(), cache.v.to(cdt).float())
    out = out.reshape(B, 1, H * hd).to(cdt) @ params["wo"].to(cdt)
    return out, cache


def cache_from_prefill(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, window: int) -> KVCache:
    """Fill a pre-allocated decode cache from prefill KV, in place.

    Windowed layers keep only the last `slots` positions, ring-indexed by
    absolute position (so later decode steps write consistently)."""
    B, S = positions.shape
    slots = cache.k.shape[1]
    if S <= slots:
        cache.k[:, :S] = k.to(cache.k.dtype)
        cache.v[:, :S] = v.to(cache.v.dtype)
        cache.pos[:, :S] = positions.to(torch.int32)
        return cache
    k_tail, v_tail, p_tail = k[:, -slots:], v[:, -slots:], positions[:, -slots:]
    idx = (p_tail % slots).long()  # (B, slots)
    bidx = torch.arange(B, device=idx.device)[:, None]
    cache.k[bidx, idx] = k_tail.to(cache.k.dtype)
    cache.v[bidx, idx] = v_tail.to(cache.v.dtype)
    cache.pos[bidx, idx] = p_tail.to(torch.int32)
    return cache
