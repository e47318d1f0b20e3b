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

On a device mesh (`parallel.sharding`) the tensors are DTensors and the
`constrain` hooks sit where the reference's do: q and k in the
head-sharded layout before RoPE, the blocked q/k/v and the softmax carries
with heads over the model axis. Decode runs flash-decode style over the
cache's slots, which the state rules shard over the model axis: each rank
scores its own slots, and the softmax's max, then its sum and the output,
are all-reduced over the model axis.

This is the reference's algorithm, not a fused attention kernel: a faster
attention (`scaled_dot_product_attention` or a kernel of its own) is a
later performance change.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, dt
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import no_constrain

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


def _qkv(params, x, positions, cfg: ModelConfig, tp: int = 1, constrain=no_constrain):
    """Projections + RoPE. Query heads are flat-padded with zero heads to
    cfg.padded_heads(tp) so the head axis shards evenly over the model
    axis; `head_to_kv_map` routes each (possibly padded) query head to its
    kv head inside blockwise_attention, and the pads are sliced off before
    w_o. q/k are constrained to the head-sharded layout before RoPE, so the
    float32 rotation runs on 1/tp of the heads."""
    cdt = dt(cfg, "compute")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    Hp = cfg.padded_heads(tp)
    x = shd.whole_rows(x.to(cdt))
    # a (H*hd) dim sharded over the model axis splits into (H, hd) only
    # where the axis divides H (DTensor cannot unflatten an uneven shard)
    q = shd.split_last(x @ params["wq"].to(cdt), (H, hd))
    if Hp != H:  # H is then not split (see split_last): the pad is local
        q = shd.pad(q, (0, 0, 0, Hp - H))
    k = shd.split_last(x @ params["wk"].to(cdt), (Kv, hd))
    v = shd.split_last(x @ params["wv"].to(cdt), (Kv, hd))
    q = apply_rope(constrain(q, "act_heads"), positions, cfg.rope_theta)
    k = apply_rope(constrain(k, "act_kv_heads"), positions, cfg.rope_theta)
    return q, k, v


def head_to_kv_map(cfg: ModelConfig, tp: int) -> np.ndarray:
    """Static (Hp,) map: query head -> kv head (pads point at kv head 0)."""
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    G = H // Kv
    Hp = cfg.padded_heads(tp)
    return np.asarray([h // G if h < H else 0 for h in range(Hp)], np.int32)


def _unpad_heads(out_flat: torch.Tensor, cfg: ModelConfig, tp: int) -> torch.Tensor:
    """(.., Hp*hd) -> (.., H*hd): drop flat-padded query heads before w_o.
    The heads are the major part of the flat dim, so the real ones are its
    first H*hd columns: a slice, where the reference reshapes to (Hp, hd)
    and back (the same values; a DTensor gradient sharded over the flat dim
    could not be split into (H, hd) on the way back). A DTensor's flat dim
    is gathered first: the slice cuts across its shards."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim()
    if cfg.padded_heads(tp) == H:
        return out_flat
    return shd.unshard(out_flat, -1)[..., :H * hd]


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
    block loop, so every block tensor has a single head axis that shards
    over the model axis. DTensor inputs take `_blockwise_sharded`, which
    lays the blocks and the softmax carries out as the reference's
    "attn_blocks" / "attn_carry*" tags do (batch over the data axes, heads
    over the model axis) and runs these loops on each rank's shard."""
    if shd.is_dtensor(q):
        return _blockwise_sharded(q, k, v, q_positions, kv_positions, window=window,
                                  causal=causal, block_q=block_q, block_kv=block_kv,
                                  mode=mode, kv_map=kv_map)
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


def _blockwise_sharded(q, k, v, q_positions, kv_positions, *, window, causal, block_q,
                       block_kv, mode, kv_map):
    """`blockwise_attention` of DTensors on each rank's shard: the block
    loops are independent over the batch and over the heads, so with q's
    batch over the data axes and its heads over the model axis (the
    reference's "attn_blocks" and carry layouts) each rank runs the plain
    loops on its own batch rows and query heads (`local_map`), against the
    kv heads its query heads read. k and v enter whole over the model axis
    (kv heads are few), and their gradients leave as partial sums over it.
    Besides sparing DTensor's dispatch in every block step, this keeps the
    blocks' 4-D products away from DTensor's view rules, which in torch
    2.11 refuse to flatten (B, H) with H split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    if kv_map is None:
        kv_map = np.repeat(np.arange(Kv, dtype=np.int32), H // Kv)
    if len(kv_map) != H:
        raise ValueError(f"kv_map has {len(kv_map)} heads, q has {H}")
    q_pl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements]
    b_pl = [Shard(0) if p == Shard(0) else Replicate() for p in q_pl]
    kv_grad = [Shard(0) if p == Shard(0) else Partial() if p == Shard(2) else Replicate()
               for p in q_pl]
    head_dims = [i for i, p in enumerate(q_pl) if p == Shard(2)]

    def local(ql, kl, vl, qpl, kpl):
        Hl = ql.shape[2]
        first = 0  # the first query head this rank holds
        for i in head_dims:
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        first *= Hl
        out = blockwise_attention(ql, kl, vl, qpl, kpl, window=window, causal=causal,
                                  block_q=block_q, block_kv=block_kv, mode=mode,
                                  kv_map=kv_map[first:first + Hl])
        return out

    fn = local_map(local, out_placements=q_pl,
                   in_placements=(q_pl, b_pl, b_pl, b_pl, b_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad, b_pl, b_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, shd.replicate(k, mesh), shd.replicate(v, mesh),
              shd.replicate(q_positions, mesh), shd.replicate(kv_positions, mesh))


def attn_apply_train(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                     *, window: int = -1, constrain=no_constrain, return_kv: bool = False):
    """Full-sequence attention (training / prefill)."""
    tp = constrain.tp
    q, k, v = _qkv(params, x, positions, cfg, tp, constrain)
    v = constrain(v, "act_kv_heads")
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
                      *, window: int = -1, constrain=no_constrain):
    """One-token decode against the cache; returns (out, cache). x: (B, 1, d);
    cur_pos: the new token's absolute position (an int or a 0-dim integer
    tensor). The cache's slot cur_pos % slots is written in place. A
    DTensor cache (slots over the model axis) takes `_decode_sharded`."""
    cdt = dt(cfg, "compute")
    B = x.shape[0]
    hd = cfg.resolved_head_dim()
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    G = H // Kv  # decode: no padded heads
    cur = torch.as_tensor(cur_pos, dtype=torch.long, device=x.device).reshape(())
    positions = cur.expand(B, 1)
    q, k_new, v_new = _qkv(params, x, positions, cfg, tp=1)
    if shd.is_dtensor(cache.k):
        o = _decode_sharded(q, k_new, v_new, cur, cache, cfg, window)
        return o.to(cdt) @ params["wo"].to(cdt), cache

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


class _LocalCache:
    """A DTensor KV cache (batch over the data axes, slots over the model
    axis) as this rank's local shards: `k`, `v`, `pos` (views: writes land
    in the cache), `n_loc` slots from global slot `first` of `slots`, the
    cache's batch placements `batch_pl`, and `local(t)`, which gives a
    tensor's rows for this rank's batch shard, whole over the model axis."""

    def __init__(self, cache: KVCache):
        from torch.distributed.tensor import Replicate, Shard

        self.mesh = mesh = cache.k.device_mesh
        self.batch_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in cache.k.placements]
        self.slot_dims = [i for i, p in enumerate(cache.k.placements) if p.is_shard(1)]
        self.k, self.v, self.pos = cache.k.to_local(), cache.v.to_local(), cache.pos.to_local()
        self.slots, self.n_loc = cache.k.shape[1], self.k.shape[1]
        first = 0
        for i in self.slot_dims:
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        self.first = first * self.n_loc

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return shd.replicate(t, self.mesh).redistribute(self.mesh, self.batch_pl).to_local()


def _decode_sharded(q, k_new, v_new, cur, cache: KVCache, cfg: ModelConfig, window: int):
    """Flash-decode over a cache whose batch is split over the data axes and
    whose slots are split over the model axis (`sharding.STATE_RULES`).

    DTensor has no rule for an in-place write into one slot of a sharded
    dim, nor for a softmax combined across shards, so this runs on the
    local shards: the new token's k/v (whole on every model rank) is
    written only on the rank that owns its slot (a masked write, no host
    sync); each rank scores its own slots, keeping its max m_r, its sum
    l_r = sum exp(s - m_r) and its output o_r = sum p v (p rounded to the
    compute dtype, as the reference rounds the softmax before its PV
    product); then one all-reduce (MAX) of m over the slot-sharding mesh
    dims and one (SUM) of [l_r, o_r] scaled by exp(m_r - m) give
    out = o / l. Returns the (B, 1, H*hd) output, batch-sharded as the
    cache and whole over the model axis."""
    from torch.distributed.tensor import DTensor

    cdt = dt(cfg, "compute")
    hd = cfg.resolved_head_dim()
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    G = H // Kv
    lc = _LocalCache(cache)
    mesh, slot_dims = lc.mesh, lc.slot_dims
    q, k_new, v_new = lc.local(q), lc.local(k_new), lc.local(v_new)
    # the position as a plain tensor (a replicated DTensor holds it whole):
    # the in-place writes below go into plain local shards, and DTensor has
    # no rule for an in-place op on a plain tensor with a DTensor index
    cur = shd.local(cur)
    B = q.shape[0]
    k_loc, v_loc, p_loc = lc.k, lc.v, lc.pos
    slots, n_loc, first = lc.slots, lc.n_loc, lc.first
    rel = (cur % slots) - first
    own = (rel >= 0) & (rel < n_loc)
    idx = torch.clamp(rel, 0, n_loc - 1).reshape(1)
    for buf, new in ((k_loc, k_new), (v_loc, v_new)):
        old = buf.index_select(1, idx)
        buf.index_copy_(1, idx, torch.where(own, new.to(buf.dtype), old))
    old = p_loc.index_select(1, idx)
    p_loc.index_copy_(1, idx, torch.where(own, cur.to(torch.int32).expand_as(old), old))

    qg = q.reshape(B, Kv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_loc.to(cdt).float()) * hd**-0.5
    valid = (p_loc >= 0) & (p_loc <= cur)
    if window > 0:
        valid = valid & (cur - p_loc < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)  # (B, Kv, G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(cdt).float(), v_loc.to(cdt).float())
    if slot_dims:
        group = mesh.get_group(slot_dims[0]) if len(slot_dims) == 1 else None
        if group is None:
            raise NotImplementedError("decode over slots split by two mesh dims")
        m_all = m.clone()
        dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
        scale = torch.exp(m - m_all)
        packed = torch.cat([(l * scale)[..., None], o * scale[..., None]], dim=-1)
        dist.all_reduce(packed, group=group)
        l, o = packed[..., 0], packed[..., 1:]
    out = (o / l[..., None]).reshape(B, 1, H * hd)
    return DTensor.from_local(out, mesh, lc.batch_pl, run_check=False)


def cache_from_prefill(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, window: int) -> KVCache:
    """Fill a pre-allocated decode cache from prefill KV, in place.

    Windowed layers keep only the last `slots` positions, ring-indexed by
    absolute position (so later decode steps write consistently). A DTensor
    cache (slots over the model axis) takes `_fill_sharded`."""
    if shd.is_dtensor(cache.k):
        _fill_sharded(cache, k, v, positions)
        return cache
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


def _fill_sharded(cache: KVCache, k, v, positions) -> None:
    """`cache_from_prefill` on each rank's shard of a slot-sharded cache:
    DTensor has no rule for writing a slice of a sharded dim in place. Each
    rank takes k, v and the positions of its batch rows (whole over the
    model axis: one layer's, not the cache) and writes the entries whose
    slot it owns (the plain path's slot: the entry's index, or its
    position mod the slots on a ring that wraps)."""
    lc = _LocalCache(cache)
    k, v, positions = lc.local(k), lc.local(v), lc.local(positions)
    B, S = positions.shape
    n = min(S, lc.slots)
    k, v, positions = k[:, S - n:], v[:, S - n:], positions[:, S - n:]
    if S <= lc.slots:
        slot = torch.arange(n, device=positions.device).expand(B, n)
    else:
        slot = positions.long() % lc.slots
    rel = slot - lc.first
    # a masked write of static shape: every entry is written, the ones whose
    # slot another rank owns into one spare slot past this rank's, dropped
    # after (no data-dependent index list, so the write traces on fake
    # tensors too)
    r = torch.where((rel >= 0) & (rel < lc.n_loc), rel, lc.n_loc)
    b = torch.arange(B, device=r.device)[:, None].expand(B, n)
    for buf, new in ((lc.k, k), (lc.v, v), (lc.pos, positions)):
        ext = torch.cat([buf, buf[:, :1]], dim=1)
        ext[b, r] = new.to(buf.dtype)
        buf.copy_(ext[:, :lc.n_loc])
