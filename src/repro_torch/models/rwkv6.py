"""RWKV-6 "Finch" time-mix and channel-mix (arXiv:2404.05892; counterpart
of `repro.models.rwkv6`).

Attention-free temporal mixer with *data-dependent* per-channel decay:

    w_t = exp(-exp(w0 + lora_w(x_t)))                 in (0,1), per channel
    S_t = diag(w_t) S_{t-1} + k_t v_t^T               per head, (K, V) state
    o_t = S_{t-1}^T r_t + (r_t . (u ⊙ k_t)) v_t       current token uses bonus u

Training runs a *chunked* parallel form: sequence chunks of size CHUNK are
processed with an exact intra-chunk pairwise block (c, c, K) (every decay
exponential is a difference cum_{t-1} - cum_i <= 0, so exp() never
overflows) while the (B, H, K, V) float32 state carries across chunks in a
Python loop (the reference's lax.scan). As the reference checkpoints its
chunk body, each chunk runs under `torch.utils.checkpoint` whenever
autograd records: the backward recomputes the (B, c, c, H, K) pairwise
block and never stores it. Decode is the plain O(1) recurrence.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, dt
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import no_constrain

CHUNK = 64
LORA_RANK = 64


def timemix_init(gen, cfg: ModelConfig, device):
    d = cfg.d_model

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "mu": full((4, d), 0.5),  # shift-mix for r, k, v, g
        "mu_w": full((d,), 0.5),
        "w0": full((d,), -6.0),  # decay bias (slow default)
        "lora_wA": dense_init(gen, d, LORA_RANK, cfg, device),
        "lora_wB": torch.zeros((LORA_RANK, d), dtype=dt(cfg), device=device),
        "wr": dense_init(gen, d, d, cfg, device),
        "wk": dense_init(gen, d, d, cfg, device),
        "wv": dense_init(gen, d, d, cfg, device),
        "wg": dense_init(gen, d, d, cfg, device),
        "wo": dense_init(gen, d, d, cfg, device),
        "u": full((d,), 0.0),  # per-channel bonus
        "gn_scale": full((d,), 1.0),  # per-head groupnorm
    }


class TimeMixState(NamedTuple):
    S: torch.Tensor  # (B, H, K, V) float32 wkv state
    x_prev: torch.Tensor  # (B, d) last token (for the token shift)


def timemix_state_init(cfg: ModelConfig, B: int, dtype, device) -> TimeMixState:
    K = cfg.rwkv_head_dim
    H = cfg.d_model // K
    return TimeMixState(
        S=torch.zeros((B, H, K, K), dtype=torch.float32, device=device),
        x_prev=torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
    )


def _shift_mix(x, x_shift, mu):
    return x + (x_shift - x) * mu


def _decays(params, xw: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """log of the decay, in [-e^2, -e^-8]: (..., d) float32."""
    cdt = dt(cfg, "compute")
    lora = torch.tanh(xw.to(cdt) @ params["lora_wA"].to(cdt)) @ params["lora_wB"].to(cdt)
    return -torch.exp(torch.clamp(params["w0"] + lora.float(), -8.0, 2.0))


def _groupnorm(params, o: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head normalization (population variance, as `jnp.var`), in
    float64 where the reference computes in float32: a head whose K outputs
    are nearly equal (a variance near eps) loses the digits of o - mean in
    float32, and on the smoke tests' seed-0 batch each package's float32
    gradients then sit 4e-5 (the port) and 6.5e-5 (the reference) from a
    float64 evaluation, in opposite directions. The statistics cost
    O(B T d); the result returns in o's dtype."""
    B, T, d = o.shape
    oh = o.reshape(B, T, H, d // H).double()
    mean = oh.mean(dim=-1, keepdim=True)
    var = oh.var(dim=-1, keepdim=True, correction=0)
    oh = (oh - mean) * torch.rsqrt(var + 1e-5)
    return (oh.reshape(B, T, d) * params["gn_scale"].double()).to(o.dtype)


def _chunk(S, ri, ki, vi, lwi, u):
    """One chunk: ri, ki, vi, lwi (B, c, H, K) float32, S (B, H, K, V).
    Returns (S_new, o (B, c, H, V))."""
    c = ri.shape[1]
    cum = torch.cumsum(lwi, dim=1)  # inclusive (B, c, H, K)
    cum_prev = cum - lwi  # exclusive: sum_{j<t}
    # intra-chunk pairwise: A[t,i] = sum_a r_t k_i exp(cum_prev_t - cum_i), i < t
    diff = cum_prev[:, :, None] - cum[:, None, :]  # (B, c, c, H, K)
    ar = torch.arange(c, device=ri.device)
    tri = (ar[:, None] > ar[None, :])[None, :, :, None, None]
    Aij = torch.sum(ri[:, :, None] * ki[:, None, :] * torch.exp(diff) * tri, dim=-1)
    # diagonal: the bonus term
    Adiag = torch.sum(ri * u[None, None] * ki, dim=-1)  # (B, c, H)
    eye = torch.eye(c, dtype=ri.dtype, device=ri.device)
    A = Aij + Adiag[:, :, None] * eye[None, :, :, None]  # (B, c, c, H)
    o_intra = torch.einsum("btih,bihv->bthv", A, vi)
    # cross-chunk: o_cross[t] = (r_t * exp(cum_prev_t)) @ S_in
    o_cross = torch.einsum("bthk,bhkv->bthv", ri * torch.exp(cum_prev), S)
    # state update: S' = exp(cum_last) * S + sum_i exp(cum_last - cum_i) k_i v_i^T
    cum_last = cum[:, -1]  # (B, H, K)
    S_decay = torch.exp(cum_last)[:, :, :, None] * S
    kd = ki * torch.exp(cum_last[:, None] - cum)  # (B, c, H, K)
    S_new = S_decay + torch.einsum("bthk,bthv->bhkv", kd, vi)
    return S_new, o_intra + o_cross


def timemix_apply_chunked(params, x: torch.Tensor, state: TimeMixState, cfg: ModelConfig,
                          constrain=no_constrain):
    """x: (B, T, d), any T (trailing pad steps are exact no-ops: k = 0,
    log w = 0). Returns (out, new_state)."""
    cdt = dt(cfg, "compute")
    B, T, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    c = min(CHUNK, T)
    pad = (-T) % c
    n = (T + pad) // c

    # token shift over the full sequence, the projections on all of it
    x_shift = torch.cat([state.x_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    mu = params["mu"]
    xr = _shift_mix(x, x_shift, mu[0]).to(cdt)
    xk = _shift_mix(x, x_shift, mu[1]).to(cdt)
    xv = _shift_mix(x, x_shift, mu[2]).to(cdt)
    xg = _shift_mix(x, x_shift, mu[3]).to(cdt)
    xw = _shift_mix(x, x_shift, params["mu_w"])

    r = (xr @ params["wr"].to(cdt)).reshape(B, T, H, K)
    k = (xk @ params["wk"].to(cdt)).reshape(B, T, H, K)
    v = (xv @ params["wv"].to(cdt)).reshape(B, T, H, K)
    g = F.silu(xg @ params["wg"].to(cdt))  # (B, T, d)
    logw = _decays(params, xw, cfg).reshape(B, T, H, K)  # float32
    u = params["u"].reshape(H, K)

    def chunked(t):  # (B, T, H, K) -> (n, B, c, H, K) float32, zero-padded
        t = shd.pad(t, (0, 0, 0, 0, 0, pad))  # log 1 = 0: a padded step decays nothing
        return t.reshape(B, n, c, H, K).transpose(0, 1).float()

    rc, kc, vc, wc = (constrain(chunked(t), "rwkv_chunks") for t in (r, k, v, logw))
    S = constrain(state.S, "rwkv_state")
    outs = []
    for i in range(n):
        args = (S, rc[i], kc[i], vc[i], wc[i], u)
        if torch.is_grad_enabled():
            S, o = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            S, o = _chunk(*args)
        outs.append(o)
    o = torch.stack(outs).transpose(0, 1).reshape(B, T + pad, d)[:, :T]  # (B, T, d)
    o = _groupnorm(params, o, H) * g
    out = o.to(cdt) @ params["wo"].to(cdt)
    return out, TimeMixState(S, x[:, -1, :])


def timemix_apply_decode(params, x: torch.Tensor, state: TimeMixState, cfg: ModelConfig,
                         constrain=no_constrain):
    """x: (B, 1, d) single-token recurrence."""
    cdt = dt(cfg, "compute")
    B, _, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    xt = x[:, 0]
    xs = state.x_prev.to(xt.dtype)
    mu = params["mu"]

    def proj(name, m):
        return _shift_mix(xt, xs, m).to(cdt) @ params[name].to(cdt)

    r = proj("wr", mu[0]).reshape(B, H, K).float()
    k = proj("wk", mu[1]).reshape(B, H, K).float()
    v = proj("wv", mu[2]).reshape(B, H, K).float()
    g = F.silu(proj("wg", mu[3]))
    logw = _decays(params, _shift_mix(xt, xs, params["mu_w"]), cfg).reshape(B, H, K)
    u = params["u"].reshape(H, K)

    # o = S^T r + (r . (u*k)) v ; S' = diag(w) S + k v^T
    o = (torch.einsum("bhk,bhkv->bhv", r, state.S)
         + torch.sum(r * u * k, -1, keepdim=True) * v)
    S_new = torch.exp(logw)[..., None] * state.S + k[..., None] * v[:, :, None, :]
    o = o.reshape(B, 1, d)
    o = _groupnorm(params, o.to(cdt), H) * g[:, None, :]
    out = o.to(cdt) @ params["wo"].to(cdt)
    return out, TimeMixState(S_new, xt)


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------

def chanmix_init(gen, cfg: ModelConfig, device):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "wk": dense_init(gen, d, f, cfg, device),
        "wv": dense_init(gen, f, d, cfg, device),
        "wr": dense_init(gen, d, d, cfg, device),
    }


def chanmix_apply(params, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d); x_prev: (B, d) last token of the previous call.
    Returns (out, new_x_prev)."""
    cdt = dt(cfg, "compute")
    x_shift = torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xk = _shift_mix(x, x_shift, params["mu_k"]).to(cdt)
    xr = _shift_mix(x, x_shift, params["mu_r"]).to(cdt)
    kk = torch.square(torch.relu(xk @ params["wk"].to(cdt)))
    out = torch.sigmoid(xr @ params["wr"].to(cdt)) * (kk @ params["wv"].to(cdt))
    return out, x[:, -1, :]
