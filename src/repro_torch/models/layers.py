"""Common transformer layers (counterpart of `repro.models.layers`).

Every module is an (init, apply) pair over plain dicts of tensors.
`init(gen, cfg, ...)` draws from an explicit `torch.Generator` on the
device the tensors are made on; `apply(params, x, ...)` runs its matrix
products in cfg.compute_dtype and its normalizations and softmax
statistics in float32, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import no_constrain

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


# the runner of the models' layer loops while `launch.cost` counts a step
# (it traces two repeats and stands in for the rest); empty otherwise
LAYER_LOOP: list = []


def layer_loop(step, carry, n: int, operands=lambda r: None):
    """carry = step(carry, r, operands(r)) for r = 0 .. n - 1: a model's
    loop over its stacked layers (the reference's scan over layers).
    `operands(r)` gives what repeat r reads besides the carry (its slices
    of the stacked parameters: dicts and lists of tensors), and the step
    reads them from its third argument. Every repeat after the first does
    the same work on tensors of the same shapes and layouts, so a counting
    runner (`launch.cost.lower`) traces the first and the last, counts the
    last n - 1 times, and stands in for the others."""
    if LAYER_LOOP:
        return LAYER_LOOP[-1](step, carry, n, operands)
    for r in range(n):
        carry = step(carry, r, operands(r))
    return carry


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dt(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    return dtype_of(cfg.param_dtype if kind == "param" else cfg.compute_dtype)


def normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard normals in float32 drawn from `gen` on `device`; on the meta
    device, an empty tensor of that shape (no draw, no allocation)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def dense_init(gen, d_in: int, d_out: int, cfg: ModelConfig, device,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in**-0.5
    return (normal(gen, (d_in, d_out), device) * scale).to(dt(cfg))


def rmsnorm_init(d: int, cfg: ModelConfig, device):
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, device, d: int | None = None, f: int | None = None):
    d = d or cfg.d_model
    f = f or cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": dense_init(gen, d, f, cfg, device),
                "w_up": dense_init(gen, d, f, cfg, device),
                "w_down": dense_init(gen, f, d, cfg, device)}
    return {"w_up": dense_init(gen, d, f, cfg, device),
            "w_down": dense_init(gen, f, d, cfg, device)}


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig,
              constrain=no_constrain) -> torch.Tensor:
    cdt = dt(cfg, "compute")
    x = shd.whole_rows(x.to(cdt))
    if cfg.act == "swiglu":
        h = F.silu(x @ params["w_gate"].to(cdt)) * (x @ params["w_up"].to(cdt))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ params["w_up"].to(cdt), approximate="tanh")
    h = constrain(h, "ffn")
    return h @ params["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Embedding + sequence-chunked cross-entropy
# ---------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, device):
    # table std d^-1/2: lookups are rescaled by sqrt(d) below, and tied
    # logits x @ table^T come out unit-variance without a separate scale.
    # Rows beyond vocab_size are padding (cfg.padded_vocab) — never
    # indexed, and masked out of logits/CE.
    table = (normal(gen, (cfg.padded_vocab(), cfg.d_model), device)
             * cfg.d_model**-0.5).to(dt(cfg))
    return {"table": table}


def embed_lookup(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params["table"].to(dt(cfg, "compute"))
    if shd.is_dtensor(table):
        return shd.gather_rows(table, tokens) * (cfg.d_model**0.5)
    return table[tokens] * (cfg.d_model**0.5)


def unembed_init(gen, cfg: ModelConfig, device):
    return {"w": dense_init(gen, cfg.d_model, cfg.padded_vocab(), cfg, device)}


def logits_from(params_embed, params_unembed, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Logits over the PADDED vocab (pad ids masked to -1e30)."""
    cdt = dt(cfg, "compute")
    x = shd.whole_rows(x)
    if cfg.tie_embeddings:
        logits = x.to(cdt) @ params_embed["table"].to(cdt).T
    else:
        logits = x.to(cdt) @ params_unembed["w"].to(cdt)
    if cfg.padded_vocab() != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab(), device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[b, s, labels[b, s]] as (B, c, 1). On a DTensor: each rank
    picks from its own slice of the vocab (a masked sum over it, zero where
    the label lies in another rank's slice), and the result is a partial
    sum over the mesh dims that split the vocab, as GSPMD partitions the
    reference's take_along_axis. DTensor's own gather gives the same values,
    but its reverse (`gather_backward`: `new_zeros` of the logits' shape,
    then a scatter) makes the chunk's whole logits gradient on every rank,
    since DTensor places a `new_zeros` replicated: (B, c, V) at the global
    batch and the whole vocab, 24 GiB a rank at smollm-360m's train_4k on
    the (16, 16) mesh (`launch.dryrun`). Here the reverse stays on the
    rank's slice."""
    if not shd.is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = list(logits.placements)
    vocab_dims = [i for i, p in enumerate(pl) if p.is_shard(last)]
    rows = [p if p.is_shard() and p.dim < last else Replicate() for p in pl]
    out = [Partial() if i in vocab_dims else rows[i] for i in range(len(pl))]

    def local(lg, lb):
        first = 0  # the first vocab id of this rank's slice
        for i in vocab_dims:
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        V = lg.shape[-1]
        hit = (lb.long()[..., None] - first * V) == torch.arange(V, device=lg.device)
        return torch.where(hit, lg, torch.zeros((), dtype=lg.dtype, device=lg.device)).sum(
            -1, keepdim=True)

    fn = local_map(local, out_placements=out, in_placements=(pl, rows),
                   in_grad_placements=(pl, rows), device_mesh=mesh, redistribute_inputs=True)
    return fn(logits, shd.replicate(labels, mesh))


def chunked_softmax_xent(x: torch.Tensor, labels: torch.Tensor, loss_mask: torch.Tensor,
                         params_embed, params_unembed, cfg: ModelConfig,
                         constrain=no_constrain) -> torch.Tensor:
    """Mean CE over masked positions without materializing (B, S, V).

    Loops over sequence chunks; per chunk the (B, c, V) logits live
    briefly and reduce to float32 sums. The reference's scan keeps no
    chunk's logits for its backward; here each chunk runs under
    `torch.utils.checkpoint`, so autograd saves only the chunk's inputs and
    recomputes its logits in the backward. The logits are placed by the
    "logits" tag (vocab over the model axis).
    """
    B, S, _ = x.shape
    c = min(cfg.logits_chunk, S)
    pad = (-S) % c
    if pad:
        x = shd.pad(x, (0, 0, 0, pad))
        labels = shd.pad(labels, (0, pad))
        loss_mask = shd.pad(loss_mask, (0, pad))

    def chunk_sums(xc, lc, mc):
        logits = logits_from(params_embed, params_unembed, xc, cfg)  # (B, c, V)
        logits = constrain(logits.float(), "logits")
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        return torch.sum((lse - _gold_logit(logits, lc)) * mc[..., None])

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[1], c):
        xc, lc, mc = x[:, i:i + c], labels[:, i:i + c], loss_mask[:, i:i + c]
        if torch.is_grad_enabled():
            tot = tot + checkpoint(chunk_sums, xc, lc, mc, use_reentrant=False)
        else:
            tot = tot + chunk_sums(xc, lc, mc)
        cnt = cnt + torch.sum(mc)
    # on a mesh tot is a partial sum over the batch and vocab shards: the
    # loss is made whole on every rank before anything adds to it
    return shd.replicated(tot) / torch.clamp(shd.replicated(cnt), min=1.0)
