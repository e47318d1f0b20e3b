"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
counterpart of `repro.models.rglru`).

Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a u_t)                      recurrence gate
    i_t = sigmoid(W_i u_t)                      input gate
    log a_t = c * r_t * log sigmoid(Lambda)     per-channel, c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ u_t)

The recurrence is a first-order per-channel linear scan, so training runs
an associative scan over time: the port's own `temporal.pskf.
associative_scan`, which follows `jax.lax.associative_scan`'s recursion,
over time moved to the front. Decode is the O(1) step. A width-4 causal
depthwise conv precedes the LRU, as in Griffin. The state h is float32;
the conv tail is kept in the compute dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, dt, normal
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import no_constrain
from repro_torch.temporal.pskf import associative_scan

LRU_C = 8.0
CONV_W = 4


def rglru_init(gen, cfg: ModelConfig, device):
    d = cfg.d_model
    return {
        "w_gate": dense_init(gen, d, d, cfg, device),  # gelu branch
        "w_x": dense_init(gen, d, d, cfg, device),  # recurrent branch input
        "conv_w": (normal(gen, (CONV_W, d), device) * 0.1).to(dt(cfg)),
        "conv_b": torch.zeros((d,), dtype=torch.float32, device=device),
        "w_a": dense_init(gen, d, d, cfg, device),
        "w_i": dense_init(gen, d, d, cfg, device),
        "lam": torch.full((d,), 2.0, dtype=torch.float32, device=device),  # sigmoid(2) ~ .88
        "w_out": dense_init(gen, d, d, cfg, device),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, d) float32 recurrent state
    conv: torch.Tensor  # (B, CONV_W-1, d) conv tail


def rglru_state_init(cfg: ModelConfig, B: int, dtype, device) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((B, cfg.d_model), dtype=torch.float32, device=device),
        conv=torch.zeros((B, CONV_W - 1, cfg.d_model), dtype=dtype, device=device),
    )


def _conv1d_causal(params, u: torch.Tensor, tail: torch.Tensor):
    """Depthwise causal conv, width CONV_W. u: (B, T, d); tail: (B, CONV_W-1, d).
    Returns (out (B, T, d), new_tail)."""
    w = params["conv_w"].to(u.dtype)
    ext = torch.cat([tail.to(u.dtype), u], dim=1)  # (B, T+3, d)
    T = u.shape[1]
    out = sum(ext[:, i:i + T] * w[i] for i in range(CONV_W))
    return out + params["conv_b"].to(u.dtype), ext[:, -(CONV_W - 1):]


def _lru_gates(params, u: torch.Tensor, cfg: ModelConfig, constrain=no_constrain):
    cdt = dt(cfg, "compute")
    r = torch.sigmoid((u @ params["w_a"].to(cdt)).float())
    i = torch.sigmoid((u @ params["w_i"].to(cdt)).float())
    log_a = LRU_C * r * shd.pointwise(F.logsigmoid, params["lam"])  # (..., d) < 0
    b = torch.sqrt(-torch.expm1(2.0 * log_a)) * i * u.float()  # sqrt(1 - a^2)
    return constrain(log_a, "act_chan"), constrain(b, "act_chan")


def _combine(left, right):
    la1, b1 = left
    la2, b2 = right
    return [la1 + la2, torch.exp(la2) * b1 + b2]


def rglru_apply_train(params, x: torch.Tensor, state: RGLRUState, cfg: ModelConfig,
                      constrain=no_constrain):
    """x: (B, T, d); returns (out, new_state). The branch tensors are
    channel-sharded over the model axis ("act_chan"): the conv and the scan
    are per channel, so they run on local channels."""
    cdt = dt(cfg, "compute")
    gate = constrain(F.gelu(x.to(cdt) @ params["w_gate"].to(cdt), approximate="tanh"),
                     "act_chan")
    u = constrain(x.to(cdt) @ params["w_x"].to(cdt), "act_chan")
    u, conv_tail = _conv1d_causal(params, u, state.conv)
    log_a, b = _lru_gates(params, u, cfg, constrain)

    # prepend the carried state as a pseudo-step: h_0 carries in via the b slot
    log_a_ext = torch.cat([torch.zeros_like(log_a[:, :1]), log_a], dim=1)
    b_ext = torch.cat([state.h[:, None, :], b], dim=1)
    # the scan runs over the first axis: time to the front and back
    _, h = associative_scan(_combine, [log_a_ext.transpose(0, 1), b_ext.transpose(0, 1)])
    h = h.transpose(0, 1)[:, 1:]  # drop the carry pseudo-step
    out = (gate * h.to(cdt)) @ params["w_out"].to(cdt)
    return out, RGLRUState(h[:, -1, :], conv_tail)


def rglru_apply_decode(params, x: torch.Tensor, state: RGLRUState, cfg: ModelConfig,
                       constrain=no_constrain):
    """x: (B, 1, d) single step."""
    cdt = dt(cfg, "compute")
    xt = x.to(cdt)
    gate = F.gelu(xt @ params["w_gate"].to(cdt), approximate="tanh")[:, 0]
    u = (xt @ params["w_x"].to(cdt))[:, 0]  # (B, d)
    ext = torch.cat([state.conv.to(u.dtype), u[:, None]], dim=1)  # (B, 4, d)
    w = params["conv_w"].to(u.dtype)
    u = sum(ext[:, i] * w[i] for i in range(CONV_W)) + params["conv_b"].to(u.dtype)
    log_a, b = _lru_gates(params, u, cfg)
    h = torch.exp(log_a) * state.h + b
    out = ((gate * h.to(cdt)) @ params["w_out"].to(cdt))[:, None, :]
    return out, RGLRUState(h, ext[:, 1:])
