"""Optimization loops for the GP models (counterpart of
`repro.core.inference`).

  * `fit_adam`  — Adam on any loss(params, *data); the production path.
  * `fit_lbfgs` — scipy L-BFGS-B on the loss (the paper's optimizer, §2
                  end), gradients from `torch.autograd`. Parameters are
                  flattened to the host — fine at GP scale.

Parameters are nested dicts of tensors. Each step runs eagerly: the loss,
`torch.autograd.grad`, then the reference's Adam update.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.optim.adam import flatten, tree_map, unflatten
from repro_torch.tracing import span

Tree = Any


def value_and_grad(loss_fn: Callable[..., torch.Tensor], params: Tree,
                   data: tuple) -> tuple[torch.Tensor, Tree]:
    """loss_fn(params, *data) and its gradient tree (zeros where the loss
    does not depend on a leaf, as `jax.grad` gives)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with span("repro_torch.forward"):
        loss = loss_fn(leaves, *data)
    flat = flatten(leaves)[1]
    with span("repro_torch.backward"):
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(leaves, grads)


def fit_adam(
    loss_fn: Callable[..., torch.Tensor],
    params: Tree,
    data: tuple,
    *,
    steps: int = 200,
    lr: float = 1e-2,
    log_every: int = 0,
) -> tuple[Tree, list[float]]:
    """Adam on `loss_fn`. The returned history ends with the loss the
    final step computed (at its pre-update parameters) — no extra
    statistics pass is spent on logging; with `steps=0` no loss is ever
    evaluated and the history is empty. The loss is read back to the host
    only where it is logged."""
    config = AdamConfig(lr=lr, clip_norm=None, weight_decay=0.0)
    state = adam_init(params, config)
    params = tree_map(torch.Tensor.detach, params)
    history = []
    loss = None
    for i in range(steps):
        loss, grads = value_and_grad(loss_fn, params, data)
        params, state, _ = adam_update(grads, state, params, config)
        if log_every and i % log_every == 0:
            history.append(float(loss))
            print(f"  step {i:5d}  loss {float(loss):.4f}")
    if loss is not None and not (log_every and (steps - 1) % log_every == 0):
        history.append(float(loss))
    return params, history


def fit_lbfgs(
    loss_fn: Callable[..., torch.Tensor],
    params: Tree,
    data: tuple,
    *,
    maxiter: int = 200,
) -> tuple[Tree, float]:
    """scipy L-BFGS-B on `loss_fn` (the paper's optimizer)."""
    from scipy.optimize import minimize

    flat = flatten(params)[1]
    shapes = [p.shape for p in flat]
    sizes = [p.numel() for p in flat]
    dtypes = [p.dtype for p in flat]
    device = flat[0].device

    def pack(leaves) -> np.ndarray:
        return np.concatenate([p.detach().cpu().double().reshape(-1).numpy()
                               for p in leaves])

    def unpack(x: np.ndarray) -> Tree:
        out, off = [], 0
        for s, n, dt in zip(shapes, sizes, dtypes):
            out.append(torch.as_tensor(x[off:off + n].reshape(s), dtype=dt,
                                       device=device))
            off += n
        return unflatten(params, out)

    def objective(x: np.ndarray):
        val, grads = value_and_grad(loss_fn, unpack(x), data)
        return float(val), pack(flatten(grads)[1])

    res = minimize(objective, pack(flat), jac=True, method="L-BFGS-B",
                   options={"maxiter": maxiter})
    return unpack(res.x), float(res.fun)
