"""Step functions (train / prefill / decode) of the LM launchers
(counterpart of `repro.launch.steps`), used by `launch/train.py`,
`launch/serve.py` and `runtime/train_loop.py`.

A `StepBundle` carries the step function and meta-device stand-ins of its
arguments (shapes and dtypes, no storage). The reference's bundles also
carry in/out shardings and `jitted()` / `lower()`: those wait for
`parallel/sharding`; here every step runs eagerly on one
device, and the reference's `constrain=` hooks are the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import model_zoo
from repro_torch.models.layers import dtype_of
from repro_torch.optim import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.optim.adam import flatten, tree_map, unflatten

Tree = Any


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A step function and meta-device stand-ins of its arguments."""

    fn: Any
    abstract_args: tuple


def _abstract_params(model) -> Tree:
    return model.init(device="meta")


def default_adam(cfg: ModelConfig) -> AdamConfig:
    return AdamConfig(lr=3e-4, weight_decay=0.1, clip_norm=1.0,
                      state_dtype=cfg.optimizer_state_dtype)


def _value_and_grad(model, params: Tree, data: Dict[str, torch.Tensor]):
    leaves = [p.detach().requires_grad_(True) for p in flatten(params)[1]]
    loss, metrics = model.train_loss(unflatten(params, leaves), data)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, shape: ShapeCell, mesh: HostMesh,
                    adam: AdamConfig | None = None, batch: int | None = None) -> StepBundle:
    """train_step(params, opt_state, data) -> (params, opt_state, metrics):
    the loss and its gradients, over `cfg.microbatches` sequential
    microbatches accumulated in `cfg.grad_accum_dtype`, then one Adam
    update. metrics: ce, aux, loss (means over the microbatches) and the
    pre-clip grad_norm."""
    model = model_zoo.build(cfg)
    adam = adam or default_adam(cfg)
    n_mb = max(1, cfg.microbatches)
    acc_dt = dtype_of(cfg.grad_accum_dtype)

    def train_step(params, opt_state: AdamState, data: Dict[str, torch.Tensor]):
        if n_mb == 1:
            loss, metrics, grads = _value_and_grad(model, params, data)
        else:
            # gradient accumulation over sequential microbatches
            def split(x, i):
                B = x.shape[0]
                return x.reshape(n_mb, B // n_mb, *x.shape[1:])[i]

            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt, device=p.device),
                             params)
            losses, ms = [], []
            for i in range(n_mb):
                l, m, g = _value_and_grad(model, params, {k: split(v, i) for k, v in data.items()})
                grads = unflatten(params, [a + gi.to(a.dtype) / n_mb for a, gi in
                                           zip(flatten(grads)[1], flatten(g)[1])])
                losses.append(l)
                ms.append(m)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, gnorm = adam_update(grads, opt_state, params, adam)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    params_a = _abstract_params(model)
    opt_a = adam_init(params_a, adam)
    data_a = model_zoo.input_specs(cfg, shape, batch)
    return StepBundle(fn=train_step, abstract_args=(params_a, opt_a, data_a))


def make_prefill_step(cfg: ModelConfig, shape: ShapeCell, mesh: HostMesh,
                      batch: int | None = None) -> StepBundle:
    """prefill_step(params, data) -> (last logits (B, V), states)."""
    model = model_zoo.build(cfg)

    @torch.no_grad()
    def prefill_step(params, data):
        return model.prefill(params, data)

    return StepBundle(fn=prefill_step, abstract_args=(_abstract_params(model),
                                                      model_zoo.input_specs(cfg, shape, batch)))


def make_decode_step(cfg: ModelConfig, shape: ShapeCell, mesh: HostMesh,
                     batch: int | None = None) -> StepBundle:
    """decode_step(params, states, tokens, pos) -> (logits, states): one
    token against a KV cache of shape.seq_len, the states advanced in place
    (the reference donates them)."""
    model = model_zoo.build(cfg)
    B = batch or shape.global_batch

    @torch.no_grad()
    def decode_step(params, states, tokens, pos):
        return model.decode_step(params, tokens, pos, states)

    states_a = model.init_decode_state(B, shape.seq_len, device="meta")
    return StepBundle(fn=decode_step, abstract_args=(
        _abstract_params(model), states_a, torch.empty((B, 1), dtype=torch.int32, device="meta"),
        torch.empty((), dtype=torch.int32, device="meta")))


def make_step(kind: str, cfg: ModelConfig, shape: ShapeCell, mesh: HostMesh,
              batch: int | None = None) -> StepBundle:
    if kind == "train":
        return make_train_step(cfg, shape, mesh, batch=batch)
    if kind == "prefill":
        return make_prefill_step(cfg, shape, mesh, batch=batch)
    if kind == "decode":
        return make_decode_step(cfg, shape, mesh, batch=batch)
    raise ValueError(kind)
