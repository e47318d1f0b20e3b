"""Step functions (train / prefill / decode) with full sharding trees
(counterpart of `repro.launch.steps`), used by `launch/train.py`,
`launch/serve.py` and `runtime/train_loop.py`.

A `StepBundle` carries the step function, meta-device stand-ins of its
arguments (shapes and dtypes, no storage) and the in/out shardings the
rules table gives them on the mesh (`parallel.sharding`). `jitted()` is
the counterpart of the reference's `jax.jit(fn, in_shardings=...,
out_shardings=...)`: it places the arguments, runs the step eagerly and
places the outputs. On a one-rank mesh every sharding is replicated and
the step runs on plain tensors. `lower()` traces the step on abstract
arguments for the LM dry run (`launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import model_zoo
from repro_torch.models.layers import dtype_of
from repro_torch.optim import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.optim.adam import flatten, tree_map, unflatten
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import Spec

Tree = Any


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A step function, meta-device stand-ins of its arguments and its
    in/out shardings (trees of `sharding.Sharding`)."""

    fn: Any
    abstract_args: tuple
    in_shardings: tuple
    out_shardings: Any
    mesh: Any = None

    def jitted(self):
        """fn with its arguments placed by in_shardings (DTensors on a mesh
        of more than one rank) and its outputs by out_shardings. The step
        runs eagerly; tensors it makes inside (positions, masks, carries)
        enter DTensor ops as replicated (`sharding.mesh_context`)."""

        def call(*args):
            args = tuple(shd.place(a, s) for a, s in zip(args, self.in_shardings))
            with shd.mesh_context(self.mesh):
                out = self.fn(*args)
            return shd.place(out, self.out_shardings)

        return call

    def lower(self, *, multiply: bool = True):
        """The counterpart of the reference's `jit(...).lower(...)`: the
        step traced on one rank's abstract arguments (meta-device shards
        placed by in_shardings on the bundle's mesh, no storage), its
        operations, bytes and collectives counted and its live bytes
        tracked (`launch.cost.lower`; each layer loop's repeat traced once
        and counted its trip count times unless `multiply` is False). The
        record's `lower_s` is the trace's seconds; `compile_s` is None."""
        from repro_torch.launch import cost

        return cost.lower(self, multiply=multiply)


def _abstract_params(model) -> Tree:
    return model.init(device="meta")


def _logits_spec(B: int, cfg: ModelConfig, mesh) -> Spec:
    """(B, padded_vocab) decode/prefill logits: batch-DP + vocab-TP."""
    return shd._spec_from_trailing((shd.BATCH, "model"), (B, cfg.padded_vocab()), mesh)


def default_adam(cfg: ModelConfig) -> AdamConfig:
    return AdamConfig(lr=3e-4, weight_decay=0.1, clip_norm=1.0,
                      state_dtype=cfg.optimizer_state_dtype)


def _value_and_grad(model, params: Tree, data: Dict[str, torch.Tensor], constrain):
    """(loss, metrics, grads). A DTensor parameter's gradient is placed as
    the parameter is: partial sums over the batch axes are reduced here
    (an all-reduce, or a reduce-scatter where the parameter is sharded)."""
    flat = flatten(params)[1]
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss, metrics = model.train_loss(unflatten(params, leaves), data, constrain)
    grads = torch.autograd.grad(loss, leaves)
    grads = [g.redistribute(p.device_mesh, p.placements) if shd.is_dtensor(p) else g
             for p, g in zip(flat, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def _microbatch(x: torch.Tensor, n_mb: int, i: int) -> torch.Tensor:
    """Rows [i B/n_mb, (i+1) B/n_mb) of x; a DTensor batch is gathered and
    the slice placed on the batch axes again (a shard of x need not hold
    whole microbatches)."""
    B = x.shape[0]
    if not shd.is_dtensor(x):
        return x.reshape(n_mb, B // n_mb, *x.shape[1:])[i]
    mesh = x.device_mesh
    part = shd.full(x).reshape(n_mb, B // n_mb, *x.shape[1:])[i]
    spec = shd.batch_specs({"x": part}, mesh)["x"]
    return shd.place(part, shd.Sharding(mesh, spec, shd.placements(spec, mesh)))


def make_train_step(cfg: ModelConfig, shape: ShapeCell, mesh,
                    adam: AdamConfig | None = None, batch: int | None = None) -> StepBundle:
    """train_step(params, opt_state, data) -> (params, opt_state, metrics):
    the loss and its gradients, over `cfg.microbatches` sequential
    microbatches accumulated in `cfg.grad_accum_dtype`, then one Adam
    update. metrics: ce, aux, loss (means over the microbatches) and the
    pre-clip grad_norm, as plain tensors on every rank."""
    model = model_zoo.build(cfg)
    adam = adam or default_adam(cfg)
    constrain = shd.make_constrain(mesh)
    n_mb = max(1, cfg.microbatches)
    acc_dt = dtype_of(cfg.grad_accum_dtype)

    def train_step(params, opt_state: AdamState, data: Dict[str, torch.Tensor]):
        if n_mb == 1:
            loss, metrics, grads = _value_and_grad(model, params, data, constrain)
        else:
            # gradient accumulation over sequential microbatches
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt), params)
            losses, ms = [], []
            for i in range(n_mb):
                l, m, g = _value_and_grad(model, params,
                                          {k: _microbatch(v, n_mb, i) for k, v in data.items()},
                                          constrain)
                grads = unflatten(params, [a + gi.to(a.dtype) / n_mb for a, gi in
                                           zip(flatten(grads)[1], flatten(g)[1])])
                losses.append(l)
                ms.append(m)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, gnorm = adam_update(grads, opt_state, params, adam)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, {k: shd.full(v) for k, v in metrics.items()}

    params_a = _abstract_params(model)
    opt_a = adam_init(params_a, adam)
    data_a = model_zoo.input_specs(cfg, shape, batch)

    pspec = shd.param_specs(params_a, mesh)
    ospec = AdamState(Spec(), pspec, pspec)
    dspec = shd.batch_specs(data_a, mesh)
    mspec = {k: Spec() for k in ("ce", "aux", "loss", "grad_norm")}
    tos = lambda t: shd.to_shardings(t, mesh)  # noqa: E731
    return StepBundle(fn=train_step, abstract_args=(params_a, opt_a, data_a),
                      in_shardings=(tos(pspec), tos(ospec), tos(dspec)),
                      out_shardings=(tos(pspec), tos(ospec), tos(mspec)),
                      mesh=mesh)


def make_prefill_step(cfg: ModelConfig, shape: ShapeCell, mesh,
                      batch: int | None = None, total_slots: int | None = None) -> StepBundle:
    """prefill_step(params, data) -> (last logits (B, V), states), the
    caches sized for `total_slots` (the prompt length + 1 by default)."""
    model = model_zoo.build(cfg)
    constrain = shd.make_constrain(mesh)

    @torch.no_grad()
    def prefill_step(params, data):
        return model.prefill(params, data, constrain, total_slots=total_slots)

    params_a = _abstract_params(model)
    data_a = model_zoo.input_specs(cfg, shape, batch)
    B, S = data_a["tokens"].shape
    states_a = model.init_decode_state(B, total_slots or S + 1, device="meta")
    pspec = shd.param_specs(params_a, mesh)
    dspec = shd.batch_specs(data_a, mesh)
    sspec = shd.state_specs(states_a, mesh)
    tos = lambda t: shd.to_shardings(t, mesh)  # noqa: E731
    return StepBundle(fn=prefill_step, abstract_args=(params_a, data_a),
                      in_shardings=(tos(pspec), tos(dspec)),
                      out_shardings=(tos(_logits_spec(B, cfg, mesh)), tos(sspec)), mesh=mesh)


def make_decode_step(cfg: ModelConfig, shape: ShapeCell, mesh,
                     batch: int | None = None) -> StepBundle:
    """decode_step(params, states, tokens, pos) -> (logits, states): one
    token against a KV cache of shape.seq_len slots, the states advanced
    in place (the reference donates them)."""
    model = model_zoo.build(cfg)
    constrain = shd.make_constrain(mesh)
    B = batch or shape.global_batch

    @torch.no_grad()
    def decode_step(params, states, tokens, pos):
        return model.decode_step(params, tokens, pos, states, constrain)

    params_a = _abstract_params(model)
    states_a = model.init_decode_state(B, shape.seq_len, device="meta")
    tokens_a = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos_a = torch.empty((), dtype=torch.int32, device="meta")
    pspec = shd.param_specs(params_a, mesh)
    sspec = shd.state_specs(states_a, mesh)
    tspec = shd.batch_specs(tokens_a, mesh)
    tos = lambda t: shd.to_shardings(t, mesh)  # noqa: E731
    return StepBundle(fn=decode_step, abstract_args=(params_a, states_a, tokens_a, pos_a),
                      in_shardings=(tos(pspec), tos(sspec), tos(tspec), tos(Spec())),
                      out_shardings=(tos(_logits_spec(B, cfg, mesh)), tos(sspec)),
                      mesh=mesh)


def make_step(kind: str, cfg: ModelConfig, shape: ShapeCell, mesh,
              batch: int | None = None) -> StepBundle:
    if kind == "train":
        return make_train_step(cfg, shape, mesh, batch=batch)
    if kind == "prefill":
        return make_prefill_step(cfg, shape, mesh, batch=batch)
    if kind == "decode":
        return make_decode_step(cfg, shape, mesh, batch=batch)
    raise ValueError(kind)
