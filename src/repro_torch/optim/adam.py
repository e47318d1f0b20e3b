"""Hand-rolled Adam(W) for nested dicts of tensors (port of
`repro.optim.adam`, as written — not `torch.optim.Adam`):

  * optimizer-state dtype is configurable (`state_dtype`);
  * global-norm clipping in float32 regardless of the state dtype;
  * decoupled weight decay (AdamW) with a mask over "/"-joined key paths;
  * bias correction folded into the step size, so eps is not
    bias-corrected;
  * the moments are updated in float32 and the parameter is rounded to
    float32 before the step is taken, then cast back to its own dtype —
    float64 parameters included.

Parameter trees are nested dicts (or a single tensor), flattened in sorted
key order as `jax.tree` flattens dicts. A Python-number step size is
weakly typed in the reference and so enters the float32 update as float32;
a schedule that returns a tensor widens the step to the promotion of its
dtype and float32, as a non-weak array does in the reference (torch's own
rule would keep a 0-dim tensor from widening the moments).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

Tree = Any  # a tensor, or a dict whose values are trees

_STATE_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16, "float16": torch.float16}


def flatten(tree: Tree) -> Tuple[List[str], List[torch.Tensor]]:
    """(paths, leaves) in sorted key order; a path joins keys with "/"."""
    paths, leaves = [], []

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], (*prefix, str(k)))
        else:
            paths.append("/".join(prefix))
            leaves.append(t)

    walk(tree, ())
    return paths, leaves


def unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped like `like` holding `leaves` (in `flatten`'s order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return unflatten(tree, [fn(x) for x in flatten(tree)[1]])


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None  # None => same dtype as param
    # params matching this predicate get no weight decay (e.g. norms, biases)
    decay_mask: Optional[Callable[[str], bool]] = None


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Tree
    v: Tree


def adam_init(params: Tree, config: AdamConfig) -> AdamState:
    dtype = _STATE_DTYPES[config.state_dtype] if config.state_dtype else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)

    device = flatten(params)[1][0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [(x.float() ** 2).sum() for x in flatten(tree)[1]]
    return torch.sqrt(torch.stack(leaves).sum())


@torch.no_grad()
def adam_update(grads: Tree, state: AdamState, params: Tree,
                config: AdamConfig) -> tuple[Tree, AdamState, torch.Tensor]:
    """Returns (new_params, new_state, pre-clip grad norm)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if config.clip_norm is not None:
        scale = torch.clamp(config.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    lr = config.lr(step) if callable(config.lr) else config.lr
    if isinstance(lr, torch.Tensor):
        wide = torch.promote_types(lr.dtype, torch.float32)
    else:  # weakly typed: takes the update's float32
        wide = torch.float32
        lr = torch.tensor(lr, dtype=wide, device=step.device)
    b1, b2 = config.b1, config.b2
    # fold bias correction into the step size
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    alpha = (lr * torch.sqrt(bc2) / bc1).to(wide)

    paths, flat_p = flatten(params)
    flat_g = flatten(grads)[1]
    flat_m = flatten(state.m)[1]
    flat_v = flatten(state.v)[1]
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, name in zip(flat_p, flat_g, flat_m, flat_v, paths):
        g32 = g.float()
        m_new = b1 * m.float() + (1.0 - b1) * g32
        v_new = b2 * v.float() + (1.0 - b2) * g32 * g32
        delta = alpha * m_new.to(wide) / (torch.sqrt(v_new) + config.eps).to(wide)
        p_new = p.float().to(wide) - delta
        if config.weight_decay > 0.0 and (config.decay_mask is None
                                          or config.decay_mask(name)):
            p_new = p_new - (lr * config.weight_decay).to(wide) * p.float().to(wide)
        new_p.append(p_new.to(p.dtype))
        new_m.append(m_new.to(m.dtype))
        new_v.append(v_new.to(v.dtype))
    return (unflatten(params, new_p),
            AdamState(step, unflatten(params, new_m), unflatten(params, new_v)),
            gnorm)
