"""Helpers shared by the LM-side parity tests (`test_torch_lm_*.py`,
`test_torch_gp_head.py`): one config in both packages, trees carried from
JAX to the port through `repro_torch.convert`, and leaf-by-leaf
comparisons. Imported by those test files only."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import base as jbase
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.parallel.sharding import no_constrain
from repro_torch.optim.adam import flatten


def config_pair(cfg: tbase.ModelConfig, **changes):
    """(reference config, port config) with the same fields."""
    fields = {**dataclasses.asdict(cfg), **changes}
    return jbase.ModelConfig(**fields), tbase.ModelConfig(**fields)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree, dtype=None):
    """A JAX (or numpy) tree of dicts and tuples as the port's, on the CPU."""
    return convert.lm_tree_from_numpy(to_numpy(tree), device="cpu", dtype=dtype)


def torch_leaves(tree):
    return flatten(tree)[1]


def rel_err(got, want) -> float:
    """max |got - want| / max(max |want|, tiny), in float64."""
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def assert_trees_close(got, want, tol: float, what: str = "") -> None:
    """Every leaf of the port's tree within `tol` of the reference's,
    relative to the reference leaf's largest entry; paths and shapes equal."""
    paths, leaves = flatten(got)
    ref = jax.tree.leaves(want)
    assert len(leaves) == len(ref), (what, len(leaves), len(ref))
    for path, g, w in zip(paths, leaves, ref):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, path, g.shape, np.shape(w))
        err = rel_err(g, np.asarray(w, np.float64))
        assert err <= tol, (what, path, err)


def lm_batch(cfg, B: int = 2, S: int = 64, seed: int = 0) -> dict:
    """A numpy batch for `cfg`, drawn from `seed`: tokens (B, S), plus the
    audio family's encoder frames and the vlm family's prefix embeddings
    (standard normals, float32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend_tokens:
        out["frontend_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(batch: dict) -> dict:
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


def torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def routing_of(jm, tm, jp, tp, batch: dict) -> list:
    """Every MoE layer's routing in both packages on `batch`, in layer order:
    [(reference top_e, port top_e, the reference's smallest gap between a
    token's k-th and (k+1)-th router probabilities)]. The reference runs
    eagerly (`jax.disable_jit`) so its layers' inputs are concrete."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    E, k = tm.cfg.num_experts, tm.cfg.num_experts_per_tok
    jrec, trec = [], []
    jorig, torig = jmoe.moe_apply, tmoe.moe_apply

    def jwrap(params, x, cfg, constrain=lambda t, s: t):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(xt.astype(jax.numpy.float32) @ params["router"], axis=-1)
        srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
        gap = float(np.min(srt[:, k - 1] - srt[:, k])) if k < E else float("inf")
        jrec.append((np.asarray(jmoe._route(params, xt, E, k)[1]), gap))
        return jorig(params, x, cfg, constrain)

    def twrap(params, x, cfg, constrain=no_constrain):
        trec.append(tmoe._route(params, x.reshape(-1, x.shape[-1]), E, k)[1].numpy())
        return torig(params, x, cfg, constrain)

    jmoe.moe_apply, tmoe.moe_apply = jwrap, twrap
    try:
        with jax.disable_jit():
            jm.train_loss(jp, jax_batch(batch))
        with torch.no_grad():
            tm.train_loss(tp, torch_batch(batch))
    finally:
        jmoe.moe_apply, tmoe.moe_apply = jorig, torig
    assert len(jrec) == len(trec) == tm.cfg.num_layers
    return [(je, te, gap) for (je, gap), te in zip(jrec, trec)]


def assert_same_routing(jm, tm, jp, tp, batch: dict) -> None:
    """The port routes every token of every MoE layer to the reference's
    experts, in the reference's order."""
    for layer, (je, te, gap) in enumerate(routing_of(jm, tm, jp, tp, batch)):
        assert np.array_equal(je, te), (
            f"{tm.cfg.name} layer {layer}: routing differs at "
            f"{int(np.sum(np.any(je != te, axis=-1)))} tokens; the smallest gap between a "
            f"k-th and a (k+1)-th router probability is {gap:.3e} (a gap within float32 "
            f"rounding of the hidden state is a near-tie, not a fault)")
