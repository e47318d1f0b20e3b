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
