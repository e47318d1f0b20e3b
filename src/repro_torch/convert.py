"""Carry parameters and served states across from the JAX package.

The JAX side hands over numpy arrays (``np.asarray`` of its values), so this
module never sees JAX:

    params_from_numpy({"kern": {...}, ["Z"], "log_beta", ["q_mu", "q_logS"]})
    state_from_numpy({"kern", "Z", "log_beta", "stats": {psi0, psi2, psiY,
                      yy, n}, "L", "LA", "Kuu_inv_mean"})
    temporal_state_from_numpy({"kern", "log_beta", "t_last", "m", "P", "n"})
    lm_tree_from_numpy({"embed": {...}, "final_norm": ..., "seg0": (...), ...})
    adam_state_from_numpy(step, m, v)

`kern` is any kernel's parameter tree: a leaf kernel's dict of arrays, or
a composite's dict of part dicts keyed "k0", "k1", ... . Each returns torch
tensors on `device` (the CUDA device unless ``device="cpu"``), in `dtype`
when given and in each array's own dtype otherwise.

An LM tree (`models.transformer`'s or `models.encdec`'s parameters, with
every family's leaves: attention, RG-LRU, RWKV-6 time- and channel-mix,
MoE with its float32 router; Adam's moments) is nested dicts and tuples
of the stacked leaves, carried leaf for leaf in its own dtype. A
bfloat16 array (`np.asarray` of a JAX bfloat16 array is an ml_dtypes one,
which `torch.from_numpy` rejects) crosses widened to float32, which holds
every bfloat16 value exactly, and is cast back.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.psi_stats import SuffStats
from repro_torch.optim.adam import AdamState
from repro_torch.serve.state import PosteriorState
from repro_torch.temporal.model import TemporalState

GPLVM_KEYS = ("q_mu", "q_logS")


def _tensor(a, dev: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widened exactly, cast back
        return torch.from_numpy(arr.astype(np.float32)).to(dev, dtype or torch.bfloat16)
    return torch.as_tensor(arr, dtype=dtype, device=dev)


def _tree(tree, dev: torch.device, dtype: Optional[torch.dtype]):
    """Nested mappings, tuples (NamedTuples too) and lists of arrays as the
    same nesting of tensors."""
    if isinstance(tree, Mapping):
        return {k: _tree(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_tree(v, dev, dtype) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return _tensor(tree, dev, dtype)


def _missing(mapping: Mapping, keys, what: str) -> None:
    absent = [k for k in keys if k not in mapping]
    if absent:
        raise KeyError(f"{what} lacks {absent}; has {sorted(mapping)}")


def params_from_numpy(params: Mapping, *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's parameter dict as torch tensors: "kern" (any
    kernel's tree) and "log_beta", plus "Z" for the collapsed models and
    q(X) for the GP-LVM (a temporal model has no "Z")."""
    dev = _device.resolve(device)
    _missing(params, ("kern", "log_beta"), "params")
    if not isinstance(params["kern"], Mapping) or not params["kern"]:
        raise KeyError("params['kern'] must be a non-empty mapping of the "
                       "kernel's parameters")
    out = {"kern": _tree(params["kern"], dev, dtype),
           "log_beta": _tensor(params["log_beta"], dev, dtype)}
    for k in ("Z", *GPLVM_KEYS):
        if k in params:
            out[k] = _tensor(params[k], dev, dtype)
    return out


def state_from_numpy(fields: Mapping, *, device="cuda",
                     dtype: Optional[torch.dtype] = None) -> PosteriorState:
    """An exported `PosteriorState` (its fields as numpy arrays, `stats` a
    mapping of the `SuffStats` fields) as a torch `PosteriorState`."""
    dev = _device.resolve(device)
    _missing(fields, PosteriorState._fields, "fields")
    _missing(fields["stats"], SuffStats._fields, "fields['stats']")
    stats = SuffStats(*(_tensor(fields["stats"][k], dev, dtype)
                        for k in SuffStats._fields))
    return PosteriorState(
        kern=_tree(fields["kern"], dev, dtype), stats=stats,
        **{k: _tensor(fields[k], dev, dtype)
           for k in ("Z", "log_beta", "L", "LA", "Kuu_inv_mean")})


def temporal_state_from_numpy(fields: Mapping, *, device="cuda",
                              dtype: Optional[torch.dtype] = None
                              ) -> TemporalState:
    """An exported `TemporalState` (its fields as numpy arrays) as a torch
    `TemporalState`."""
    dev = _device.resolve(device)
    _missing(fields, TemporalState._fields, "fields")
    return TemporalState(**{k: _tree(fields[k], dev, dtype)
                            for k in TemporalState._fields})


def lm_tree_from_numpy(tree, *, device="cuda", dtype: Optional[torch.dtype] = None):
    """The reference's LM parameter tree (nested dicts and tuples of numpy
    arrays, bfloat16 ones included) as the same nesting of tensors, each in
    its own dtype (or `dtype`)."""
    return _tree(tree, _device.resolve(device), dtype)


def adam_state_from_numpy(step, m, v, *, device="cuda") -> AdamState:
    """The reference's `AdamState(step, m, v)` (numpy leaves) as the port's:
    step an int32 scalar, m and v trees in their own dtypes."""
    dev = _device.resolve(device)
    return AdamState(torch.as_tensor(np.array(step), dtype=torch.int32, device=dev),
                     _tree(m, dev, None), _tree(v, dev, None))
