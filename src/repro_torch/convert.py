"""Carry parameters and served states across from the JAX package.

The JAX side hands over numpy arrays (``np.asarray`` of its values), so this
module never sees JAX:

    params_from_numpy({"kern": {...}, ["Z"], "log_beta", ["q_mu", "q_logS"]})
    state_from_numpy({"kern", "Z", "log_beta", "stats": {psi0, psi2, psiY,
                      yy, n}, "L", "LA", "Kuu_inv_mean"})
    temporal_state_from_numpy({"kern", "log_beta", "t_last", "m", "P", "n"})

`kern` is any kernel's parameter tree: a leaf kernel's dict of arrays, or
a composite's dict of part dicts keyed "k0", "k1", ... . Each returns torch
tensors on `device` (the CUDA device unless ``device="cpu"``), in `dtype`
when given and in each array's own dtype otherwise.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.psi_stats import SuffStats
from repro_torch.serve.state import PosteriorState
from repro_torch.temporal.model import TemporalState

GPLVM_KEYS = ("q_mu", "q_logS")


def _tensor(a, dev: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def _tree(tree, dev: torch.device, dtype: Optional[torch.dtype]):
    """A nested mapping of arrays as the same nesting of tensors."""
    if isinstance(tree, Mapping):
        return {k: _tree(v, dev, dtype) for k, v in tree.items()}
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
