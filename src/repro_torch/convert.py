"""Carry parameters and served states across from the JAX package.

The JAX side hands over numpy arrays (``np.asarray`` of its values), so this
module never sees JAX:

    params_from_numpy({"kern": {"log_variance", "log_lengthscale"}, "Z",
                       "log_beta", ["q_mu", "q_logS"]})
    state_from_numpy({"kern", "Z", "log_beta", "stats": {psi0, psi2, psiY,
                      yy, n}, "L", "LA", "Kuu_inv_mean"})

Both return torch tensors on `device` (the CUDA device unless
``device="cpu"``), in `dtype` when given and in each array's own dtype
otherwise.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.psi_stats import SuffStats
from repro_torch.serve.state import PosteriorState

PARAM_KEYS = ("kern", "Z", "log_beta")
KERN_KEYS = ("log_variance", "log_lengthscale")
GPLVM_KEYS = ("q_mu", "q_logS")


def _tensor(a, dev: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def _missing(mapping: Mapping, keys, what: str) -> None:
    absent = [k for k in keys if k not in mapping]
    if absent:
        raise KeyError(f"{what} lacks {absent}; has {sorted(mapping)}")


def params_from_numpy(params: Mapping, *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's parameter dict (RBF kernel; plus q(X) for the
    GP-LVM) as torch tensors."""
    dev = _device.resolve(device)
    _missing(params, PARAM_KEYS, "params")
    _missing(params["kern"], KERN_KEYS, "params['kern']")
    out = {"kern": {k: _tensor(params["kern"][k], dev, dtype) for k in KERN_KEYS},
           "Z": _tensor(params["Z"], dev, dtype),
           "log_beta": _tensor(params["log_beta"], dev, dtype)}
    for k in GPLVM_KEYS:
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
    kern = {k: _tensor(v, dev, dtype) for k, v in fields["kern"].items()}
    stats = SuffStats(*(_tensor(fields["stats"][k], dev, dtype)
                        for k in SuffStats._fields))
    return PosteriorState(
        kern=kern, stats=stats,
        **{k: _tensor(fields[k], dev, dtype)
           for k in ("Z", "log_beta", "L", "LA", "Kuu_inv_mean")})
