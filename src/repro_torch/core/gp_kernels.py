"""Covariance functions — compatibility shim (counterpart of
`repro.core.gp_kernels`): the kernel classes live in `repro_torch.gp.kernels`;
this module keeps the old import path (`from repro_torch.core.gp_kernels
import RBF`) working."""
from __future__ import annotations

from repro_torch.gp.kernels import Linear, Params, RBF  # noqa: F401
