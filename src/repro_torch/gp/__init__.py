"""Kernels (`kernels`: protocol, string registry, the kernel family and
`capabilities`), kernel-dispatched sufficient statistics (`stats`) and the
model facades (`models`; `TemporalGPRegression` loads lazily from
`repro_torch.temporal`, which imports this package's kernels)."""
from repro_torch.gp import kernels
from repro_torch.gp.kernels import (Kernel, available, capabilities,
                                    default_rbf, get, register)
from repro_torch.gp.models import BayesianGPLVM, SparseGPRegression, regression
from repro_torch.gp.stats import (ExactBatch, ExpectedBatch,
                                  streaming_suff_stats, suff_stats)

__all__ = ["Kernel", "available", "capabilities", "default_rbf", "get",
           "register", "kernels", "BayesianGPLVM", "SparseGPRegression",
           "TemporalGPRegression", "regression", "ExactBatch",
           "ExpectedBatch", "streaming_suff_stats", "suff_stats"]


def __getattr__(name):
    if name == "TemporalGPRegression":
        from repro_torch.temporal import TemporalGPRegression

        return TemporalGPRegression
    raise AttributeError(f"module 'repro_torch.gp' has no attribute {name!r}")
