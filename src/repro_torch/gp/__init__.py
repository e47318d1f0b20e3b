"""Kernels (`kernels`: protocol, string registry, RBF) and kernel-dispatched
sufficient statistics (`stats`). The model facades come with the training
slice."""
from repro_torch.gp import kernels
from repro_torch.gp.kernels import Kernel, available, get, register
from repro_torch.gp.stats import (ExactBatch, ExpectedBatch,
                                  streaming_suff_stats, suff_stats)

__all__ = ["Kernel", "available", "get", "register", "kernels",
           "ExactBatch", "ExpectedBatch", "streaming_suff_stats", "suff_stats"]
