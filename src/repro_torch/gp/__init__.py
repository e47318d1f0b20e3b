"""Kernels (`kernels`: protocol, string registry, RBF), kernel-dispatched
sufficient statistics (`stats`) and the model facades (`models`)."""
from repro_torch.gp import kernels
from repro_torch.gp.kernels import Kernel, available, default_rbf, get, register
from repro_torch.gp.models import BayesianGPLVM, SparseGPRegression, regression
from repro_torch.gp.stats import (ExactBatch, ExpectedBatch,
                                  streaming_suff_stats, suff_stats)

__all__ = ["Kernel", "available", "default_rbf", "get", "register", "kernels",
           "BayesianGPLVM", "SparseGPRegression", "regression",
           "ExactBatch", "ExpectedBatch", "streaming_suff_stats", "suff_stats"]
