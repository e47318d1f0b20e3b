"""Synthetic data for the examples and checks (counterpart of
`repro.data`)."""
from repro_torch.data.synthetic import gplvm_synthetic

__all__ = ["gplvm_synthetic"]
