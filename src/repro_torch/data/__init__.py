"""Synthetic data for the examples, checks and launchers (counterpart of
`repro.data`)."""
from repro_torch.data.synthetic import TokenStream, TokenStreamState, gplvm_synthetic

__all__ = ["TokenStream", "TokenStreamState", "gplvm_synthetic"]
