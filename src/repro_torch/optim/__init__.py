"""Optimizers for the GP models (counterpart of `repro.optim`): the
reference's hand-rolled Adam(W) over nested dicts of tensors."""
from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update, global_norm)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update", "global_norm"]
