"""Optimizers (counterpart of `repro.optim`): the reference's hand-rolled
Adam(W) over nested dicts and tuples of tensors, and its LR schedules."""
from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update, global_norm)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        wsd_schedule)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update", "global_norm",
           "constant_schedule", "cosine_schedule", "wsd_schedule"]
