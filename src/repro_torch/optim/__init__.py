"""Optimizers (counterpart of `repro.optim`): the reference's hand-rolled
Adam(W) over nested dicts and tuples of tensors, its LR schedules and
top-k gradient compression with error feedback."""
from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update, global_norm)
from repro_torch.optim.compression import (CompressionState,
                                           compression_init,
                                           topk_compress_decompress)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        wsd_schedule)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update", "global_norm",
           "constant_schedule", "cosine_schedule", "wsd_schedule",
           "CompressionState", "compression_init", "topk_compress_decompress"]
