"""Checkpointing (counterpart of `repro.checkpoint`): atomic, retained,
validated step directories of a tree of tensors, in the reference's
on-disk format."""
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager, leaf_key)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "leaf_key"]
