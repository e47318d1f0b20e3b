"""Training runtime (counterpart of `repro.runtime`): the fault-tolerant
train loop, and the elastic restore of a checkpoint onto another mesh
(`elastic.reshard_for_mesh`)."""
from repro_torch.runtime.elastic import reshard_for_mesh
from repro_torch.runtime.train_loop import LoopConfig, TrainLoop

__all__ = ["LoopConfig", "TrainLoop", "reshard_for_mesh"]
