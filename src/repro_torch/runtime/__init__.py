"""Training runtime (counterpart of `repro.runtime`): the fault-tolerant
train loop. The reference's elastic restore onto another mesh
(`runtime/elastic`) waits for `parallel/sharding`."""
from repro_torch.runtime.train_loop import LoopConfig, TrainLoop

__all__ = ["LoopConfig", "TrainLoop"]
