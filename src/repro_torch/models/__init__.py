"""The LM side's models (counterpart of `repro.models`): the layers,
blockwise attention, the segment-stacked transformer with its mixers
(attention, RG-LRU, RWKV-6) and MoE FFN, the encoder-decoder, the
modality-frontend stubs and the `model_zoo` API. On a device mesh every
step runs sharded by `parallel.sharding`'s rules, MoE through its
expert-parallel paths."""
