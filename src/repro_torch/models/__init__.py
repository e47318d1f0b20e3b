"""The LM side's models (counterpart of `repro.models`): the dense
decoder's layers, blockwise attention, the segment-stacked transformer and
the `model_zoo` API. The MoE, RG-LRU, RWKV, encoder-decoder and frontend
modules are ROADMAP A4.2."""
