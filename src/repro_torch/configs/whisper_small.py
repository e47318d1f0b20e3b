"""Whisper-small: 12L enc + 12L dec, conv/mel frontend stubbed (input_specs
provides the 1500 post-conv frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    encoder_frames=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-small-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    encoder_frames=24,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    act="gelu",
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
