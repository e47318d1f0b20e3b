"""Gemma3-4B-style dense LM: 5 local (sliding 1024) : 1 global layer pattern,
huge 262k vocab, 128k context. [hf:google/gemma-3-*-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    window_pattern=(1024, 1024, 1024, 1024, 1024, -1),  # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-4b-smoke",
    family="dense",
    num_layers=8,  # 1 full period (6) + remainder (2): exercises both segments
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window_pattern=(16, 16, 16, 16, 16, -1),
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
