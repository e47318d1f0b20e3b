"""RWKV-6 "Finch" 7B: attention-free, data-dependent decay, rwkv
channel-mix FFN. Sub-quadratic => runs long_500k. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    mixer_pattern=("rwkv",),
    rwkv_head_dim=64,
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-7b-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    mixer_pattern=("rwkv",),
    rwkv_head_dim=16,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
