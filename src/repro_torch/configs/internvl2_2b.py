"""InternVL2-2B: InternViT frontend (STUB: 256 precomputed patch embeddings
via input_specs) + InternLM2-1.8B-style decoder. [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend_tokens=256,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-2b-smoke",
    family="vlm",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    frontend_tokens=16,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
