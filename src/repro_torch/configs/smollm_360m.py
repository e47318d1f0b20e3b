"""SmolLM-360M: llama-arch small dense LM. [hf:HuggingFaceTB/SmolLM-360M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="smollm-360m-smoke",
    family="dense",
    num_layers=3,
    d_model=60,
    num_heads=3,
    num_kv_heads=1,
    head_dim=20,
    d_ff=160,
    vocab_size=512,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
