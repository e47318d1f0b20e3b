"""InternLM2-20B: dense GQA LM. [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
)

SMOKE_CONFIG = ModelConfig(
    name="internlm2-20b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
