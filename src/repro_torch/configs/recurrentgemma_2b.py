"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 2:1 pattern
(two recurrent blocks then one window-2048 MQA layer). [arXiv:2402.19427]

Every attention layer is windowed => sub-quadratic => runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mixer_pattern=("rglru", "rglru", "attn"),
    window_pattern=(2048, 2048, 2048),  # applies to the attn positions
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    num_layers=8,  # 2 periods + remainder (rglru, rglru): both segments
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mixer_pattern=("rglru", "rglru", "attn"),
    window_pattern=(16, 16, 16),
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
