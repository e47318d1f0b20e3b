"""Snowflake Arctic-style 480B MoE: 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_dense_residual=True,
    # bf16 Adam moments: float32 moments of 480B parameters are 3.8 TB
    optimizer_state_dtype="bfloat16",
    # one microbatch: each further one would gather the sharded expert
    # weights again; the microbatch / grad_accum knobs trade memory for
    # that traffic
    microbatches=1,
    grad_accum_dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="arctic-480b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    num_experts=8,
    num_experts_per_tok=2,
    moe_dense_residual=True,
    param_dtype="float32",
    compute_dtype="float32",
    logits_chunk=64,
    remat=False,
)
