"""Config system: architecture configs, input-shape cells, registries
(counterpart of `repro.configs.base`, the same data).

Every architecture is a `ModelConfig` in its own module
(`repro_torch/configs/<id>.py`) registered here, selectable with
``--arch <id>`` in the launchers. Input-shape cells (train_4k /
prefill_32k / decode_32k / long_500k) are global and pair with every arch.
Every family runs in the port's models.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN residual alongside MoE
    capacity_factor: float = 1.25

    # --- attention pattern ---
    # per-layer window sizes; -1 = full/global attention. Length must divide
    # num_layers (the pattern tiles). E.g. gemma3: (1024,)*5 + (-1,)
    window_pattern: Tuple[int, ...] = (-1,)
    # per-layer temporal-mixer types for hybrid archs; tiles like windows.
    # "attn" | "rglru" | "rwkv"
    mixer_pattern: Tuple[str, ...] = ("attn",)

    rope_theta: float = 10000.0

    # --- enc-dec / multimodal stubs ---
    encoder_layers: int = 0
    encoder_frames: int = 0  # whisper: post-conv frame count (stub frontend)
    frontend_tokens: int = 0  # internvl: ViT patch tokens (stub frontend)

    # --- numerics / structure ---
    norm_eps: float = 1e-6
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer_state_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    logits_chunk: int = 512  # sequence-chunked CE (never materialize B,S,V)

    # rwkv6
    rwkv_head_dim: int = 64

    # gradient accumulation: split the global batch into `microbatches`
    # sequential steps (activation memory / microbatches); accumulate in
    # `grad_accum_dtype` (bf16 for arctic, whose float32 accumulator alone
    # would be as large as its bf16 parameters twice over)
    microbatches: int = 1
    grad_accum_dtype: str = "float32"

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def padded_vocab(self) -> int:
        """Megatron-style vocab padding: embedding/logit tables are allocated
        at a multiple of 256 so the vocab dim shards evenly at any TP <= 256
        (whisper 51865, minicpm 122753, internvl 92553 are odd). Padded ids
        are masked to -inf in the CE/logits paths."""
        return -(-self.vocab_size // 256) * 256

    def padded_heads(self, tp: int) -> int:
        """Query heads FLAT-padded to the next multiple of tp so the head dim
        shards evenly over the model axis. Train/prefill attention repeats kv
        heads to the (padded) query-head axis through an explicit head->kv
        gather map, so no group structure is required of the pad — smollm
        pads 15 -> 16 instead of the group-preserving 15 -> 80. Decode uses
        the grouped-unpadded path (heads are not sharded at decode). tp is
        the model axis's size (`constrain.tp`), 1 off a mesh."""
        return -(-self.num_heads // tp) * tp

    def layer_windows(self) -> Tuple[int, ...]:
        reps = -(-self.num_layers // len(self.window_pattern))
        return (self.window_pattern * reps)[: self.num_layers]

    def layer_mixers(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.mixer_pattern))
        return (self.mixer_pattern * reps)[: self.num_layers]

    # Exact parameter counts come from the parameter tree on the meta
    # device (models.model_zoo) — no analytic approximation here.


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "arctic-480b",
    "moonshot-v1-16b-a3b",
    "whisper-small",
    "gemma3-4b",
    "smollm-360m",
    "minicpm-2b",
    "internlm2-20b",
    "recurrentgemma-2b",
    "rwkv6-7b",
    "internvl2-2b",
]

_MODULE_FOR = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(_MODULE_FOR[arch])
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(_MODULE_FOR[arch])
    return mod.SMOKE_CONFIG


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True if the arch can run long_500k (no full-attention layer)."""
    if cfg.family in ("ssm",):
        return True
    if cfg.family == "hybrid":
        # hybrid qualifies if every attention layer is windowed
        mixers, windows = cfg.layer_mixers(), cfg.layer_windows()
        return all(m != "attn" or w > 0 for m, w in zip(mixers, windows))
    return False


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runnable, reason-if-not) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
