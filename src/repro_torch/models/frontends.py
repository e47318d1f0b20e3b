"""Modality-frontend stubs (counterpart of `repro.models.frontends`): the
[audio] and [vlm] architectures specify the transformer backbone only, and
their inputs are precomputed frame / patch embeddings.

These stand in for whisper's mel + conv stack and InternViT: tests,
examples and the card's smoke run draw synthetic embeddings of the right
shapes and statistics from an explicit `torch.Generator`, on its device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

WHISPER_FRAMES = 1500  # 30 s audio -> conv-downsampled frame count
INTERNVIT_TOKENS = 256  # 448px / patch14 -> 1024, pixel-shuffled 4x -> 256


def _normal(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device).to(dtype)


def audio_frames_stub(gen: torch.Generator, B: int, cfg: ModelConfig,
                      dtype=torch.float32) -> torch.Tensor:
    """Precomputed post-conv mel-frame embeddings (B, F, d)."""
    return _normal(gen, (B, cfg.encoder_frames, cfg.d_model), dtype)


def patch_embeds_stub(gen: torch.Generator, B: int, cfg: ModelConfig,
                      dtype=torch.float32) -> torch.Tensor:
    """Precomputed InternViT patch embeddings projected to LM width (B, P, d)."""
    return _normal(gen, (B, cfg.frontend_tokens, cfg.d_model), dtype)
