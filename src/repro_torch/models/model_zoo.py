"""Unified model API (counterpart of `repro.models.model_zoo`): build(cfg)
gives (init, train_loss, prefill, decode_step, init_decode_state) for a
config, and `input_specs` / `make_batch` the inputs of an (arch x shape)
cell.

`input_specs(cfg, shape)` returns meta-device tensors for every model
input: shapes and dtypes with no allocation. `make_batch` materializes the
same structure with synthetic data drawn from an explicit generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import encdec, transformer
from repro_torch.parallel.sharding import no_constrain

Tree = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Tree]  # init(seed=0, *, device="cuda")
    train_loss: Callable[..., tuple]  # train_loss(params, batch, constrain=id)
    prefill: Callable[..., tuple]  # prefill(params, batch, constrain=id, total_slots=None)
    decode_step: Callable[..., tuple]  # decode_step(params, tokens, pos, states, constrain=id)
    init_decode_state: Callable[..., Tree]  # init_decode_state(B, S, *, device="cuda")


def build(cfg: ModelConfig) -> Model:
    """The model of cfg's family: the audio family's encoder-decoder
    (`encdec`), every other family's decoder (`transformer`). Each step
    takes the reference's `constrain` hook (`parallel.sharding.
    make_constrain`; the identity by default)."""
    mod = encdec if cfg.family == "audio" else transformer
    return Model(
        cfg=cfg,
        init=lambda seed=0, *, device="cuda": mod.init_params(cfg, seed=seed, device=device),
        train_loss=lambda p, b, constrain=no_constrain: mod.train_loss(
            p, b, cfg, constrain=constrain),
        prefill=lambda p, b, constrain=no_constrain, total_slots=None: mod.prefill(
            p, b, cfg, constrain=constrain, total_slots=total_slots),
        decode_step=lambda p, t, pos, st, constrain=no_constrain: mod.decode_step(
            p, t, pos, st, cfg, constrain=constrain),
        init_decode_state=lambda B, S, *, device="cuda": mod.init_decode_state(
            cfg, B, S, device=device),
    )


# ---------------------------------------------------------------------------
# input specs / synthetic batches per (arch x shape) cell
# ---------------------------------------------------------------------------

def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens in a cell; multimodal prefixes count toward seq_len."""
    if cfg.frontend_tokens:
        return seq_len - cfg.frontend_tokens
    return seq_len


def batch_shapes(cfg: ModelConfig, shape: ShapeCell, batch: int | None = None) -> Dict[str, Any]:
    """Shapes+dtypes of the data batch for train/prefill cells."""
    B = batch if batch is not None else shape.global_batch
    S = _text_len(cfg, shape.seq_len)
    spec: Dict[str, Any] = {"tokens": ((B, S), torch.int32)}
    if cfg.family == "audio":
        spec["encoder_frames"] = ((B, cfg.encoder_frames, cfg.d_model), torch.bfloat16)
    if cfg.frontend_tokens:
        spec["frontend_embeds"] = ((B, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    return spec


def input_specs(cfg: ModelConfig, shape: ShapeCell,
                batch: int | None = None) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins (shape and dtype, no storage) of every input."""
    return {k: torch.empty(shp, dtype=dtype, device="meta")
            for k, (shp, dtype) in batch_shapes(cfg, shape, batch).items()}


def make_batch(gen: torch.Generator, cfg: ModelConfig, shape: ShapeCell,
               batch: int | None = None) -> Dict[str, torch.Tensor]:
    """Synthetic batch matching input_specs, drawn from `gen` on its device:
    token ids uniform over the (unpadded) vocabulary, embeddings normal."""
    out = {}
    for name, (shp, dtype) in batch_shapes(cfg, shape, batch).items():
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                      dtype=dtype, device=gen.device)
        else:
            out[name] = torch.randn(shp, generator=gen, dtype=torch.float32,
                                    device=gen.device).to(dtype)
    return out
