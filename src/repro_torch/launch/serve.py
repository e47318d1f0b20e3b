"""Serving launcher: batched prefill + greedy decode (counterpart of
`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --preset smoke \\
        --batch 4 --prompt-len 64 --new-tokens 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --preset full

One prefill step builds the KV caches, then a single-token decode step runs
autoregressively (greedy; the logits interface takes any sampler). Prints
prefill time and tokens/s, decode tokens/s and a sample. Every family
serves: the audio family's prompt batch carries encoder frames (encoded
once at prefill), the vlm family's a prefix of patch embeddings, and the
recurrent mixers carry their states where attention keeps a KV cache.
Runs on CUDA unless `--device cpu` (a host without a CUDA device raises).
Started as one process per rank with a process group, `--mesh host` (or
`pod`, `multipod`) serves across the ranks: the batch over "data", the
KV caches' slots and the vocab over "model".
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ShapeCell, get_config, get_smoke_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.launch.train import make_mesh
from repro_torch.models.model_zoo import build, make_batch
from repro_torch.parallel import sharding as shd


@dataclasses.dataclass
class ServeResult:
    prefill_s: float  # host clock around the prefill, to a synchronize
    decode_s: float  # host clock around the decode loop, to a synchronize
    batch: int
    prompt_len: int
    new_tokens: int
    tokens: torch.Tensor  # (B, new_tokens) greedy ids
    prefill_logits: torch.Tensor  # (B, padded vocab) after the prompt
    last_logits: torch.Tensor  # (B, padded vocab) of the last decode step

    @property
    def prefill_tok_s(self) -> float:
        return self.batch * self.prompt_len / self.prefill_s

    @property
    def decode_tok_s(self) -> float:
        return self.batch * self.new_tokens / self.decode_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return (torch.argmax(logits, -1)[:, None] % cfg.vocab_size).to(torch.int32)


@torch.no_grad()
def generate(cfg: ModelConfig, params, batch: dict, new_tokens: int, *,
             mesh=None) -> ServeResult:
    """Prefill `batch` and decode `new_tokens` greedy tokens, timed. On a
    `mesh` of more than one rank the steps run through the prefill and
    decode `StepBundle`s (parameters, batch and states placed by the rules
    table; the caches' slots split over the model axis), and every rank
    picks the next token from the gathered logits."""
    model = build(cfg)
    tokens = batch["tokens"]
    device = tokens.device
    B, S = tokens.shape
    total = S + new_tokens + 1
    if shd.is_distributed(mesh):
        cell = ShapeCell("serve", S + (cfg.frontend_tokens or 0), B, "prefill")
        prefill = make_prefill_step(cfg, cell, mesh, batch=B, total_slots=total).jitted()
        dec = make_decode_step(cfg, ShapeCell("serve", total, B, "decode"), mesh, batch=B)
        decode = dec.jitted()
        params = shd.place(params, dec.in_shardings[0])
        step_logits = shd.full
    else:
        def prefill(p, b):
            return model.prefill(p, b, total_slots=total)

        def decode(p, st, t, pos):
            return model.decode_step(p, t, pos, st)

        def step_logits(t):
            return t
    _sync(device)
    t0 = time.perf_counter()
    logits, states = prefill(params, batch)
    logits = step_logits(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits
    tok = _greedy(logits, cfg)
    pos0 = S + (cfg.frontend_tokens or 0)
    outs = []
    t0 = time.perf_counter()
    for i in range(new_tokens):
        logits, states = decode(params, states, tok, pos0 + i)
        logits = step_logits(logits)
        tok = _greedy(logits, cfg)
        outs.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return ServeResult(t_prefill, t_decode, B, S, new_tokens, torch.cat(outs, 1),
                       prefill_logits, logits)


def serve(arch: str, preset: str = "smoke", *, batch: int = 4, prompt_len: int = 64,
          new_tokens: int = 32, mesh: str = "host", device="cuda", seed: int = 0,
          params: Any = None) -> ServeResult:
    """The launcher's run: parameters from `seed` (or the caller's
    `params`, e.g. a trained model's), a prompt batch drawn from `seed` on
    `device`, then `generate` on the `mesh` ("host": every rank of the
    process group, or this process alone; "pod" / "multipod": the
    production meshes). Every rank draws the same parameters and prompts
    and keeps its own slices."""
    cfg = get_smoke_config(arch) if preset == "smoke" else get_config(arch)
    dev = _device.resolve(device)
    the_mesh = make_mesh(mesh, dev)
    params = params if params is not None else build(cfg).init(seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = make_batch(gen, cfg, ShapeCell("cli", prompt_len, batch, "prefill"), batch=batch)
    return generate(cfg, params, data, new_tokens, mesh=the_mesh)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    r = serve(args.arch, args.preset, batch=args.batch, prompt_len=args.prompt_len,
              new_tokens=args.new_tokens, mesh=args.mesh, device=args.device)
    n_tok = r.batch * r.new_tokens
    print(f"prefill: {r.batch}x{r.prompt_len} in {r.prefill_s*1e3:.1f} ms "
          f"({r.prefill_tok_s:.0f} tok/s)")
    print(f"decode: {n_tok} tokens in {r.decode_s*1e3:.1f} ms ({r.decode_tok_s:.0f} tok/s)")
    print("sample:", r.tokens[0, :16].tolist())
    return r


if __name__ == "__main__":
    main()
