"""LR schedules (counterpart of `repro.optim.schedule`): functions of a
step tensor returning a float32 learning rate. WSD (warmup-stable-decay) is
minicpm-2b's recipe (arXiv:2404.06395); cosine the default for the rest."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    def fn(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def wsd_schedule(peak_lr: float, warmup_steps: int, stable_steps: int, decay_steps: int,
                 min_ratio: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, flat plateau, a decay tail linear
    in log space."""
    def fn(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay_start = warmup_steps + stable_steps
        frac = torch.clamp((step - decay_start) / max(decay_steps, 1), 0.0, 1.0)
        decay = peak_lr * torch.exp(frac * math.log(min_ratio))
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < decay_start,
                                       torch.tensor(peak_lr, dtype=torch.float32,
                                                    device=step.device), decay))

    return fn
