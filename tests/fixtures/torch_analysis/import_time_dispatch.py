"""Seeded lint violation (ANL001): the device read at IMPORT time. The
snapshot below goes stale when CUDA_VISIBLE_DEVICES changes or a rank is
spawned later — the device must be read at call time. Linted as source
text with a virtual repro_torch/ path; never imported."""
import torch

HAS_CARD = torch.cuda.is_available()  # ANL001: must be read at call time


def device() -> str:
    return "cuda" if HAS_CARD else "cpu"
