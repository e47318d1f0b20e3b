"""Device resolution for the port's entry points.

Entry points default to the CUDA device. On a host without one they raise
instead of quietly running on the CPU: a caller who wants the plain PyTorch
versions says so with ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """`device` as a concrete `torch.device` (a bare "cuda" gets the current
    device's index); raises RuntimeError if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
