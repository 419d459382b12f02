"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU by name;
a missing card is an error, never a silent fall back to the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `device`; raises if it names CUDA and no card
    is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False. Pass "
            "device='cpu' (--device cpu) to run on the CPU on purpose."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev
