"""Device choice for the port's entry points, and host <-> card copies
that do not wait.

Entry points run on the card unless the caller asks for the CPU by name;
a missing card is an error, never a silent fall back to the CPU. A copy
between pageable host memory and the card waits for the stream to drain;
`to_device` and `to_host` go through pinned memory and return at once."""

from __future__ import annotations

import torch

__all__ = ["device_arg", "resolve_device", "to_device", "to_host"]


def device_arg(value: str) -> str:
    """The CLIs' --device: cuda, cuda:N or cpu (argparse `type=`)."""
    import argparse

    head, colon, index = value.partition(":")
    if value == "cpu" or (head == "cuda" and (not colon or index.isdigit())):
        return value
    raise argparse.ArgumentTypeError(f"--device must be cuda, cuda:N or cpu, got {value!r}")


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


def to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on `dev`; on a card through pinned memory, enqueued
    without waiting."""
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A card tensor's copy in pinned host memory, enqueued without
    waiting: valid once the stream has passed an event recorded after this
    call. A host tensor is returned as it is."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out
