"""Value-range transforms (port of ddnm_tpu/data/transforms.py).

Images flow as float32 NHWC in [0, 1] from IO; the diffusion models work
in [-1, 1] when `rescaled` (all shipped configs are). The JAX package's
optional dequantizations are not ported: no config turns them on."""

from __future__ import annotations

import torch

__all__ = ["data_transform", "inverse_data_transform"]


def data_transform(x, *, rescaled: bool = True, logit_transform: bool = False):
    """[0, 1] -> model domain (rescaled takes precedence over logit, as in
    the reference)."""
    if rescaled:
        return 2.0 * x - 1.0
    if logit_transform:
        lam = 1e-6
        x = lam + (1 - 2 * lam) * x
        return torch.log(x) - torch.log1p(-x)
    return x


def inverse_data_transform(x, *, rescaled: bool = True, logit_transform: bool = False):
    """model domain -> [0, 1], clamped."""
    if logit_transform:
        x = 1.0 / (1.0 + torch.exp(-x))
    elif rescaled:
        x = (x + 1.0) / 2.0
    return torch.clamp(x, 0.0, 1.0)
