"""Value-range transforms (port of ddnm_tpu/data/transforms.py).

Images flow as float32 NHWC in [0, 1] from IO; the diffusion models work
in [-1, 1] when `rescaled` (all shipped configs are). The optional
dequantizations draw from a numpy Generator on the host, as the JAX
package's, so the same `rng` gives the same values."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["data_transform", "inverse_data_transform"]


def _on_host(x, fn):
    """fn(x as a numpy array) as float32, on x's device when x is a tensor."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(fn(x.detach().cpu().numpy()), dtype=torch.float32).to(x.device)
    return torch.as_tensor(fn(np.asarray(x)), dtype=torch.float32)


def data_transform(x, *, rescaled: bool = True, logit_transform: bool = False,
                   uniform_dequantization: bool = False,
                   gaussian_dequantization: bool = False,
                   rng: np.random.Generator | None = None):
    """[0, 1] -> model domain (rescaled takes precedence over logit, as in
    the reference), after the optional dequantizations: uniform, (255 x +
    U[0, 1)) / 256, then gaussian, x + 0.01 N(0, 1); both draw from `rng`
    (default numpy's default_rng(0)), as the JAX package does."""
    if uniform_dequantization:
        rng = rng or np.random.default_rng(0)
        x = _on_host(x, lambda a: (a * 255.0 + rng.uniform(size=a.shape)) / 256.0)
    if gaussian_dequantization:
        rng = rng or np.random.default_rng(0)
        x = _on_host(x, lambda a: a + rng.standard_normal(a.shape) * 0.01)
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
