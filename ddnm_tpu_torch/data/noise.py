"""Measurement-noise models (port of ddnm_tpu/data/noise.py).

All four types of the CLI's -n/--noise_type, on measurements in the
[-1, 1] domain with sigma already scaled (the runner doubles the CLI
sigma_y). Each call draws from one `torch.Generator`; the runner gives every
image its own (sampling/rng.py STREAM_MEASUREMENT), so an image's noise does
not depend on the batch it runs in. torch does not reproduce JAX's threefry
bits: the two packages agree on the noise's distribution, not its values.
"""

from __future__ import annotations

import torch

__all__ = ["add_noise", "NOISE_TYPES"]

NOISE_TYPES = ("gaussian", "3d_gaussian", "poisson", "speckle")


def _normal(gen: torch.Generator, y: torch.Tensor) -> torch.Tensor:
    return torch.randn(y.shape, generator=gen, device=y.device, dtype=y.dtype)


def add_noise(gen: torch.Generator, y: torch.Tensor, sigma: float,
              noise_type: str = "gaussian") -> torch.Tensor:
    """Return y corrupted by the given noise model.

    gaussian / 3d_gaussian: iid additive N(0, sigma^2) ("3d" is an alias).
    poisson: shot noise: (y + 1) / 2 is Poisson-sampled at rate 1 / sigma^2
      per unit intensity and mapped back (smaller sigma, less noise).
    speckle: multiplicative, y * (1 + sigma * N(0, 1)).
    sigma <= 0 returns y untouched (before the type is looked at, as in the
    JAX package); an unknown type raises ValueError."""
    if sigma <= 0.0:
        return y
    if noise_type in ("gaussian", "3d_gaussian"):
        return y + sigma * _normal(gen, y)
    if noise_type == "poisson":
        lam = 1.0 / sigma**2
        rate = torch.clamp((y + 1.0) / 2.0, min=0.0) * lam
        counts = torch.poisson(rate, generator=gen)
        return (counts / lam) * 2.0 - 1.0
    if noise_type == "speckle":
        return y * (1.0 + sigma * _normal(gen, y))
    raise ValueError(f"unknown noise type {noise_type!r}; known: {NOISE_TYPES}")
