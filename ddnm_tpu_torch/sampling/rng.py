"""Per-image random streams (port of ddnm_tpu/sampling/rng.py).

Every image gets its own `torch.Generator`, seeded from (seed, global image
index, stream), so an image draws the same numbers whatever batch it runs
in. torch's generators do not reproduce JAX's threefry bits: tests that
compare the two frameworks inject the noise through `noise_fn`.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "STREAM_INIT",
    "STREAM_MEASUREMENT",
    "STREAM_SAMPLE",
    "image_generators",
    "default_noise",
    "draw_noise",
    "NoiseFn",
]

# stream ids: x_T, measurement noise, sampler noise (the JAX runner's
# three-way key split per image)
STREAM_INIT, STREAM_MEASUREMENT, STREAM_SAMPLE = 0, 1, 2

NoiseFn = Callable[[Sequence[torch.Generator], tuple], torch.Tensor]


def _seed(seed: int, index: int, stream: int) -> int:
    words = np.random.SeedSequence([seed, index, stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & 0x7FFF_FFFF_FFFF_FFFF


def image_generators(seed: int, indices: Sequence[int], stream: int,
                     device: torch.device | str) -> list[torch.Generator]:
    """One generator per global image index, on `device`."""
    gens = []
    for idx in indices:
        g = torch.Generator(device=device)
        g.manual_seed(_seed(seed, int(idx), stream))
        gens.append(g)
    return gens


def default_noise(gens: Sequence[torch.Generator], shape: tuple) -> torch.Tensor:
    """Standard normal float32 noise of `shape`; row i from gens[i]."""
    return torch.stack([
        torch.randn(tuple(shape[1:]), generator=g, device=g.device,
                    dtype=torch.float32)
        for g in gens
    ])


def draw_noise(noise_fn: NoiseFn, gens: Sequence[torch.Generator], shape: tuple,
               device: torch.device) -> torch.Tensor:
    if len(gens) != shape[0]:
        raise ValueError(f"{len(gens)} generators for a batch of {shape[0]}")
    return noise_fn(gens, tuple(shape)).to(device)
