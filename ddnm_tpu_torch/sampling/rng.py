"""Per-image random streams (port of ddnm_tpu/sampling/rng.py).

Every image gets its own `torch.Generator`, seeded from (seed, global image
index, stream), so an image draws the same numbers whatever batch it runs
in. Every Mask-Shift tile gets its own too, seeded from (seed, image index,
tile row, tile column, stream) (`tile_generators`), so a tile draws the
same noise whatever wavefront group it runs in (the JAX package folds a
key per tile for the same reason). torch's generators do not reproduce JAX's threefry bits: tests that
compare the two frameworks inject the noise through `noise_fn`.

A sampler takes a `threefry.KeyNoise` in place of the generators to draw
JAX's own noise from a JAX key (the exported samplers of serving.py do):
`draw_noise` then splits its key before every step, as the JAX samplers
do, and draws `normal` from the second half.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ddnm_tpu_torch.sampling import graphs
from ddnm_tpu_torch.sampling.threefry import KeyNoise

__all__ = [
    "STREAM_INIT",
    "STREAM_MEASUREMENT",
    "STREAM_SAMPLE",
    "image_generators",
    "tile_generators",
    "default_noise",
    "draw_noise",
    "skip_noise",
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


def tile_generators(seed: int, image_index: int, tiles: Sequence[tuple[int, int]],
                    stream: int, device: torch.device | str) -> list[torch.Generator]:
    """One generator per tile (row, column) of image `image_index`."""
    gens = []
    for i, j in tiles:
        words = np.random.SeedSequence([seed, image_index, i, j, stream]).generate_state(
            2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed((int(words[0]) << 32 | int(words[1])) & 0x7FFF_FFFF_FFFF_FFFF)
        gens.append(g)
    return gens


def default_noise(gens: Sequence[torch.Generator], shape: tuple) -> torch.Tensor:
    """Standard normal float32 noise of `shape`; row i from gens[i]."""
    return torch.stack([
        torch.randn(tuple(shape[1:]), generator=g, device=g.device,
                    dtype=torch.float32)
        for g in gens
    ])


def draw_noise(noise_fn: NoiseFn, gens: Sequence[torch.Generator] | KeyNoise, shape: tuple,
               device: torch.device) -> torch.Tensor:
    """The next step's noise of `shape`: `noise_fn(gens, shape)`, or the
    next draw of a KeyNoise (which takes no noise_fn but the default).
    Noise drawn on another device is copied to `device`, except inside a
    CUDA graph's warm-up or capture (the scan driver, sampling/graphs.py),
    where such a copy cannot be captured: there it raises."""
    if isinstance(gens, KeyNoise):
        if noise_fn is not default_noise:
            raise ValueError("a KeyNoise draws JAX's noise from its key: it takes no noise_fn")
        return _on(gens.draw(shape), device)
    if len(gens) != shape[0]:
        raise ValueError(f"{len(gens)} generators for a batch of {shape[0]}")
    return _on(noise_fn(gens, tuple(shape)), device)


def _on(noise: torch.Tensor, device: torch.device) -> torch.Tensor:
    elsewhere = noise.device.type != device.type or (
        device.index is not None and noise.device.index != device.index)
    if elsewhere and graphs.capturing():
        raise RuntimeError(
            f"loop='scan' captures the trajectory on {device}, but the noise was drawn on "
            f"{noise.device}: draw it on {device} (generators or a key there) or use "
            "loop='host'")
    return noise.to(device)


def skip_noise(gens: Sequence[torch.Generator] | KeyNoise) -> None:
    """A step that draws no noise: a KeyNoise splits its key all the same,
    as JAX's multistep solver does; generators are left alone."""
    if isinstance(gens, KeyNoise):
        gens.skip()
