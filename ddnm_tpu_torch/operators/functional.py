"""Simplified-mode degradation operators: plain A / A+ image-space maps
over NHWC tensors (port of ddnm_tpu/operators/functional.py).

  - colorization: A averages channels and replicates the gray over 3
    channels; A+ is A's right inverse on that range.
  - sr_averagepooling: A = non-overlapping mean pool, A+ = nearest-neighbour
    replication (not a scaled adjoint).
  - inpainting: A = A+ = pixelwise mask.
  - sr_color, mask_color_sr / diy: compositions with reversed A+.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = [
    "FunctionalOperator",
    "compose",
    "color2gray",
    "gray2color",
    "avg_pool",
    "mean_upsample",
    "as_mask",
    "build_functional_operator",
]

Tensor = torch.Tensor


def as_mask(mask, device=None) -> Tensor:
    """Normalise a user mask to float32 (H, W, 1) (accepts (H, W) too)."""
    m = torch.as_tensor(np.asarray(mask), dtype=torch.float32, device=device)
    if m.ndim == 2:
        m = m[:, :, None]
    if m.ndim != 3 or m.shape[-1] != 1:
        raise ValueError(f"mask must be (H, W) or (H, W, 1), got {tuple(m.shape)}")
    return m


def color2gray(x: Tensor) -> Tensor:
    """NHWC color -> 3-channel replicated gray (coef 1/3 per channel)."""
    gray = x.mean(dim=-1, keepdim=True)
    return gray.expand(*x.shape[:-1], 3)


def gray2color(x: Tensor) -> Tensor:
    """Pseudo-inverse of color2gray: replicate channel 0."""
    return x[..., 0:1].expand(*x.shape[:-1], 3)


def avg_pool(x: Tensor, scale: int) -> Tensor:
    """Non-overlapping mean pooling on NHWC."""
    b, h, w, c = x.shape
    return x.reshape(b, h // scale, scale, w // scale, scale, c).mean(dim=(2, 4))


def mean_upsample(x: Tensor, scale: int) -> Tensor:
    """Nearest-neighbour replication upsample on NHWC."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, scale, w, scale, c)
    return x.reshape(b, h * scale, w * scale, c)


@dataclasses.dataclass(frozen=True)
class FunctionalOperator:
    """A degradation A with pseudo-inverse A+ over NHWC images.

    `A_ctx`/`Ap_ctx` (optional, together) are context-parameterised forms
    `(z, ctx) -> out` for operators that depend on a runtime tensor, e.g. a
    per-image (B, H, W, 1) mask."""

    name: str
    A: Callable[[Tensor], Tensor]
    Ap: Callable[[Tensor], Tensor]
    A_ctx: Callable[[Tensor, Tensor], Tensor] | None = None
    Ap_ctx: Callable[[Tensor, Tensor], Tensor] | None = None

    def __post_init__(self):
        if (self.A_ctx is None) != (self.Ap_ctx is None):
            raise ValueError(
                "A_ctx and Ap_ctx must be provided together "
                f"(operator {self.name!r})"
            )

    @property
    def has_ctx(self) -> bool:
        return self.A_ctx is not None

    def project(self, x: Tensor, y: Tensor) -> Tensor:
        """Null-space data-consistency residual A+(A(x) - y)."""
        return self.Ap(self.A(x) - y)

    def range_ctx(self, x: Tensor, ctx: Tensor) -> Tensor:
        """A+(A(x)) in the context-parameterised form."""
        return self.Ap_ctx(self.A_ctx(x, ctx), ctx)


def compose(*ops: FunctionalOperator) -> FunctionalOperator:
    """Chain degradations: A = A_n o ... o A_1, A+ = A1+ o ... o An+."""
    if not ops:
        raise ValueError("compose needs at least one operator")

    def A(z):
        for op in ops:
            z = op.A(z)
        return z

    def Ap(z):
        for op in reversed(ops):
            z = op.Ap(z)
        return z

    return FunctionalOperator("o".join(op.name for op in ops), A, Ap)


def build_functional_operator(
    deg: str,
    *,
    image_size: int = 256,
    deg_scale: float = 4.0,
    mask: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> FunctionalOperator:
    """Map a simplified-mode task string to (A, A+).

    `mask` is an (H, W) or (H, W, 1) binary array for the inpainting-style
    tasks; it is placed on `device` (the device of the images)."""
    if deg == "colorization":
        return FunctionalOperator(deg, color2gray, gray2color)

    if deg == "denoising":
        ident = lambda z: z
        return FunctionalOperator(deg, ident, ident)

    if deg == "sr_averagepooling":
        scale = round(deg_scale)
        return FunctionalOperator(
            deg,
            lambda z: avg_pool(z, scale),
            lambda z: mean_upsample(z, scale),
        )

    if deg == "inpainting":
        if mask is None:
            raise ValueError("inpainting requires a mask")
        m = as_mask(mask, device)
        masked = lambda z: z * m
        mask_ctx = lambda z, c: z * c
        return FunctionalOperator(deg, masked, masked, mask_ctx, mask_ctx)

    if deg == "sr_color":
        scale = round(deg_scale)
        return FunctionalOperator(
            deg,
            lambda z: color2gray(avg_pool(z, scale)),
            lambda z: mean_upsample(gray2color(z), scale),
        )

    if deg in ("mask_color_sr", "diy"):
        if mask is None:
            raise ValueError(f"{deg} requires a mask")
        m = as_mask(mask, device)
        scale = round(deg_scale)

        def A(z):
            return avg_pool(color2gray(z * m), scale)

        def Ap(z):
            return gray2color(mean_upsample(z, scale)) * m

        def A_ctx(z, c):
            return avg_pool(color2gray(z * c), scale)

        def Ap_ctx(z, c):
            return gray2color(mean_upsample(z, scale)) * c

        return FunctionalOperator(deg, A, Ap, A_ctx, Ap_ctx)

    raise NotImplementedError(f"simplified degradation {deg} not supported")
