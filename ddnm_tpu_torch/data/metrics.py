"""Quality metrics over NHWC images in [0, 1] (port of
ddnm_tpu/data/metrics.py)."""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

__all__ = ["psnr", "ssim"]


def psnr(a, b, max_val: float = 1.0):
    """Peak signal-to-noise ratio per batch element: MSE over all pixels
    and channels, 10 * log10(max^2 / mse)."""
    mse = ((a - b) ** 2).mean(dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(max_val**2 / mse)


def ssim(a, b, max_val: float = 1.0, kernel_size: int = 11, sigma: float = 1.5):
    """Mean SSIM per batch element (Wang et al., gaussian window, VALID)."""
    a = a.float()
    b = b.float()
    half = kernel_size // 2
    coords = np.arange(kernel_size) - half
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g /= g.sum()
    c = a.shape[-1]
    win = torch.as_tensor(np.outer(g, g), dtype=torch.float32, device=a.device)
    weight = win.expand(c, 1, kernel_size, kernel_size)

    def filt(x):  # depthwise window over NHWC
        return F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c).permute(0, 2, 3, 1)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = filt(a * a) - mu_a2
    var_b = filt(b * b) - mu_b2
    cov = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_a2 + mu_b2 + c1) * (var_a + var_b + c2)
    )
    return s.mean(dim=(1, 2, 3))
