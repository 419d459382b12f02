"""The synthetic image families the golden trainers and the quality
experiments draw, from JAX threefry keys (sampling/threefry.py), so that
a key gives the JAX package's images:

  - `make_blobs`: three soft coloured Gaussian blobs on a dark field
    (tools/experiments/toy_quality_encoder_cache.py `make_blobs`);
  - `make_class_blobs`: the same geometry with a learnable class, the
    dominant colour channel 0 / 1 / 2 or 3 = gray
    (tools/train_toy_classifier_golden.py `make_class_blobs`);
  - `make_naturals`: 1/f^alpha chromatic texture, an illumination
    gradient, four soft elliptical objects, vignette and grain
    (tools/experiments/natural_family.py `make_naturals`);
  - `make_mix`: half blobs, half naturals (tools/train_mid_golden.py
    `make_mix`).

Each returns NHWC float32 in [-1, 1] on the key's device (a key tensor on
the card draws on the card). Blobs agree with JAX's to float32 rounding
(jnp.linspace and torch.linspace differ in the last bit); naturals to
about 1e-5 (the inverse FFT's rounding).
"""

from __future__ import annotations

import math

import torch

from ddnm_tpu_torch.sampling import threefry

__all__ = ["make_blobs", "make_class_blobs", "make_naturals", "make_mix"]


def _key(key, device=None) -> torch.Tensor:
    key = threefry.as_key(key)
    return key if device is None else key.to(device)


def _grid(res: int, lo: float, hi: float, device):
    """(yy, xx) of jnp.meshgrid(linspace(lo, hi, res) x 2, indexing="ij")."""
    line = torch.linspace(lo, hi, res, dtype=torch.float32, device=device)
    return torch.meshgrid(line, line, indexing="ij")


def _blob_image(centers, colors, widths, res: int):
    yy, xx = _grid(res, 0.0, 1.0, centers.device)
    grid = torch.stack([yy, xx], -1)  # (res, res, 2)
    d2 = ((grid[None, None] - centers[:, :, None, None, :]) ** 2).sum(-1)  # (n, 3, res, res)
    w = torch.exp(-d2 / (2 * widths[..., None] ** 2))
    img = torch.einsum("nbhw,nbc->nhwc", w, colors)
    return torch.clamp(img - 0.6, -1.0, 1.0)


def make_blobs(key, n: int, res: int) -> torch.Tensor:
    """(n, res, res, 3): three soft coloured Gaussian blobs on a dark field."""
    k1, k2, k3 = threefry.split(_key(key), 3)
    centers = threefry.uniform(k1, (n, 3, 2), 0.15, 0.85)
    colors = threefry.uniform(k2, (n, 3, 3), -1.0, 1.0)
    widths = threefry.uniform(k3, (n, 3, 1), 0.05, 0.22)
    return _blob_image(centers, colors, widths, res)


def make_class_blobs(key, n: int, res: int, n_classes: int = 4, classes=None):
    """((n, res, res, 3) images, (n,) int64 labels): the blob geometry with
    a learnable class, 0 / 1 / 2 the dominant colour channel (the others
    dimmed), 3 gray blobs; `classes` forces the labels."""
    k0, k1, k2, k3 = threefry.split(_key(key), 4)
    dev = k0.device
    if classes is None:
        cls = threefry.randint(k0, (n,), 0, n_classes)
    else:
        cls = torch.as_tensor(classes, dtype=torch.int64, device=dev).expand(n).clone()
    centers = threefry.uniform(k1, (n, 3, 2), 0.15, 0.85)
    mag = threefry.uniform(k2, (n, 3, 3), 0.4, 1.0)
    widths = threefry.uniform(k3, (n, 3, 1), 0.05, 0.22)
    dom = torch.where(cls < 3, cls, torch.zeros_like(cls))
    onehot = torch.nn.functional.one_hot(dom, 3).to(torch.float32)[:, None, :]
    colored = mag * (onehot - 0.3 * (1.0 - onehot))
    gray = mag[..., :1].expand(mag.shape)
    colors = torch.where((cls == 3)[:, None, None], gray, colored)
    return _blob_image(centers, colors, widths, res), cls


def make_naturals(key, n: int, res: int) -> torch.Tensor:
    """(n, res, res, 3) images with naturalistic statistics: a 1/f^alpha
    chromatic texture (alpha per image in [2, 2.8]), a directional
    illumination gradient, four soft elliptical objects, vignette, grain."""
    k_spec, k_alpha, k_tint, k_grad, k_obj, k_grain = threefry.split(_key(key), 6)
    dev = k_spec.device

    # 1/f^alpha chromatic texture
    fy = torch.fft.fftfreq(res, device=dev)[:, None]
    fx = torch.fft.rfftfreq(res, device=dev)[None, :]
    f = torch.sqrt(fy ** 2 + fx ** 2)
    f[0, 0] = 1.0 / res  # DC guard
    alpha = threefry.uniform(k_alpha, (n, 1, 1, 1), 2.0, 2.8)
    spec_shape = (n, res, res // 2 + 1, 3)
    re, im = threefry.normal(k_spec, (2, *spec_shape))
    spectrum = torch.complex(re, im) * (f[None, :, :, None] ** (-alpha / 2.0))
    tex = torch.fft.irfft2(spectrum, s=(res, res), dim=(1, 2))
    tex = tex / (tex.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-6)
    tint = threefry.uniform(k_tint, (n, 1, 1, 3), 0.4, 1.0)
    luma = tex.mean(-1, keepdim=True)
    tex = 0.65 * luma + 0.35 * tex * tint

    # directional illumination gradient (angle and amplitude from one key,
    # as the JAX family draws them)
    yy, xx = _grid(res, -1.0, 1.0, dev)
    theta = threefry.uniform(k_grad, (n, 1, 1), 0.0, 2 * math.pi)
    g_amp = threefry.uniform(k_grad, (n, 1, 1), 0.1, 0.5)
    grad = g_amp * (torch.cos(theta) * yy[None] + torch.sin(theta) * xx[None])

    # soft elliptical objects, alpha-composited
    ko = threefry.split(k_obj, 6)
    n_obj = 4
    centers = threefry.uniform(ko[0], (n, n_obj, 2), -0.6, 0.6)
    radii = threefry.uniform(ko[1], (n, n_obj, 2), 0.08, 0.45)
    phi = threefry.uniform(ko[2], (n, n_obj, 1), 0.0, math.pi)
    colors = threefry.uniform(ko[3], (n, n_obj, 3), -0.8, 0.8)
    opac = threefry.uniform(ko[4], (n, n_obj, 1, 1), 0.25, 0.8)
    dy = yy[None, None] - centers[:, :, 0, None, None]
    dx = xx[None, None] - centers[:, :, 1, None, None]
    c, s = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
    u = (c * dy + s * dx) / radii[:, :, 0, None, None]
    v = (-s * dy + c * dx) / radii[:, :, 1, None, None]
    mask = torch.sigmoid((1.0 - (u ** 2 + v ** 2)) * 14.0) * opac  # (n, n_obj, res, res)
    img = 0.32 * tex + grad[..., None]
    for i in range(n_obj):
        m = mask[:, i, :, :, None]
        img = img * (1 - m) + m * (colors[:, i, None, None, :] + 0.18 * tex)

    # vignette and grain
    img = img * (1.0 - 0.25 * (yy ** 2 + xx ** 2)[None, :, :, None])
    img = img + 0.015 * threefry.normal(k_grain, img.shape)
    return torch.clamp(img, -1.0, 1.0)


def make_mix(key, n: int, res: int) -> torch.Tensor:
    """(n, res, res, 3): n // 2 blobs, then n - n // 2 naturals."""
    k1, k2 = threefry.split(_key(key))
    half = n // 2
    return torch.cat([make_blobs(k1, half, res), make_naturals(k2, n - half, res)])
