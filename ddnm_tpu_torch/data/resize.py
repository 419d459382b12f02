"""Image resampling and the datasets' crops without an imaging package
(the counterpart of the PIL calls in ddnm_tpu/data/datasets.py and
ddnm_tpu/data/io.py).

`resize` reproduces Pillow's uint8 resampler (`ImagingResample`, the path of
`Image.resize` for 8-bit RGB) in numpy, down to its integer arithmetic:

  - a separable filter: BOX (support 0.5), BILINEAR (support 1) or BICUBIC
    (support 2, a = -0.5), its support stretched by the scale factor when
    the axis shrinks;
  - per output pixel, the taps' weights computed in double, normalised to
    sum 1, then scaled to integers with 22 fraction bits, rounded half away
    from zero;
  - sums of uint8 pixels times those integers, from a start of one half,
    shifted right by 22 bits and clipped to [0, 255];
  - the horizontal pass before the vertical, with a uint8 image between
    them, and a pass skipped when its axis keeps its size.

Images are uint8 (H, W, C) arrays. The crops take and return the same.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["resize", "center_crop_arr", "center_crop_long_edge", "crop_and_resize",
           "CROP_MODES"]

_PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 - 2
CROP_MODES = ("squash", "long_edge", "center_arr")


def _box(x):
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {"box": (_box, 0.5), "bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coefficients(in_size: int, out_size: int, resample: str):
    """(first input index, fixed-point weights (out_size, taps)) of one axis:
    Pillow's precompute_coeffs then normalize_coeffs_8bpc. Taps past an
    output pixel's window have weight 0."""
    fn, support = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale * support
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero; the window is clamped to the image
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(taps)
    inside = x[None, :] < xmax[:, None]
    w = np.where(inside, fn(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                            * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for j in range(taps):  # the C loop's order of additions
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, fixed


def _pass(img: np.ndarray, out_size: int, resample: str, axis: int) -> np.ndarray:
    """One separable pass of a uint8 image along `axis` (1: width, 0: height)."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size, resample)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        acc += src[idx[:, j]] * k[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, width: int, height: int, resample: str) -> np.ndarray:
    """Pillow's `Image.resize((width, height), resample)` on a uint8
    (H, W, C) array; `resample` is "box", "bilinear" or "bicubic"."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize takes a uint8 (H, W, C) array, got {img.dtype} {img.shape}")
    if resample not in _FILTERS:
        raise ValueError(f"unknown resample filter {resample!r}; known: {sorted(_FILTERS)}")
    if width < 1 or height < 1:
        raise ValueError(f"output size must be positive, got {width}x{height}")
    out = img
    if width != img.shape[1]:
        out = _pass(out, width, resample, axis=1)
    if height != img.shape[0]:
        out = _pass(out, height, resample, axis=0)
    return out.copy() if out is img else out


def center_crop_arr(img: np.ndarray, size: int) -> np.ndarray:
    """The reference's center_crop_arr: BOX halving while the short edge is
    at least 2 * size, BICUBIC to scale the short edge to `size` (Python
    `round` of the long edge), then a centre crop to size x size."""
    while min(img.shape[:2]) >= 2 * size:
        img = resize(img, img.shape[1] // 2, img.shape[0] // 2, "box")
    scale = size / min(img.shape[:2])
    img = resize(img, round(img.shape[1] * scale), round(img.shape[0] * scale), "bicubic")
    top, left = (img.shape[0] - size) // 2, (img.shape[1] - size) // 2
    return img[top:top + size, left:left + size]


def center_crop_long_edge(img: np.ndarray) -> np.ndarray:
    """Centre crop to the short edge (the reference's CenterCropLongEdge)."""
    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return img[top:top + s, left:left + s]


def crop_and_resize(img: np.ndarray, size: int, crop: str) -> np.ndarray:
    """A dataset's preprocessing of one uint8 image to size x size:
    "center_arr" (center_crop_arr), "long_edge" (the short-edge centre crop)
    or "squash" (no crop), then a BILINEAR resize where the size differs."""
    if crop not in CROP_MODES:
        raise ValueError(f"unknown crop mode {crop!r}; known: {CROP_MODES}")
    if crop == "center_arr":
        img = center_crop_arr(img, size)
    elif crop == "long_edge":
        img = center_crop_long_edge(img)
    if img.shape[:2] != (size, size):
        img = resize(img, size, size, "bilinear")
    return img
