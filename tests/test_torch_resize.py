"""The port's PIL-free resampler and crops (ddnm_tpu_torch/data/resize.py)
against Pillow, which the JAX package's datasets call.

Inputs: synthetic non-square uint8 RGB images made from a seed (smooth
ramps plus noise, so both the filters' smooth response and their negative
lobes on edges show) at 300 x 417, 517 x 389 and 1030 x 771 (width x
height). The port reproduces Pillow's integer arithmetic, so the gate is
the bound for a resampler that rounds in fixed point: max |difference|
<= 1 uint8 level and at most 0.1% of the values differing.

  - `resize` against `Image.resize` with BOX, BILINEAR and BICUBIC at the
    sizes the crops ask for (halving, the short edge to 256, squash to
    256 x 256) and at an upsampling size;
  - the datasets end to end: the port's FolderDataset against the JAX
    package's on the same PNG folder in each crop mode, at image_size 256
    and 128 (at 128 the 1030 x 771 image is BOX-halved twice);
  - `load_image(path, size)` (BICUBIC) against the JAX package's;
  - a 256 x 256 image passes every crop mode unchanged."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ddnm_tpu.data.datasets import FolderDataset as JFolderDataset
from ddnm_tpu.data.io import load_image as j_load_image
from ddnm_tpu_torch.data.datasets import FolderDataset
from ddnm_tpu_torch.data.io import encode_png, load_image
from ddnm_tpu_torch.data.resize import CROP_MODES, crop_and_resize, resize

SIZES = [(300, 417), (517, 389), (1030, 771)]  # (width, height)
FILTERS = {"box": Image.BOX, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}


def synthetic(width: int, height: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(xx / (17 + 5 * c) + yy / (29 - 3 * c)) for c in range(3)],
                    axis=-1)
    base[height // 3:height // 2, width // 4:width // 2] = (250, 10, 128)  # hard edges
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def assert_close(ours: np.ndarray, ref: np.ndarray):
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_matches_pillow(size, filt):
    w, h = size
    img = synthetic(w, h, seed=w)
    short = min(w, h)
    outs = [(w // 2, h // 2), (256, 256), (round(w * 256 / short), round(h * 256 / short)),
            (w + 37, h + 11)]
    for ow, oh in outs:
        ref = np.asarray(Image.fromarray(img).resize((ow, oh), FILTERS[filt]))
        assert_close(resize(img, ow, oh, filt), ref)


@pytest.mark.parametrize("image_size", [256, 128])
@pytest.mark.parametrize("crop", CROP_MODES)
def test_crop_modes_match_jax_datasets(tmp_path, crop, image_size):
    for i, (w, h) in enumerate(SIZES):
        (tmp_path / f"{i}.png").write_bytes(encode_png(synthetic(w, h, seed=i)))
    ours = FolderDataset(tmp_path, image_size, shuffle_seed=None, crop=crop)
    ref = JFolderDataset(tmp_path, image_size, shuffle_seed=None, crop=crop)
    assert ours.paths == ref.paths and len(ours) == 3
    for i in range(3):
        a, b = ours[i][0], ref[i][0]
        assert a.shape == (image_size, image_size, 3) and a.dtype == np.float32
        assert_close(np.rint(a * 255).astype(np.uint8), np.rint(b * 255).astype(np.uint8))


def test_load_image_resizes_as_jax(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(synthetic(300, 417, seed=5)))
    for size in (None, 64, 256):
        a, b = load_image(path, size), j_load_image(path, size)
        assert a.shape == b.shape and a.dtype == np.float32
        assert_close(np.rint(a * 255).astype(np.uint8), np.rint(b * 255).astype(np.uint8))


def test_256_square_is_the_identity():
    img = synthetic(256, 256, seed=9)
    for crop in CROP_MODES:
        assert np.array_equal(crop_and_resize(img, 256, crop), img)
    for filt in FILTERS:
        out = resize(img, 256, 256, filt)
        assert np.array_equal(out, img) and out is not img


def test_resize_refuses_what_it_does_not_take():
    img = synthetic(8, 6, seed=0)
    with pytest.raises(ValueError, match="uint8"):
        resize(img.astype(np.float32), 4, 3, "box")
    with pytest.raises(ValueError, match="unknown resample"):
        resize(img, 4, 3, "lanczos")
    with pytest.raises(ValueError, match="unknown crop"):
        crop_and_resize(img, 4, "fill")
