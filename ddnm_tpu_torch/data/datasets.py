"""Evaluation datasets (port of ddnm_tpu/data/datasets.py without PIL).

  - CelebA_HQ / FFHQ-style folders: files listed recursively in sorted
    order and, unless the config marks the set out-of-distribution,
    shuffled with numpy's legacy RandomState(2019) as the reference does,
    so per-index outputs and subset ranges line up with the JAX package;
    each image is squash-resized (BILINEAR) to image_size.
  - ImageNet: a `(filename class)` manifest (`ImageNetManifestDataset`,
    short-edge centre crop then BILINEAR, with labels) or a folder
    (`center_crop_arr`: BOX halving, BICUBIC, centre crop).
  - The ood LSUN folders: `center_crop_arr` as ImageNet's.
  - CelebA (the aligned crop, its test split) and the non-ood LSUN lmdb
    (`<exp>/datasets/<category>`'s val split): data/extra_datasets.py.

Images decode with the port's readers (data/io.py `decode_image`: PNG,
JPEG, WebP, BMP, PNM, told apart by their bytes) and resize with
data/resize.py, which reproduces PIL's uint8 resampler.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from ddnm_tpu_torch.data.extra_datasets import CelebADataset, LSUNDataset
from ddnm_tpu_torch.data.io import read_rgb8
from ddnm_tpu_torch.data.resize import CROP_MODES, crop_and_resize

__all__ = ["FolderDataset", "ImageNetManifestDataset", "get_dataset", "iterate_batches"]

IMG_EXTENSIONS = {".png", ".jpg", ".jpeg", ".ppm", ".bmp", ".webp", ".tif", ".tiff"}


def _list_images(root: Path) -> list[Path]:
    return sorted(p for p in root.rglob("*") if p.suffix.lower() in IMG_EXTENSIONS)


class FolderDataset:
    """Image folder with the reference's fixed shuffle; items are
    (float32 (image_size, image_size, 3) in [0, 1], label 0).

    `crop` is the reference's preprocessing of the dataset family:
    "squash" (CelebA_HQ / FFHQ: BILINEAR to (s, s), no crop), "long_edge"
    (the ImageNet manifest: short-edge centre crop, then BILINEAR) or
    "center_arr" (ImageNet and ood folders: BOX halving, BICUBIC, crop)."""

    def __init__(self, root: str | Path, image_size: int = 256,
                 shuffle_seed: int | None = 2019, crop: str = "squash"):
        if crop not in CROP_MODES:
            raise ValueError(f"unknown crop mode {crop!r}")
        self.paths = _list_images(Path(root))
        self.crop = crop
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        if shuffle_seed is not None:
            idx = np.arange(len(self.paths))
            np.random.RandomState(shuffle_seed).shuffle(idx)
            self.paths = [self.paths[i] for i in idx]
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def _image(self, i: int) -> np.ndarray:
        img = crop_and_resize(read_rgb8(self.paths[i]), self.image_size, self.crop)
        return img.astype(np.float32) / 255.0

    def __getitem__(self, i: int) -> tuple[np.ndarray, int]:
        return self._image(i), 0


class ImageNetManifestDataset(FolderDataset):
    """Images and class labels from a `(filename class)` manifest txt (a
    missing class reads as 0, a listed file that does not exist is left
    out), in manifest order, short-edge centre crop then BILINEAR."""

    def __init__(self, root: str | Path, manifest: str | Path, image_size: int = 256):
        self.crop = "long_edge"
        root = Path(root)
        entries = []
        with open(manifest) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                name, cls = parts[0], int(parts[1]) if len(parts) > 1 else 0
                if (root / name).exists():
                    entries.append((root / name, cls))
        if not entries:
            raise FileNotFoundError(f"no manifest images found under {root}")
        self.paths = [p for p, _ in entries]
        self.labels = [c for _, c in entries]
        self.image_size = image_size

    def __getitem__(self, i: int) -> tuple[np.ndarray, int]:
        return self._image(i), self.labels[i]


def get_dataset(
    name: str,
    *,
    root: str | Path,
    image_size: int = 256,
    manifest: str | Path | None = None,
    subset: tuple[int, int] | None = None,
    out_of_dist: bool = False,
):
    """Build a dataset by the reference config's dataset name.

    `out_of_dist` folders are not shuffled (the seed-2019 shuffle applies
    only to the reference's non-ood branch). `subset` (start, end) slices
    the paths and, where the dataset has them, the labels. A non-ood LSUN
    `root` is `<exp>/datasets/<category>`: the lmdb is
    `<exp>/datasets/<category>_val_lmdb`."""
    low = name.lower()
    if low in ("celeba_hq", "ffhq", "solvay", "oldphoto", "folder"):
        ds = FolderDataset(root, image_size, shuffle_seed=None if out_of_dist else 2019)
    elif low == "celeba":
        ds = CelebADataset(root, image_size, split="test")
    elif low == "lsun" and out_of_dist:
        ds = FolderDataset(root, image_size, shuffle_seed=None, crop="center_arr")
    elif low == "lsun":
        ds = LSUNDataset(Path(root).parent, Path(root).name, "val", image_size)
    elif low == "imagenet" and manifest is not None:
        ds = ImageNetManifestDataset(root, manifest, image_size)
    elif low == "imagenet":
        ds = FolderDataset(root, image_size, shuffle_seed=None, crop="center_arr")
    else:
        raise ValueError(f"unknown dataset {name}")
    if subset is not None:
        start, end = subset
        ds.paths = ds.paths[start:end]
        if hasattr(ds, "labels"):
            ds.labels = ds.labels[start:end]
    return ds


def _load_batch(dataset, idx: list[int]) -> tuple[np.ndarray, np.ndarray]:
    items = [dataset[i] for i in idx]
    return np.stack([im for im, _ in items]), np.asarray([lb for _, lb in items])


def iterate_batches(dataset, batch_size: int, *, prefetch: int = 2, num_workers: int = 4
                    ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Yield (images, labels, valid_count) NHWC batches; the tail batch is
    padded by repeating its last image so every batch has the same shape.

    Batches decode on a pool of `num_workers` threads with `prefetch`
    batches in flight beyond the one being yielded, in order, as the JAX
    package's iterate_batches. The PNG decode is numpy and zlib with
    Python loops for two of the five row filters, and the JPEG decode reads
    its Huffman symbols in a Python loop, so both hold the GIL for part of
    their time. prefetch=0 iterates synchronously."""
    n = len(dataset)
    batches = []
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        valid = len(idx)
        batches.append((idx + [idx[-1]] * (batch_size - valid), valid))
    if prefetch <= 0 or len(batches) <= 1:
        for idx, valid in batches:
            yield (*_load_batch(dataset, idx), valid)
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        ahead = [(pool.submit(_load_batch, dataset, idx), valid)
                 for idx, valid in batches[:prefetch + 1]]
        for idx, valid in batches[prefetch + 1:]:
            fut, v = ahead.pop(0)
            ahead.append((pool.submit(_load_batch, dataset, idx), valid))
            yield (*fut.result(), v)
        for fut, v in ahead:
            yield (*fut.result(), v)
