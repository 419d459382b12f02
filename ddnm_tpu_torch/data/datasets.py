"""Image-folder datasets (port of the folder part of
ddnm_tpu/data/datasets.py).

CelebA_HQ / FFHQ-style evaluation sets are plain PNG folders: files are
listed recursively in sorted order and, unless the config marks the set
out-of-distribution, shuffled with numpy's legacy RandomState(2019) as the
reference does, so per-index outputs and subset ranges line up with the
JAX package. Images load at their stored size; resizing and cropping are
not ported yet and a size mismatch raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from ddnm_tpu_torch.data.io import load_image

__all__ = ["FolderDataset", "get_dataset", "iterate_batches"]

IMG_EXTENSIONS = {".png", ".jpg", ".jpeg", ".ppm", ".bmp", ".webp", ".tif", ".tiff"}


def _list_images(root: Path) -> list[Path]:
    return sorted(p for p in root.rglob("*") if p.suffix.lower() in IMG_EXTENSIONS)


class FolderDataset:
    """Image folder with the reference's fixed shuffle; items are
    (float32 (H, W, 3) in [0, 1], label 0)."""

    def __init__(self, root: str | Path, image_size: int = 256,
                 shuffle_seed: int | None = 2019):
        self.paths = _list_images(Path(root))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        if shuffle_seed is not None:
            idx = np.arange(len(self.paths))
            np.random.RandomState(shuffle_seed).shuffle(idx)
            self.paths = [self.paths[i] for i in idx]
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> tuple[np.ndarray, int]:
        return load_image(self.paths[i], self.image_size), 0


def get_dataset(
    name: str,
    *,
    root: str | Path,
    image_size: int = 256,
    subset: tuple[int, int] | None = None,
    out_of_dist: bool = False,
) -> FolderDataset:
    """Build a folder dataset by the reference config's dataset name.

    `out_of_dist` folders are not shuffled (the seed-2019 shuffle applies
    only to the reference's non-ood branch)."""
    if name.lower() not in ("celeba_hq", "ffhq", "solvay", "oldphoto", "folder"):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (folder datasets only: "
            "CelebA_HQ, FFHQ, solvay, oldphoto, folder)")
    ds = FolderDataset(root, image_size, shuffle_seed=None if out_of_dist else 2019)
    if subset is not None:
        start, end = subset
        ds.paths = ds.paths[start:end]
    return ds


def iterate_batches(dataset, batch_size: int
                    ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Yield (images, labels, valid_count) NHWC batches; the tail batch is
    padded by repeating its last image so every batch has the same shape."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        valid = len(idx)
        idx = idx + [idx[-1]] * (batch_size - valid)
        items = [dataset[i] for i in idx]
        yield (np.stack([im for im, _ in items]),
               np.asarray([lb for _, lb in items]), valid)
