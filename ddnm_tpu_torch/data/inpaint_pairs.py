"""Paired gt / keep-mask loader of the hq pipeline's sweep (port of
ddnm_tpu/data/inpaint_pairs.py).

Pairs the sorted image trees `gt_path` and `mask_path` by file name (or,
when the names overlap only in part, by position, as the reference does)
and yields {"GT": [-1, 1] (H, W, 3), "GT_name": str, "gt_keep_mask":
{0, 1} (H, W, 3)}.

Each image, gt and mask alike, takes the JAX package's centre crop: a
round trip through uint8 ((x * 255) truncated), then `center_crop_arr`
(BOX halving while the short edge is at least twice `image_size`, BICUBIC
to scale it to `image_size`, a centre crop), which data/resize.py holds
to PIL's bytes; the crop leaves an image already at `image_size` x
`image_size` as the round trip gives it. Any image the port's readers decode
(PNG, JPEG, WebP, BMP, PNM) is accepted.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator

import numpy as np

from ddnm_tpu_torch.data.io import load_image
from ddnm_tpu_torch.data.resize import center_crop_arr

__all__ = ["InpaintPairs"]

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def _tree(root: str | Path) -> list[Path]:
    return sorted(p for p in Path(root).rglob("*") if p.suffix.lower() in _EXTS)


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """The reference's repeated-downsample centre crop of a [0, 1] image,
    through uint8 as the JAX package's."""
    return center_crop_arr((img * 255).astype(np.uint8), size).astype(np.float32) / 255.0


class InpaintPairs:
    """Filename-paired (ground truth, keep-mask) dataset."""

    def __init__(self, gt_path: str | Path, mask_path: str | Path,
                 image_size: int = 256, max_len: int | None = None):
        gts = _tree(gt_path)
        masks = {p.name: p for p in _tree(mask_path)}
        named = [(g, masks[g.name]) for g in gts if g.name in masks]
        if len(named) == len(gts):
            self.pairs = named
        else:
            # a partial name overlap must not silently drop the unmatched
            # gts: pair the sorted trees by position, as the reference does
            if named:
                logging.getLogger("ddnm_tpu_torch").warning(
                    "gt/mask name overlap is partial (%d/%d): pairing by position",
                    len(named), len(gts))
            self.pairs = list(zip(gts, _tree(mask_path)))
        if max_len:
            self.pairs = self.pairs[:max_len]
        if not self.pairs:
            raise FileNotFoundError(f"no gt/mask pairs under {gt_path} / {mask_path}")
        self.image_size = image_size

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int) -> dict:
        gt_p, mask_p = self.pairs[i]
        gt = _center_crop(load_image(gt_p), self.image_size)
        mask = _center_crop(load_image(mask_p), self.image_size)
        return {
            "GT": gt * 2.0 - 1.0,
            "GT_name": gt_p.name,
            "gt_keep_mask": (mask > 0.5).astype(np.float32),
        }

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]
