"""CelebA (aligned) and LSUN (lmdb) datasets (port of
ddnm_tpu/data/extra_datasets.py without PIL).

  - `CelebADataset`: `root/img_align_celeba/*.jpg` (or `*.png`), the split
    of `list_eval_partition.txt` (0 train, 1 valid, 2 test), the targets of
    the four other metadata files, the 128 x 128 aligned-face window
    (`celeba_crop`), then BICUBIC to `image_size` with data/resize.py,
    which reproduces PIL's resampler. No download: the images are placed
    by hand.
  - `LSUNDataset` / `LSUNMulti`: `root/<category>_<split>_lmdb`, the keys
    enumerated once and pickled to `_cache_<lmdb dirname>` next to the lmdb
    directory, each value centre-cropped to its short edge then BICUBIC.
    They need the `lmdb` package, which neither the development host nor
    the card's machine has: opening one raises the JAX package's
    ImportError. Values decode with `decode_rgb8` (PNG, JPEG, WebP, BMP,
    PNM; LSUN's own export writes WebP).

Images decode with the port's readers (data/io.py, data/jpeg.py,
data/webp.py), which give PIL's `convert("RGB")` bytes.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from ddnm_tpu_torch.data.io import decode_rgb8, read_rgb8
from ddnm_tpu_torch.data.resize import center_crop_long_edge, resize

logger = logging.getLogger("ddnm_tpu_torch")

__all__ = ["CelebADataset", "LSUNDataset", "LSUNMulti", "celeba_crop", "LSUN_CATEGORIES"]

# the reference's aligned crop: a 128 x 128 window centred at (cx 89, cy 121)
# of the 178 x 218 aligned images
_CX, _CY = 89, 121


def celeba_crop(img: np.ndarray) -> np.ndarray:
    """The 128 x 128 aligned-face window (rows cy +- 64, columns cx +- 64)."""
    return img[_CY - 64:_CY + 64, _CX - 64:_CX + 64]


# --------------------------------------------------------------- CelebA
def _read_celeba_table(path: Path, skip_count_line: bool):
    """One whitespace-delimited CelebA metadata file -> (column names or
    None, file names, int64 value rows). `skip_count_line`: the attr,
    bbox and landmark files start with an image count, then a line of
    column names (which, in bbox and landmarks, names the image_id column
    too)."""
    lines = [ln.split() for ln in path.read_text().splitlines() if ln.strip()]
    names = None
    if skip_count_line:
        names, rows = lines[1], lines[2:]
        if rows and len(names) == len(rows[0]):
            names = names[1:]
    else:
        rows = lines
    filenames = [r[0] for r in rows]
    values = np.asarray([[int(v) for v in r[1:]] for r in rows], np.int64)
    return names, filenames, values


_SPLIT_IDX = {"train": 0, "valid": 1, "test": 2}

_CELEBA_META = {
    # target_type -> (file name, has the count and header lines)
    "attr": ("list_attr_celeba.txt", True),
    "identity": ("identity_CelebA.txt", False),
    "bbox": ("list_bbox_celeba.txt", True),
    "landmarks": ("list_landmarks_align_celeba.txt", True),
}


class CelebADataset:
    """Aligned CelebA faces: crop, then BICUBIC to `image_size`.

    `split` selects by list_eval_partition.txt when it exists; otherwise
    every image on disk (jpg, then png, each sorted). `target_type` (a str
    or a list of "attr", "identity", "bbox", "landmarks") loads those files
    and returns the targets beside the image, rows in the partition file's
    order; attr maps {-1, 1} to {0, 1}. With no target_type the target is 0."""

    def __init__(self, root: str | Path, image_size: int = 64,
                 split: Optional[str] = None,
                 target_type: Union[str, Sequence[str]] = ()):
        root = Path(root)
        self.root = root
        img_dir = root / "img_align_celeba"
        if not img_dir.exists():
            img_dir = root
        self.target_type = [target_type] if isinstance(target_type, str) else list(target_type)
        for t in self.target_type:
            if t not in _CELEBA_META:
                raise ValueError(f"unknown CelebA target_type {t!r} "
                                 f"(choose from {sorted(_CELEBA_META)})")
        if split is not None and split not in _SPLIT_IDX:
            raise ValueError('Wrong split entered! Please use split="train" or '
                             'split="valid" or split="test"')

        part_file = root / "list_eval_partition.txt"
        self.attr_names: Optional[list[str]] = None
        self._meta: dict[str, np.ndarray] = {}
        if part_file.exists():
            _, filenames, parts = _read_celeba_table(part_file, False)
            parts = parts[:, 0]
            keep = (parts == _SPLIT_IDX[split]) if split is not None else np.ones(
                len(filenames), bool)
            ordered = [f for f, k in zip(filenames, keep) if k]
            on_disk = {p.name: p for p in
                       list(img_dir.glob("*.jpg")) + list(img_dir.glob("*.png"))}
            self.paths = [on_disk[f] for f in ordered if f in on_disk]
            present = [f in on_disk for f in ordered]
            for t in self.target_type:
                fname, has_header = _CELEBA_META[t]
                meta_path = root / fname
                if not meta_path.exists():
                    raise FileNotFoundError(f"target_type={t!r} needs {meta_path}")
                names, meta_files, values = _read_celeba_table(meta_path, has_header)
                by_name = dict(zip(meta_files, values))
                rows = np.stack([by_name[f] for f, p in zip(ordered, present) if p])
                if t == "attr":
                    rows = (rows + 1) // 2
                    self.attr_names = names
                self._meta[t] = rows
        else:
            if self.target_type:
                raise FileNotFoundError(f"target_type={self.target_type} needs "
                                        f"{part_file} to fix the row order")
            self.paths = sorted(img_dir.glob("*.jpg")) + sorted(img_dir.glob("*.png"))
        if not self.paths:
            raise FileNotFoundError(
                f"no CelebA images under {img_dir}; download img_align_celeba "
                "manually (automatic Google-Drive download is not supported)")
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int):
        # the JAX package's float round trip: [0, 1] float32, crop, then
        # (x * 255) truncated to uint8 for the resize
        img = celeba_crop(read_rgb8(self.paths[i]).astype(np.float32) / 255.0)
        if img.shape[0] != self.image_size:
            img = resize((img * 255).astype(np.uint8), self.image_size, self.image_size,
                         "bicubic").astype(np.float32) / 255.0
        if not self.target_type:
            return img, 0
        targets = [self._meta[t][i] for t in self.target_type]
        return img, (targets[0] if len(targets) == 1 else tuple(targets))


# ----------------------------------------------------------------- LSUN
def _require_lmdb():
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "LSUN lmdb datasets need the 'lmdb' package (not bundled in "
            "this image). Export the lmdb to a folder of images and use "
            "the FolderDataset/ood path instead."
        ) from e
    return lmdb


LSUN_CATEGORIES = (
    "bedroom", "bridge", "church_outdoor", "classroom", "conference_room",
    "dining_room", "kitchen", "living_room", "restaurant", "tower", "cat",
)
_LSUN_SPLITS = ("train", "val", "test")


class LSUNDataset:
    """One LSUN lmdb category, items (float32 (image_size, image_size, 3)
    in [0, 1], 0).

    The keys are enumerated once and pickled to `_cache_<lmdb dirname>`
    next to the lmdb directory, which makes reopening cheap; a cache there
    is trusted (it is this class's own file). `use_key_cache=False`
    neither reads nor writes it."""

    def __init__(self, root: str | Path, category: str, split: str = "val",
                 image_size: int = 256, use_key_cache: bool = True):
        self._init_lmdb(Path(root) / f"{category}_{split}_lmdb", image_size, use_key_cache)

    @classmethod
    def from_lmdb_dir(cls, path: str | Path, image_size: int = 256,
                      use_key_cache: bool = True) -> "LSUNDataset":
        """Open an explicit `<...>_lmdb` directory."""
        self = cls.__new__(cls)
        self._init_lmdb(Path(path), image_size, use_key_cache)
        return self

    def _init_lmdb(self, path: Path, image_size: int, use_key_cache: bool):
        lmdb = _require_lmdb()
        self.env = lmdb.open(str(path), max_readers=1, readonly=True, lock=False,
                             readahead=False, meminit=False)
        with self.env.begin(write=False) as txn:
            self.length = txn.stat()["entries"]
        cache_file = path.parent / f"_cache_{path.name}"
        if use_key_cache and cache_file.is_file():
            self.keys = pickle.loads(cache_file.read_bytes())
        else:
            with self.env.begin(write=False) as txn:
                self.keys = [k for k, _ in txn.cursor()]
            if use_key_cache:
                try:
                    cache_file.write_bytes(pickle.dumps(self.keys))
                except OSError:  # a read-only dataset mount: the cache is best-effort
                    logger.debug("LSUN key cache not writable: %s", cache_file)
        self.image_size = image_size

    def __len__(self):
        return self.length

    def __getitem__(self, i: int):
        key = self.keys[i]
        with self.env.begin(write=False) as txn:
            buf = txn.get(key)
        img = center_crop_long_edge(decode_rgb8(bytes(buf), f"LSUN key {key!r}"))
        img = resize(img, self.image_size, self.image_size, "bicubic")
        return img.astype(np.float32) / 255.0, 0


def _verify_lsun_classes(classes: Union[str, Sequence[str]]) -> list[str]:
    """"train" / "val" expand to every category, "test" is the one shared
    test db, a list holds `<category>_<split>` entries; others raise."""
    if isinstance(classes, str):
        if classes not in _LSUN_SPLITS:
            raise ValueError(
                f"Unknown value '{classes}' for classes. Valid string "
                f"values are {_LSUN_SPLITS} (or pass a list of "
                "'<category>_<split>' entries).")
        if classes == "test":
            return [classes]
        return [c + "_" + classes for c in LSUN_CATEGORIES]
    out = []
    for c in classes:
        if not isinstance(c, str):
            raise ValueError("Expected type str for elements in argument classes, "
                             f"but got type {type(c)}.")
        parts = c.split("_")
        category, split = "_".join(parts[:-1]), parts[-1]
        if category not in LSUN_CATEGORIES:
            raise ValueError(f"Unknown value '{category}' for LSUN class. Valid values "
                             f"are {{{', '.join(LSUN_CATEGORIES)}}}.")
        if split not in _LSUN_SPLITS:
            raise ValueError(f"Unknown value '{split}' for postfix. Valid values are "
                             f"{{{', '.join(_LSUN_SPLITS)}}}.")
        out.append(c)
    return out


class LSUNMulti:
    """LSUN categories concatenated: `classes` is "train" / "val" / "test"
    or a list such as ["bedroom_train", "church_outdoor_train"]; an index
    goes to the db that holds it by the cumulative counts, and the target
    is the category's index in `self.classes`."""

    def __init__(self, root: str | Path, classes: Union[str, Sequence[str]] = "train",
                 image_size: int = 256, use_key_cache: bool = True):
        self.classes = _verify_lsun_classes(classes)
        root = Path(root)
        self.dbs = [LSUNDataset.from_lmdb_dir(root / f"{c}_lmdb", image_size, use_key_cache)
                    for c in self.classes]
        self.indices = []
        count = 0
        for db in self.dbs:
            count += len(db)
            self.indices.append(count)
        self.length = count

    def __len__(self):
        return self.length

    def __getitem__(self, index: int):
        target = sub = 0
        for ind in self.indices:
            if index < ind:
                break
            target += 1
            sub = ind
        img, _ = self.dbs[target][index - sub]
        return img, target
