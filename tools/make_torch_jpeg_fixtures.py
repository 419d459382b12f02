#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's data layer with PIL, and PIL's own
decode of each as the oracle the port's numpy decoder is held to.

    python tools/make_torch_jpeg_fixtures.py

Writes (about 1.5 MiB in all):
  - exp/datasets/celeba_hq_jpeg/0000k.jpg: the 8 images of
    exp/datasets/celeba_hq at quality 90, 4:2:0; 00003.jpg with a restart
    marker every 4 MCUs (the JPEG copy of the main path's input);
  - exp/datasets/face_jpeg/gts/face_0000k.jpg: the first 2 of
    exp/datasets/face/gts, BICUBIC to 320 x 288, quality 95, 4:4:4 (gts of
    another size than the face256 model's, which the pair loader crops);
  - exp/datasets/imagenet_jpeg/0000k.jpg: 2 of exp/datasets/imagenet,
    BICUBIC to 500 x 375 (an ImageNet validation size), quality 90, 4:2:0;
  - tests/fixtures/jpeg_pil_decode.npz: PIL's `Image.open(f).convert("RGB")`
    of each file, keyed by its path relative to the repository, each
    stored as the bytes of a PNG (uint8 arrays; about half the size of the
    raw pixels compressed): `decode_png(bytes(npz[key]))` gives the pixels.

PIL runs on the development host only: nothing that runs on the card
imports this script. Re-running it rewrites the same bytes for the same
Pillow (libjpeg-turbo) build.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
DATASETS = REPO / "exp" / "datasets"
ORACLE = REPO / "tests" / "fixtures" / "jpeg_pil_decode.npz"


def _save(img: Image.Image, path: Path, **kw) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    img.save(path, "JPEG", **kw)
    return path


def main() -> None:
    written = []
    for i, src in enumerate(sorted((DATASETS / "celeba_hq").glob("*.png"))):
        extra = {"restart_marker_blocks": 4} if i == 3 else {}
        written.append(_save(Image.open(src).convert("RGB"),
                             DATASETS / "celeba_hq_jpeg" / f"{src.stem}.jpg",
                             quality=90, subsampling=2, **extra))
    for src in sorted((DATASETS / "face" / "gts").glob("*.png"))[:2]:
        img = Image.open(src).convert("RGB").resize((320, 288), Image.BICUBIC)
        written.append(_save(img, DATASETS / "face_jpeg" / "gts" / f"{src.stem}.jpg",
                             quality=95, subsampling=0))
    for src in sorted((DATASETS / "imagenet").glob("*.png"))[:2]:
        img = Image.open(src).convert("RGB").resize((500, 375), Image.BICUBIC)
        written.append(_save(img, DATASETS / "imagenet_jpeg" / f"{src.stem}.jpg",
                             quality=90, subsampling=2))
    oracle = {}
    for p in written:
        buf = io.BytesIO()
        Image.open(p).convert("RGB").save(buf, "PNG", optimize=True)
        oracle[str(p.relative_to(REPO))] = np.frombuffer(buf.getvalue(), np.uint8)
    np.savez(ORACLE, **oracle)
    total = sum(p.stat().st_size for p in written) + ORACLE.stat().st_size
    for p in written:
        print(f"{p.relative_to(REPO)}: {p.stat().st_size} bytes")
    print(f"{ORACLE.relative_to(REPO)}: {ORACLE.stat().st_size} bytes; {total} in all")


if __name__ == "__main__":
    main()
