#!/usr/bin/env python3
"""Write the image-format fixtures of the port's data layer (WebP,
progressive / CMYK JPEG, palette / 16-bit / low-bit / interlaced PNG, PPM,
PGM, BMP) with PIL, and PIL's own decode of each as the oracle the port's
numpy decoders are held to.

    python tools/make_torch_format_fixtures.py

Writes (under 1 MiB in all):
  - exp/datasets/formats/*: one small file (48 x 40) of each kind, made
    from celeba_hq/00000.png (and, for the alpha files, a keep mask of
    exp/datasets/face/gt_keep_masks);
  - exp/datasets/celeba_hq_mixed/0000k.*: the 8 images of
    exp/datasets/celeba_hq as 2 lossy WebP (quality 80, 90), 1 lossless
    WebP, 2 progressive JPEG (4:2:0, 4:4:4), 1 CMYK JPEG, 1 palette PNG (256
    colours) and 1 BMP (8-bit palette): the main path's input in formats
    other than PNG and baseline JPEG;
  - tests/fixtures/formats_pil_decode.npz: per file (keyed by its path
    relative to the repository) PIL's mode (`<key>|mode`), and either PIL's
    `convert("RGBA")` (files with an alpha band) or `convert("RGB")` as the
    bytes of a PNG (`<key>|png`), or, for the 256 px files held byte-equal
    (WebP, PNG, BMP), the SHA-256 of those pixels and their shape
    (`<key>|sha256`, `<key>|shape`), which keeps the oracle small. JPEG
    files, held within a level, always store their pixels.

PIL runs on the development host only: nothing that runs on the card
imports this script. Re-running it rewrites the same bytes for the same
Pillow (libwebp, libjpeg-turbo) build.
"""

from __future__ import annotations

import hashlib
import io
import struct
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
DATASETS = REPO / "exp" / "datasets"
SMALL = DATASETS / "formats"
MIXED = DATASETS / "celeba_hq_mixed"
ORACLE = REPO / "tests" / "fixtures" / "formats_pil_decode.npz"
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _png(samples: np.ndarray, color: int, depth: int, plte=None, trns=None,
         interlace: int = 0) -> bytes:
    """PNG bytes PIL cannot write (16-bit RGB, 2-bit gray, Adam7): filter 0."""
    h, w = samples.shape[:2]
    a = samples.reshape(h, w, -1)

    def pack(row):
        if depth == 16:
            return row.astype(">u2").tobytes()
        if depth == 8:
            return row.astype(np.uint8).tobytes()
        per = 8 // depth
        r = np.concatenate([row, np.zeros((-len(row)) % per, row.dtype)]).astype(np.uint8)
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        return (r.reshape(-1, per) << shifts).sum(axis=1).astype(np.uint8).tobytes()

    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = a[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\0" + pack(r.reshape(-1)) for r in sub)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                                             0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")


def _encode(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def small_files() -> dict:
    """name -> bytes of the small fixtures, one of each kind."""
    rgb = Image.open(DATASETS / "celeba_hq" / "00000.png").convert("RGB").resize(
        (48, 40), Image.BICUBIC)
    mask = Image.open(sorted((DATASETS / "face" / "gt_keep_masks").glob("*.png"))[0]).convert(
        "L").resize((48, 40), Image.NEAREST)
    rgba = rgb.copy()
    rgba.putalpha(mask)
    arr = np.asarray(rgb)
    gray = np.asarray(rgb.convert("L"))
    pal = rgb.quantize(32)
    return {
        "webp_lossy_q50.webp": _encode(rgb, "WEBP", quality=50),
        "webp_lossy_q95.webp": _encode(rgb, "WEBP", quality=95, method=6),
        "webp_lossless.webp": _encode(rgb, "WEBP", lossless=True),
        "webp_alpha.webp": _encode(rgba, "WEBP", quality=80, alpha_quality=90),
        "webp_lossless_alpha.webp": _encode(rgba, "WEBP", lossless=True),
        "jpeg_progressive_420.jpg": _encode(rgb, "JPEG", quality=85, progressive=True),
        "jpeg_progressive_gray.jpg": _encode(rgb.convert("L"), "JPEG", quality=85,
                                             progressive=True),
        "jpeg_cmyk.jpg": _encode(rgb.convert("CMYK"), "JPEG", quality=90),
        "jpeg_cmyk_progressive.jpg": _encode(rgb.convert("CMYK"), "JPEG", quality=90,
                                             progressive=True),
        "png_palette_trns.png": _encode(pal, "PNG", transparency=bytes(range(0, 256, 8))),
        "png_gray16.png": _png((gray.astype(np.uint16) * 3), 0, 16),
        "png_rgb16_adam7.png": _png(arr.astype(np.uint16) * 257, 2, 16, interlace=1),
        "png_gray2.png": _png(gray >> 6, 0, 2),
        "png_rgba_adam7.png": _png(np.asarray(rgba), 6, 8, interlace=1),
        "ppm_p6.ppm": _encode(rgb, "PPM"),
        "pgm_16.pgm": b"P5\n48 40\n65535\n" + (gray.astype(">u2") * 200).tobytes(),
        "bmp_8bit_palette.bmp": _encode(pal.convert("RGB").quantize(64), "BMP"),
        "bmp_24.bmp": _encode(rgb, "BMP"),
        "bmp_1bit.bmp": _encode(rgb.convert("1"), "BMP"),
    }


def mixed_files() -> dict:
    """name -> bytes of celeba_hq's 8 images in other formats."""
    srcs = sorted((DATASETS / "celeba_hq").glob("*.png"))
    ims = [Image.open(p).convert("RGB") for p in srcs]
    kinds = [("webp", dict(quality=80)), ("webp", dict(quality=90)),
             ("webp", dict(lossless=True)), ("jpg", dict(quality=90, progressive=True)),
             ("jpg", dict(quality=90, progressive=True, subsampling=0)), ("cmyk", {}),
             ("png", {}), ("bmp", {})]
    out = {}
    for src, im, (kind, kw) in zip(srcs, ims, kinds):
        if kind == "webp":
            out[f"{src.stem}.webp"] = _encode(im, "WEBP", **kw)
        elif kind == "jpg":
            out[f"{src.stem}.jpg"] = _encode(im, "JPEG", **kw)
        elif kind == "cmyk":
            out[f"{src.stem}.jpg"] = _encode(im.convert("CMYK"), "JPEG", quality=90)
        elif kind == "png":
            out[f"{src.stem}.png"] = _encode(im.quantize(256), "PNG", optimize=True)
        else:
            out[f"{src.stem}.bmp"] = _encode(im.quantize(256), "BMP")
    return out


def main() -> None:
    oracle = {}
    written = []
    for folder, files in ((SMALL, small_files()), (MIXED, mixed_files())):
        folder.mkdir(parents=True, exist_ok=True)
        for name, data in files.items():
            path = folder / name
            path.write_bytes(data)
            written.append(path)
            key = str(path.relative_to(REPO))
            pil = Image.open(path)
            pixels = np.asarray(pil.convert("RGBA" if "A" in pil.getbands() else "RGB"))
            oracle[f"{key}|mode"] = np.frombuffer(pil.mode.encode(), np.uint8)
            if folder == MIXED and not name.endswith(".jpg"):
                oracle[f"{key}|sha256"] = np.frombuffer(
                    hashlib.sha256(pixels.tobytes()).digest(), np.uint8)
                oracle[f"{key}|shape"] = np.asarray(pixels.shape, np.int64)
            else:
                oracle[f"{key}|png"] = np.frombuffer(
                    _encode(Image.fromarray(pixels), "PNG", optimize=True), np.uint8)
    np.savez_compressed(ORACLE, **oracle)
    total = sum(p.stat().st_size for p in written) + ORACLE.stat().st_size
    for p in written:
        print(f"{p.relative_to(REPO)}: {p.stat().st_size} bytes")
    print(f"{ORACLE.relative_to(REPO)}: {ORACLE.stat().st_size} bytes; {total} in all")


if __name__ == "__main__":
    main()
