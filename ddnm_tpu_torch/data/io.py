"""Image IO: reads of every format the JAX package reads through PIL, as
(uint8 array, PIL mode) with PIL's conversions to RGB, RGBA and L; PNG
writes; float32 (H, W, 3) images in [0, 1] (port of ddnm_tpu/data/io.py).

The machine that runs the port has no imaging package, so the decoders
are the port's own, told apart by their magic bytes, not by the file's
suffix:

  - PNG (here, zlib + numpy): gray, gray+alpha, RGB, RGBA and palette at
    every bit depth the format allows (1, 2, 4, 8, 16), `PLTE` and `tRNS`,
    filter types 0-4, Adam7 interlacing;
  - JPEG (data/jpeg.py): baseline, extended and progressive Huffman, gray,
    YCbCr, RGB, CMYK and YCCK;
  - WebP (data/webp.py): lossy, lossless, alpha;
  - BMP (here): uncompressed 1, 4, 8, 16, 24 and 32 bit, palettes,
    BI_BITFIELDS, bottom-up and top-down rows;
  - PPM / PGM / PBM binary (here): P4, P5, P6 with any maxval.

Each decode gives the mode PIL's `Image.open` reports, laid out as PIL's
`np.asarray` would be, except: "1" is 0 / 255; "I" and "I;16" are uint16;
"P" is expanded to its palette's RGBA (alpha from `tRNS`, 255 elsewhere);
and a `tRNS` colour of an "1", "L", "I;16" or "RGB" PNG adds a last plane,
0 where PIL's `convert("RGBA")` makes the pixel transparent, else 255.
`convert(arr, mode, target)` reproduces PIL's `convert` to "RGB", "RGBA"
and "L" from every such mode. RLE-compressed BMP, TIFF, GIF and plain-text
PNM raise ValueError naming the format. Writes quantise as the JAX
package's `save_image` does (x * 255 + 0.5, clamp, truncate) and use PNG
filter type 0.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path

import numpy as np

from ddnm_tpu_torch.data.jpeg import MAX_PIXELS, decode_jpeg, is_jpeg
from ddnm_tpu_torch.data.resize import resize
from ddnm_tpu_torch.data.webp import decode_webp, is_webp

__all__ = ["decode_png", "encode_png", "decode_image", "convert", "has_alpha",
           "decode_rgb8", "read_rgb8", "load_image", "save_image", "load_mask"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# formats the port cannot read, by their leading bytes
_REFUSED = ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"GIF8", "GIF"),
            (b"P1", "plain-text PBM"), (b"P2", "plain-text PGM"), (b"P3", "plain-text PPM"))
_BANDS = {"1": 1, "L": 1, "I": 1, "I;16": 1, "LA": 2, "P": 4, "RGB": 3, "RGBA": 4, "CMYK": 4}


def _unfilter_average(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(bpp):
        cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF


def _unfilter_paeth(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(bpp):
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, start: int, rows: int, stride: int, bpp: int) -> np.ndarray:
    """`rows` filtered scanlines of `stride` bytes at raw[start:] -> (rows,
    stride) uint8."""
    out = np.empty((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(rows):
        at = start + r * (stride + 1)
        ftype = raw[at]
        line = np.frombuffer(raw, np.uint8, stride, at + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each byte of the pixel
            pad = (-stride) % bpp
            cur = np.cumsum(np.pad(line, (0, pad)).reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_unfilter_average if ftype == 3 else _unfilter_paeth)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[r] = cur
        prev = out[r]
    return out


def _samples(rows: np.ndarray, width: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines -> (rows, width, ch) samples (uint16 at depth 16)."""
    if depth == 16:
        return rows[:, :2 * width * ch].copy().view(">u2").astype(np.uint16).reshape(
            len(rows), width, ch)
    if depth == 8:
        return rows[:, :width * ch].reshape(len(rows), width, ch)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(len(rows), -1)[:, :width * ch].reshape(len(rows), width, ch)


def _decode_png(data: bytes) -> tuple:
    """PNG bytes -> (pixels, PIL mode, palette indices of "P" or None)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, plte, trns = 8, None, [], None, None
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or zlib.crc32(ctype + body) != struct.unpack(
                ">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch or truncated")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IEND":
            break
        elif ctype[0] & 0x20 == 0:  # critical chunk we do not know
            raise ValueError(f"unsupported PNG chunk {ctype!r}")
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or interlace > 1:
        raise ValueError(f"bad PNG header: bit depth {depth}, color type {color}, "
                         f"interlace {interlace}")
    if color == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{width} x {height} pixels is more than {MAX_PIXELS} "
                         "(a decompression bomb to PIL)")
    ch = _CHANNELS[color]
    bpp = max(1, depth * ch // 8)
    passes = [(x0, y0, dx, dy, -(-(width - x0) // dx), -(-(height - y0) // dy))
              for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),))]
    expected = sum(ph * (1 + -(-pw * ch * depth // 8)) for *_, pw, ph in passes
                   if pw > 0 and ph > 0)
    try:  # no more than the header's image, whatever the stream holds
        raw = zlib.decompressobj().decompress(b"".join(idat), expected)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    img = np.zeros((height, width, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes:
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * ch * depth // 8)
        if len(raw) < at + ph * (stride + 1):
            raise ValueError("PNG data shorter than its header says")
        img[y0::dy, x0::dx] = _samples(_unfilter(raw, at, ph, stride, bpp), pw, ch, depth)
        at += ph * (stride + 1)
    return _png_mode(img, color, depth, plte, trns)


def _png_mode(img, color, depth, plte, trns) -> tuple:
    """Samples -> (pixels, PIL's mode, the palette indices of "P" or None),
    in PngImagePlugin's modes, a `tRNS` colour as the alpha plane PIL's
    convert_transparent gives."""
    if color == 3:
        n = len(plte) // 3
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:n, :3] = np.frombuffer(plte, np.uint8, 3 * n).reshape(n, 3)
        if trns:
            pal[:min(len(trns), 256), 3] = np.frombuffer(trns, np.uint8)[:256]
        return pal[img[..., 0]], "P", img[..., 0]
    if depth == 16 and color != 0:
        img = (img >> 8).astype(np.uint8)  # PIL keeps the high byte
        if color == 4:  # 16-bit gray + alpha opens as RGBA
            return np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], axis=-1), "RGBA", None
    if color == 0:
        v = img[..., 0]
        if depth == 1:
            mode, v = "1", (v * 255).astype(np.uint8)
        elif depth == 16:
            mode = "I;16"
        else:
            mode, v = "L", (v * (255 // ((1 << depth) - 1))).astype(np.uint8)
        if trns is not None and len(trns) >= 2:
            t = struct.unpack(">H", trns[:2])[0]
            t = (255 if t else 0) if depth == 1 else t & 0xFF
            alpha = np.where(np.minimum(v, 255) == t, 0, 255).astype(v.dtype)
            return np.stack([v, alpha], axis=-1), mode, None
        return v, mode, None
    mode = {2: "RGB", 4: "LA", 6: "RGBA"}[color]
    if color == 2 and trns is not None and len(trns) >= 6:
        t = np.asarray(struct.unpack(">HHH", trns[:6])) & 0xFF
        alpha = np.where((img == t).all(axis=-1), 0, 255).astype(np.uint8)
        return np.concatenate([img, alpha[..., None]], axis=-1), mode, None
    return img, mode, None


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the pixels as `np.asarray(Image.open(f))` gives them:
    uint8 (H, W) for 8-bit gray, (H, W, 2 | 3 | 4) for gray + alpha, RGB,
    RGBA; palette indices for "P", bool for "1", uint16 for "I;16"."""
    arr, mode, index = _decode_png(data)
    if mode == "P":
        return index
    bands = _BANDS[mode]
    if arr.ndim == 3 and arr.shape[-1] > bands:  # the tRNS plane
        arr = arr[..., 0] if bands == 1 else arr[..., :bands]
    return arr > 0 if mode == "1" else arr


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W) gray or (H, W, 3|4) RGB(A) -> PNG bytes (filter 0)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[-1] in (1, 2, 3, 4):
        color = {1: 0, 2: 4, 3: 2, 4: 6}[arr.shape[-1]]
    else:
        raise ValueError(f"encode_png takes (H, W[, C]), got {arr.shape}")
    height, width = arr.shape[:2]
    rows = arr.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def _refuse(raw: bytes, name: str):
    fmt = next((f for magic, f in _REFUSED if raw[:len(magic)] == magic), None)
    if fmt is not None:
        raise ValueError(f"{name}: {fmt} images are not supported (see ROADMAP.md)")
    raise ValueError(f"{name}: not a PNG, JPEG, WebP, BMP or PNM image")


def decode_image(raw: bytes, name: str = "<bytes>") -> tuple[np.ndarray, str]:
    """Image bytes (told apart by their magic bytes) -> (pixels, PIL mode),
    laid out as the module docstring says. `name` labels errors; other
    formats raise ValueError naming the format."""
    if raw[:8] == _SIGNATURE:
        try:
            return _decode_png(raw)[:2]
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    if is_jpeg(raw):
        img = decode_jpeg(raw, name)
        return img, "L" if img.ndim == 2 else ("RGB" if img.shape[-1] == 3 else "CMYK")
    if is_webp(raw):
        return decode_webp(raw, name)
    if raw[:2] == b"BM":
        return _decode_bmp(raw, name)
    if raw[:2] in (b"P4", b"P5", b"P6") and raw[2:3].isspace():
        return _decode_pnm(raw, name)
    _refuse(raw, name)


def has_alpha(mode: str) -> bool:
    """PIL's `"A" in img.getbands()`."""
    return mode in ("LA", "RGBA")


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's ITU-R 601-2 integer luma (convert("L")):
    (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb (Convert.c): nk - MULDIV255(c, nk) per channel,
    nk = 255 - k."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def convert(arr: np.ndarray, mode: str, target: str) -> np.ndarray:
    """PIL's `convert(target)` of an image decoded as (arr, mode) ->
    uint8 (H, W, 3) for "RGB", (H, W, 4) for "RGBA", (H, W) for "L"."""
    if mode not in _BANDS or target not in ("RGB", "RGBA", "L"):
        raise ValueError(f"no conversion from {mode!r} to {target!r}")
    a = arr[..., None] if arr.ndim == 2 else arr
    alpha = None
    if mode in ("1", "L", "I", "I;16", "LA"):
        gray = np.minimum(a[..., 0], 255).astype(np.uint8)
        if target == "L":
            return gray
        rgb = np.repeat(gray[..., None], 3, axis=-1)
        if a.shape[-1] > 1:
            alpha = a[..., 1].astype(np.uint8)
    else:
        rgb = _cmyk_to_rgb(a) if mode == "CMYK" else a[..., :3]
        if target == "L":
            return _luma(rgb)
        if mode != "CMYK" and a.shape[-1] > 3:
            alpha = a[..., 3]
    if target == "RGB":
        return np.ascontiguousarray(rgb)
    if alpha is None:
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def decode_rgb8(raw: bytes, name: str = "<bytes>") -> np.ndarray:
    """Image bytes -> uint8 (H, W, 3), as PIL's `Image.open(...).convert("RGB")`."""
    return convert(*decode_image(raw, name), "RGB")


def read_rgb8(path: str | Path) -> np.ndarray:
    """Read an image file -> uint8 (H, W, 3); see `decode_rgb8`."""
    path = Path(path)
    return decode_rgb8(path.read_bytes(), path.name)


def load_image(path: str | Path, size: int | None = None) -> np.ndarray:
    """Read an image -> float32 (H, W, 3) in [0, 1]; with `size`, an image of
    another size is resized to size x size with BICUBIC, as the JAX
    package's load_image (data/resize.py reproduces PIL's resampler)."""
    img = read_rgb8(path)
    if size is not None and img.shape[:2] != (size, size):
        img = resize(img, size, size, "bicubic")
    return img.astype(np.float32) / 255.0


def save_image(img, path: str | Path) -> None:
    """Write a float (H, W, C) or (H, W) image in [0, 1] as PNG.

    Quantisation matches torchvision save_image: (img*255 + 0.5) truncated."""
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    q = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(q))


def load_mask(path: str | Path) -> np.ndarray:
    """Load an inpainting mask: .npy (0/1) or an image thresholded at 0.5."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    img = load_image(path)
    return (img.mean(axis=-1) > 0.5).astype(np.float32)


# ---------------------------------------------------------------- BMP and PNM

# BI_BITFIELDS layouts PIL reads, by depth and masks (R, G, B[, A])
_BMP_MASKS = {
    32: ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)),
    24: ((0xFF0000, 0xFF00, 0xFF),),
    16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)),
}


def _decode_bmp(raw: bytes, name: str) -> tuple[np.ndarray, str]:
    """Uncompressed BMP as PIL's BmpImagePlugin reads it: a gray palette
    0..n-1 (or black / white of 2) makes mode "L" ("1"), other palettes
    "P"; 16 / 24 / 32 bit make "RGB", or "RGBA" under an alpha bitfield."""
    def bad(msg):
        raise ValueError(f"{name}: {msg}")

    if len(raw) < 26:
        bad("truncated BMP file")
    (offset,) = struct.unpack_from("<I", raw, 10)
    (hsize,) = struct.unpack_from("<I", raw, 14)
    hdr = raw[18:14 + hsize]
    pos = 14 + hsize
    masks = None
    if hsize == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", hdr)
        compression, colors, pad, flip = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        if len(hdr) < 36:
            bad("truncated BMP header")
        width, h, _, bits, compression = struct.unpack_from("<iIHHI", hdr)
        flip = hdr[7] == 0xFF
        height = 2 ** 32 - h if flip else h
        (colors,) = struct.unpack_from("<I", hdr, 28)
        pad = 4
        if compression == 3:
            if len(hdr) >= 48:
                masks = struct.unpack_from("<4I" if len(hdr) >= 52 else "<3I", hdr, 36)
                masks = masks + (0,) * (4 - len(masks))
            else:
                masks = struct.unpack_from("<3I", raw, pos) + (0,)
                pos += 12
    else:
        bad(f"unsupported BMP header size {hsize}")
    if compression in (1, 2):
        bad("RLE-compressed BMP images are not supported (see ROADMAP.md)")
    if compression not in (0, 3):
        bad(f"unsupported BMP compression {compression}")
    if bits not in (1, 4, 8, 16, 24, 32):
        bad(f"unsupported BMP pixel depth {bits}")
    if width <= 0 or height <= 0 or width * height > MAX_PIXELS:
        bad(f"bad BMP size {width} x {height}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    stride = ((width * bits + 31) >> 3) & ~3
    mode, layout = "RGB", None
    if compression == 3:
        key = masks if bits == 32 else masks[:3]
        if key not in _BMP_MASKS.get(bits, ()):
            bad("unsupported BMP bitfields layout")
        if bits == 16:
            layout = "565" if masks[0] == 0xF800 else "555"
        elif not any(key):  # PIL reads all-zero masks as BGRA
            layout, mode = (2, 1, 0, 3), "RGBA"
        else:  # the byte each channel's mask covers
            layout = tuple(((m & -m).bit_length() - 1) // 8 if m else None for m in key)
            layout += (None,) * (4 - len(layout))
            mode = "RGBA" if layout[3] is not None else "RGB"
    pal = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            bad(f"unsupported BMP palette size {colors}")
        praw = raw[pos:pos + pad * colors]
        if len(praw) < pad * colors:
            bad("truncated BMP palette")
        pal = np.frombuffer(praw, np.uint8).reshape(colors, pad)[:, 2::-1]  # BGR(X) -> RGB
        gray_of = np.array([0, 255]) if colors == 2 else np.arange(colors)
        if np.array_equal(pal.astype(np.int64), np.repeat(gray_of[:, None], 3, 1)):
            mode = "1" if colors == 2 else "L"
        else:
            mode = "P"
    # the rows as stored (bottom-up unless the height was negative); an
    # "L" image reads as 8 bits a pixel whatever its depth, as PIL's raw "L"
    row_len = width if mode == "L" else stride
    if len(raw) < offset + stride * (height - 1) + row_len:
        bad("truncated BMP pixel data")
    rows = np.stack([np.frombuffer(raw, np.uint8, row_len, offset + r * stride)
                     for r in range(height)])
    if mode == "L":
        out = rows[:, :width]
    elif mode == "1":  # PIL's raw "1": one bit a pixel whatever the depth
        out = (_samples(rows, width, 1, 1)[..., 0] * 255).astype(np.uint8)
    elif bits < 8:
        out = _samples(rows, width, 1, bits)[..., 0]
    elif bits == 8:
        out = rows[:, :width]
    elif bits == 16:
        v = rows[:, :2 * width].copy().view("<u2").astype(np.int64)
        if layout == "565":
            out = np.stack([(v >> 11) & 31, (v >> 5) & 63, v & 31], -1)
            out = out * 255 // np.array([31, 63, 31])
        else:
            out = np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], -1) * 255 // 31
        out = out.astype(np.uint8)
    else:
        px = rows[:, :width * bits // 8].reshape(height, width, bits // 8)
        r, g, b, a = layout if layout is not None else (2, 1, 0, None)
        out = px[..., [r, g, b] if a is None else [r, g, b, a]]
    if mode == "P":
        rgba = np.zeros((256, 4), np.uint8)
        rgba[:, 3] = 255
        n = min(len(pal), 256)
        rgba[:n, :3] = pal[:n]
        out = rgba[out]
    if not flip:
        out = out[::-1]
    return np.ascontiguousarray(out), mode


_PNM_TOKEN = re.compile(rb"(?:\s|#[^\r\n]*[\r\n]?)*(\S+)")


def _decode_pnm(raw: bytes, name: str) -> tuple[np.ndarray, str]:
    """Binary PBM / PGM / PPM as PIL's PpmImagePlugin reads them: P4 is
    "1"; P5 is "L" (maxval 255, else scaled by round(v / maxval * 255)) or,
    above maxval 255, "I" (scaled to 65535); P6 is "RGB", scaled likewise
    to 255."""
    magic = raw[:2]
    pos = 2
    tokens = []
    for _ in range(2 if magic == b"P4" else 3):
        m = _PNM_TOKEN.match(raw, pos)
        if m is None or not m.group(1).isdigit():
            raise ValueError(f"{name}: bad PNM header")
        tokens.append(int(m.group(1)))
        pos = m.end() + 1  # the single whitespace after the last token
    width, height = tokens[:2]
    if width <= 0 or height <= 0 or width * height > MAX_PIXELS:
        raise ValueError(f"{name}: bad PNM size {width} x {height}")
    if magic == b"P4":
        stride = (width + 7) // 8
        if len(raw) < pos + stride * height:
            raise ValueError(f"{name}: truncated PNM data")
        rows = np.frombuffer(raw, np.uint8, stride * height, pos).reshape(height, stride)
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return ((1 - bits) * 255).astype(np.uint8), "1"
    maxval = tokens[2]
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: PNM maxval must be in [1, 65535], got {maxval}")
    bands = 3 if magic == b"P6" else 1
    size = 2 if maxval > 255 else 1
    n = width * height * bands
    if len(raw) < pos + n * size:
        raise ValueError(f"{name}: truncated PNM data")
    v = np.frombuffer(raw, ">u2" if size == 2 else np.uint8, n, pos).reshape(height, width, bands)
    mode = "I" if (bands == 1 and maxval > 255) else ("L" if bands == 1 else "RGB")
    out_max = 65535 if mode == "I" else 255
    if maxval != out_max:
        v = np.minimum(out_max, np.round(v / maxval * out_max))
    v = v.astype(np.uint16 if mode == "I" else np.uint8)
    return (v[..., 0] if bands == 1 else v), mode
