"""Image IO: PNG read and write in the standard library (zlib + struct),
float32 (H, W, 3) images in [0, 1] (port of ddnm_tpu/data/io.py).

The machine that runs the port has no imaging package, so this module
holds a small PNG codec: 8-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, filter types 0-4. Anything else raises. Writes quantise as
the JAX package's `save_image` does (x * 255 + 0.5, clamp, truncate) and
use filter type 0.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["decode_png", "encode_png", "load_image", "save_image", "load_mask"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG color type -> samples per pixel


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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array (H, W) for gray, else (H, W, channels)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif ctype[0] & 0x20 == 0:  # critical chunk we do not know (e.g. PLTE)
            raise ValueError(f"unsupported PNG chunk {ctype!r}")
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {color}, "
                         f"interlace {interlace} (8-bit, non-interlaced only)")
    ch = _CHANNELS[color]
    stride = width * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG data length does not match its header")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        start = r * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(width, ch), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_unfilter_average if ftype == 3 else _unfilter_paeth)(buf, prev.tobytes(), ch)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[r] = cur
        prev = out[r]
    return out.reshape(height, width) if ch == 1 else out.reshape(height, width, ch)


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


def load_image(path: str | Path, size: int | None = None) -> np.ndarray:
    """Read a PNG -> float32 (H, W, 3) in [0, 1] (gray replicated, alpha
    dropped). Resizing is not ported: a `size` that differs raises."""
    path = Path(path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"only PNG images are supported, got {path.name}")
    img = decode_png(path.read_bytes())
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    elif img.shape[-1] == 2:  # gray + alpha
        img = np.repeat(img[:, :, :1], 3, axis=2)
    else:
        img = img[:, :, :3]
    if size is not None and img.shape[:2] != (size, size):
        raise ValueError(f"{path.name} is {img.shape[1]}x{img.shape[0]}, expected "
                         f"{size}x{size}; resizing is not ported")
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
    """Load an inpainting mask: .npy (0/1) or a PNG thresholded at 0.5."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    img = load_image(path)
    return (img.mean(axis=-1) > 0.5).astype(np.float32)
