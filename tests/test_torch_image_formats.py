"""The port's PNG, BMP and PNM readers and its PIL-mode conversions
(ddnm_tpu_torch/data/io.py `decode_image`, `convert`) against PIL.

Files are made from seeded numpy: PNGs by a small writer below for what PIL
cannot write (every color type and bit depth, `tRNS`, Adam7 interlacing)
and by PIL itself (its filters); BMPs by PIL ("1", "L", "P", "RGB",
"RGBA") and by a writer below (4-bit palettes, 16-bit 5-5-5 and 5-6-5,
top-down rows, 32-bit BI_BITFIELDS in a V5 header); PPM / PGM / PBM by PIL
and by hand at other maxvals. Gate: PIL's mode, and `convert` to "RGB",
"L" and "RGBA" byte-equal to PIL's `convert`."""

import io
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from ddnm_tpu_torch.data.io import convert, decode_image, decode_rgb8, has_alpha, read_rgb8

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _pack(row: np.ndarray, depth: int) -> bytes:
    if depth == 16:
        return row.astype(">u2").tobytes()
    if depth == 8:
        return row.astype(np.uint8).tobytes()
    per = 8 // depth
    r = np.concatenate([row, np.zeros((-len(row)) % per, row.dtype)]).astype(np.uint8)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (r.reshape(-1, per) << shifts).sum(axis=1).astype(np.uint8).tobytes()


def _png(arr, color, depth, plte=None, trns=None, interlace=0) -> bytes:
    """A PNG of `arr` (H, W[, C]) samples, filter type 0."""
    h, w = arr.shape[:2]
    a = arr.reshape(h, w, -1)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = a[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\0" + _pack(r.reshape(-1), depth) for r in sub)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                             0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _check(data: bytes) -> str:
    """PIL's mode and PIL's conversions, byte for byte; returns the mode."""
    pil = Image.open(io.BytesIO(data))
    arr, mode = decode_image(data)
    assert mode == pil.mode
    assert has_alpha(mode) == ("A" in pil.getbands())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # PIL: palette transparency as bytes
        for target in ("RGB", "L", "RGBA"):
            ref = np.asarray(pil.convert(target))
            ours = convert(arr, mode, target)
            assert ours.shape == ref.shape and ours.dtype == np.uint8, target
            assert np.array_equal(ours, ref), target
    return mode


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("trns", [False, True], ids=["", "trns"])
def test_png_gray(depth, trns, interlace):
    """PIL opens 1-bit gray as "1", 2- and 4-bit scaled to "L", 16-bit as
    "I;16" (its conversions clip at 255); a tRNS gray is transparent only
    in convert("RGBA")."""
    rng = np.random.default_rng(depth)
    g = rng.integers(0, 1 << depth, (13, 11)).astype(np.uint16 if depth == 16 else np.uint8)
    g[0, :3] = [0, 1, 255 % (1 << depth)]
    t = struct.pack(">H", int(g[1, 1])) if trns else None
    want = {1: "1", 16: "I;16"}.get(depth, "L")
    assert _check(_png(g, 0, depth, trns=t, interlace=interlace)) == want


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True], ids=["", "trns"])
def test_png_palette(depth, trns, interlace):
    """Mode "P": convert("RGB") drops tRNS, "RGBA" takes it, "L" is the
    palette's luma; an index past PLTE is black."""
    rng = np.random.default_rng(10 + depth)
    n = min(1 << depth, 200)
    plte = rng.integers(0, 256, (n - (depth > 1), 3))
    idx = rng.integers(0, n, (13, 11)).astype(np.uint8)
    t = bytes(rng.integers(0, 256, max(1, n // 2)).astype(np.uint8)) if trns else None
    assert _check(_png(idx, 3, depth, plte=plte, trns=t, interlace=interlace)) == "P"


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("color", [2, 4, 6], ids=["rgb", "gray_alpha", "rgba"])
def test_png_color(color, depth, interlace):
    """16-bit samples keep their high byte; 16-bit gray + alpha opens as
    "RGBA"; a tRNS RGB colour is compared on its low bytes, as PIL does."""
    rng = np.random.default_rng(color * depth)
    ch = {2: 3, 4: 2, 6: 4}[color]
    a = rng.integers(0, 1 << depth, (9, 14, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    mode = _check(_png(a, color, depth, interlace=interlace))
    assert mode == {2: "RGB", 4: "LA" if depth == 8 else "RGBA", 6: "RGBA"}[color]
    if color == 2:
        t = struct.pack(">HHH", *(int(v) for v in a[2, 3]))
        assert _check(_png(a, 2, depth, trns=t, interlace=interlace)) == "RGB"


@pytest.mark.parametrize("width", [1, 2, 3, 9])
def test_png_interlaced_narrow(width):
    """Adam7 passes that are empty at narrow widths."""
    a = np.random.default_rng(width).integers(0, 256, (5, width, 3)).astype(np.uint8)
    _check(_png(a, 2, 8, interlace=1))
    _check(_png(a[:1], 2, 8, interlace=1))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1", "I;16"])
def test_pil_written_png(mode):
    """PIL's own writer (all five filter types with optimize) and its
    transparency keyword."""
    rng = np.random.default_rng(3)
    base = Image.fromarray(rng.integers(0, 256, (37, 29, 3)).astype(np.uint8))
    gray = base.convert("L")
    im = {"RGBA": lambda: Image.merge("RGBA", [*base.split(), gray]),
          "LA": lambda: Image.merge("LA", [gray, gray]),
          "I;16": lambda: Image.fromarray(rng.integers(0, 65536, (37, 29)).astype(np.uint16))
          }.get(mode, lambda: base.convert(mode))()
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=True)
    assert _check(buf.getvalue()) == mode
    if mode in ("L", "RGB", "P", "I;16"):
        buf = io.BytesIO()
        im.save(buf, "PNG", transparency=(1, 2, 3) if mode == "RGB" else 1)
        assert _check(buf.getvalue()) == mode


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pil_written_bmp_and_pnm(mode):
    """PIL's BMP writer (a gray palette reads back as "1" / "L", RGBA as
    32-bit BGRX, alpha dropped) and its PPM / PGM / PBM writer."""
    rng = np.random.default_rng(4)
    im = Image.fromarray(rng.integers(0, 256, (23, 31, 4)).astype(np.uint8), "RGBA")
    im = im if mode == "RGBA" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "BMP")
    assert _check(buf.getvalue()) == ("RGB" if mode == "RGBA" else mode)
    if mode in ("1", "L", "RGB"):
        buf = io.BytesIO()
        im.save(buf, "PPM")
        assert _check(buf.getvalue()) == mode


@pytest.mark.parametrize("maxval", [1, 15, 100, 254, 255, 256, 1000, 65535])
@pytest.mark.parametrize("magic", [b"P5", b"P6"])
def test_pnm_maxvals(magic, maxval):
    """PIL scales by round(v / maxval * 255), or to 65535 for a PGM above
    maxval 255 (mode "I"); comments in the header are skipped."""
    bands = 3 if magic == b"P6" else 1
    v = np.random.default_rng(maxval).integers(0, maxval + 1, (6, 7, bands))
    v[0, 0] = maxval
    body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    mode = _check(magic + b"\n# a comment\n7 6\n%d\n" % maxval + body)
    assert mode == ("RGB" if bands == 3 else "I" if maxval > 255 else "L")


def _bmp(bits, width, height, rows, palette=None, topdown=False, compression=0, masks=None,
         v5=False) -> bytes:
    stride = ((width * bits + 31) >> 3) & ~3
    data = b"".join(r.ljust(stride, b"\0") for r in rows)
    pal = b"" if palette is None else b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    size = 124 if v5 else 40
    hdr = struct.pack("<IiiHHIIiiII", size, width, -height if topdown else height, 1, bits,
                      compression, len(data), 2835, 2835, 0 if palette is None else len(palette),
                      0)
    extra = b""
    if v5:
        hdr += struct.pack("<4I", *masks) + bytes(size - 56)
    elif masks is not None:
        extra = struct.pack("<3I", *masks[:3])
    off = 14 + len(hdr) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + hdr + extra + pal + data


@pytest.mark.parametrize("topdown", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palettes(bits, topdown):
    rng = np.random.default_rng(bits)
    n = 1 << bits
    pal = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(n)]
    idx = rng.integers(0, n, (5, 13))
    rows = [_pack(r, bits) for r in idx]
    assert _check(_bmp(bits, 13, 5, rows, pal, topdown)) == "P"
    if bits == 8:  # the identity gray palette reads as "L"
        assert _check(_bmp(8, 13, 5, rows, [(i, i, i) for i in range(256)], topdown)) == "L"


@pytest.mark.parametrize("layout", [
    (16, 0, None), (16, 3, (0xF800, 0x7E0, 0x1F)), (24, 0, None), (32, 0, None),
    (32, 3, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)), (32, 3, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    (32, 3, (0xFF000000, 0xFF0000, 0xFF00, 0x0)), (32, 3, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
], ids=["555", "565", "bgr", "bgrx", "bgra_v5", "rgba_v5", "xbgr_v5", "bgar_v5"])
def test_bmp_true_colour(layout):
    bits, compression, masks = layout
    rng = np.random.default_rng(bits)
    px = rng.integers(0, 256, (5, 13, bits // 8)).astype(np.uint8)
    data = _bmp(bits, 13, 5, [r.tobytes() for r in px], compression=compression, masks=masks,
                v5=bits == 32 and compression == 3)
    assert _check(data) == ("RGBA" if masks and len(masks) == 4 and masks[3] else "RGB")


def test_refusals_name_the_format():
    rgb = np.random.default_rng(5).integers(0, 256, (9, 7, 3)).astype(np.uint8)
    for fmt, word in (("TIFF", "TIFF"), ("GIF", "GIF")):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, fmt)
        with pytest.raises(ValueError, match=f"x: {word} images are not supported"):
            decode_rgb8(buf.getvalue(), "x")
    rle = bytearray(_bmp(8, 2, 1, [b"\0\0"], [(0, 0, 0), (9, 9, 9)]))
    rle[30:34] = struct.pack("<I", 1)  # BI_RLE8
    with pytest.raises(ValueError, match="RLE-compressed BMP"):
        decode_rgb8(bytes(rle), "r.bmp")
    with pytest.raises(ValueError, match="plain-text PPM"):
        decode_rgb8(b"P3\n1 1\n255\n0 0 0\n", "p.ppm")
    with pytest.raises(ValueError, match="CRC"):
        decode_rgb8(_png(rgb, 2, 8)[:-5] + b"XXXXX", "c.png")


def test_read_rgb8_reads_every_format(tmp_path):
    """read_rgb8 (the folder datasets, load_image, load_mask) takes each
    format by its bytes, whatever the suffix."""
    rgb = np.random.default_rng(6).integers(0, 256, (17, 19, 3)).astype(np.uint8)
    for fmt, kw in (("PNG", {}), ("BMP", {}), ("PPM", {}), ("WEBP", {"lossless": True})):
        path = tmp_path / f"{fmt}.img"
        Image.fromarray(rgb).save(path, fmt, **kw)
        assert np.array_equal(read_rgb8(path), rgb), fmt


def test_committed_format_fixtures_match_pil_decode():
    """Every committed fixture (tools/make_torch_format_fixtures.py) against
    PIL's decode and mode stored beside it, and against PIL here."""
    import hashlib
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    oracle = np.load(repo / "tests" / "fixtures" / "formats_pil_decode.npz")
    keys = sorted({k.split("|")[0] for k in oracle.files})
    assert len(keys) == 27
    for key in keys:
        data = (repo / key).read_bytes()
        arr, mode = decode_image(data, key)
        assert mode == bytes(oracle[f"{key}|mode"]).decode() == Image.open(repo / key).mode
        ours = convert(arr, mode, "RGBA" if has_alpha(mode) else "RGB")
        if f"{key}|sha256" in oracle.files:
            assert hashlib.sha256(ours.tobytes()).digest() == bytes(oracle[f"{key}|sha256"]), key
        else:
            stored = np.asarray(Image.open(io.BytesIO(bytes(oracle[f"{key}|png"]))))
            assert stored.shape == ours.shape, key
            assert np.abs(ours.astype(int) - stored).max() <= (1 if key.endswith(".jpg") else 0)
        _check(data)


def test_mixed_folder_matches_jax_folder_dataset():
    """The main path's mixed-format input (exp/datasets/celeba_hq_mixed)
    through the port's FolderDataset against the JAX package's (PIL)."""
    from pathlib import Path

    from ddnm_tpu.data.datasets import FolderDataset as JFolderDataset
    from ddnm_tpu_torch.data.datasets import FolderDataset

    root = Path(__file__).resolve().parents[1] / "exp" / "datasets" / "celeba_hq_mixed"
    ours, ref = FolderDataset(root, 256), JFolderDataset(root, 256)
    assert ours.paths == ref.paths and len(ours) == 8
    for i in range(8):
        a, b = ours[i][0], ref[i][0]
        assert a.shape == b.shape == (256, 256, 3)
        assert np.abs(a - b).max() <= 1 / 255 + 1e-6


@pytest.mark.parametrize("fmt", ["PNG", "WEBP", "JPEG", "BMP"])
def test_decompression_bombs_refused_as_pil_does(fmt):
    """A header claiming more pixels than PIL opens (its
    DecompressionBombError) raises before anything is allocated; a PNG
    stream inflating past its header's image is cut at the image."""
    rgb = np.zeros((8, 8, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, fmt, **({"lossless": True} if fmt == "WEBP" else {}))
    data = bytearray(buf.getvalue())
    if fmt == "PNG":
        ihdr = struct.pack(">II", 20000, 20000) + bytes(data[24:29])
        data[16:29] = ihdr
        data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
    elif fmt == "WEBP":
        hdr = (16000 - 1) | ((16000 - 1) << 14) | (int.from_bytes(data[21:25], "little")
                                                   & ~((1 << 28) - 1))
        data[21:25] = hdr.to_bytes(4, "little")
    elif fmt == "JPEG":
        sof = data.index(b"\xff\xc0")
        data[sof + 5:sof + 9] = struct.pack(">HH", 60000, 60000)
    else:
        data[18:26] = struct.pack("<ii", 20000, 20000)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(bytes(data))).load()
    with pytest.raises(ValueError):
        decode_image(bytes(data), "bomb")
    bomb = _png(np.zeros((4, 4), np.uint8), 0, 8)
    at = bomb.index(b"IDAT") - 4
    big = zlib.compress(bytes(10 ** 7))
    bomb = bomb[:at] + _chunk(b"IDAT", big) + _chunk(b"IEND", b"")
    assert np.array_equal(decode_image(bomb)[0], np.zeros((4, 4), np.uint8))
