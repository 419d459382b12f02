"""The port's numpy JPEG decoder (ddnm_tpu_torch/data/jpeg.py) against PIL,
through the JAX package's `load_image` (PIL's `convert("RGB")`).

JPEGs are written by PIL from seeded numpy images (a gradient plus noise)
at the sizes, subsamplings, qualities and options the decoder claims, and
by a small baseline encoder below for what PIL's writer cannot make (4:4:0,
one scan per component, a gray plane declared 2 x 2). Gate: every pixel
within 1 uint8 level of PIL's decode; each case records the share of
pixels that are equal (the decoder follows libjpeg-turbo's integer IDCT,
fancy upsampling and colour tables, so it is 1.0 on this host's Pillow).
Progressive files (PIL's scan script, restart markers) and 4-component
files (PIL's CMYK, and YCCK from the encoder below) are held to the same
gate, CMYK before and after PIL's conversion to RGB; a progressive file
whose scans stop before the low coefficients are exact, which libjpeg
smooths, is refused, and the test shows that the unsmoothed decode would
not be PIL's. A PNG named .jpg still decodes (the reader looks at the
bytes)."""

import io
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ddnm_tpu.data.io import load_image as j_load_image
from ddnm_tpu_torch.data import io as tio
from ddnm_tpu_torch.data.jpeg import decode_jpeg

REPO = Path(__file__).resolve().parents[1]
SIZES = [(8, 8), (37, 53), (64, 64), (131, 97)]  # (width, height)
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
_EXIF = Image.Exif()
_EXIF[0x0112] = 6  # orientation: rotate 90 degrees, which neither PIL nor the port applies
_ROTATED = _EXIF.tobytes()


def _image(width: int, height: int, seed: int) -> np.ndarray:
    """uint8 (height, width, 3): per-channel gradients plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    base = np.stack([xx * 255 / max(width - 1, 1), yy * 255 / max(height - 1, 1),
                     (xx + yy) * 127 / max(width + height - 2, 1)], axis=-1)
    return np.clip(base + rng.normal(0, 40, base.shape), 0, 255).astype(np.uint8)


def _check(path: Path, record_property) -> None:
    """The port's read_rgb8 within 1 level of the JAX package's load_image."""
    ours = tio.read_rgb8(path)
    ref = np.round(j_load_image(path) * 255.0).astype(np.int16)
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(np.int16) - ref)
    equal = float((diff == 0).mean())
    record_property("equal_share", equal)
    print(f"{path.name}: max |diff| {diff.max()}, equal share {equal:.6f}")
    assert diff.max() <= 1


@pytest.mark.parametrize("quality", [25, 75, 100])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_matches_pil(size, sub, quality, tmp_path, record_property):
    path = tmp_path / "x.jpg"
    Image.fromarray(_image(*size, seed=size[0] * quality)).save(
        path, "JPEG", quality=quality, subsampling=SUBSAMPLING[sub])
    _check(path, record_property)


@pytest.mark.parametrize("option", [
    {"optimize": True},
    {"restart_marker_blocks": 3},
    {"restart_marker_rows": 1},
    {"keep_rgb": True},  # an RGB JPEG: Adobe APP14 transform 0
    {"exif": _ROTATED, "comment": b"note",
     "icc_profile": b"\x00" * 70000},  # APP1 (not applied), COM, APP2 over two segments
], ids=["optimize", "rst_blocks", "rst_rows", "adobe_rgb", "app_segments"])
@pytest.mark.parametrize("sub", ["444", "420"])
def test_decode_options_match_pil(option, sub, tmp_path, record_property):
    if option.get("keep_rgb") and sub != "444":
        sub = "444"  # PIL writes RGB JPEGs unsubsampled only
    path = tmp_path / "x.jpg"
    Image.fromarray(_image(131, 97, seed=3)).save(
        path, "JPEG", quality=85, subsampling=SUBSAMPLING[sub], **option)
    if "restart_marker_blocks" in option or "restart_marker_rows" in option:
        assert b"\xff\xdd" in path.read_bytes() and b"\xff\xd0" in path.read_bytes()
    _check(path, record_property)


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (131, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_gray_matches_pil(size, tmp_path, record_property):
    path = tmp_path / "g.jpg"
    Image.fromarray(_image(*size, seed=7)[..., 1]).save(path, "JPEG", quality=80)
    assert tio.decode_rgb8(path.read_bytes()).shape == (size[1], size[0], 3)
    assert decode_jpeg(path.read_bytes()).shape == (size[1], size[0])
    _check(path, record_property)


# ------------------------------------------------- a small baseline encoder
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) * 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])
# one table for everything: all 12 DC categories at 4 bits, all 162 AC
# symbols (EOB, ZRL, run 0-15 x size 1-10) at 8 bits
_DC_SYMS = list(range(12))
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _codes(symbols, length):
    return {s: (i, length) for i, s in enumerate(symbols)}


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        self.acc, self.n = (self.acc << n) | (value & ((1 << n) - 1)), self.n + n
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _size(v: int) -> int:
    return int(abs(v)).bit_length()


def _encode_blocks(bits: _Bits, blocks, pred: int, dc, ac) -> int:
    for blk in blocks:
        zz = blk.reshape(64)[_ZIGZAG]
        diff, pred = int(zz[0]) - pred, int(zz[0])
        s = _size(diff)
        bits.put(*dc[s])
        if s:
            bits.put(diff if diff > 0 else diff - 1, s)
        run = 0
        last = max((k for k in range(1, 64) if zz[k]), default=0)
        for k in range(1, last + 1):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac[0xF0])
                run -= 16
            s = _size(v)
            bits.put(*ac[(run << 4) | s])
            bits.put(v if v > 0 else v - 1, s)
            run = 0
        if last < 63:
            bits.put(*ac[0x00])
    return pred


def _encode(planes, factors, q: int = 6, one_scan: bool = True,
            adobe: int | None = None) -> bytes:
    """Baseline JPEG of full-size uint8 planes (1, 3 or 4; YCbCr, or YCCK
    with `adobe` 2), each component box-downsampled to its (h, v) factors;
    component ids 1..n, no JFIF segment, an Adobe APP14 segment with
    transform `adobe` if given; one interleaved scan or one scan each."""
    height, width = planes[0].shape
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    coefs = []
    for plane, (h, v) in zip(planes, factors):
        fy, fx = vmax // v, hmax // h
        ph, pw = mcuy * v * 8, mcux * h * 8
        p = np.pad(plane.astype(np.float64), ((0, ph * fy - height), (0, pw * fx - width)),
                   mode="edge")
        p = p.reshape(ph, fy, pw, fx).mean(axis=(1, 3)) - 128.0
        blocks = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coefs.append(np.round(_DCT @ blocks @ _DCT.T / q).astype(np.int64))
    dc, ac = _codes(_DC_SYMS, 4), _codes(_AC_SYMS, 8)
    n = len(planes)
    seg = lambda m, body: b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body  # noqa: E731
    out = b"\xff\xd8" + seg(0xDB, bytes([0]) + bytes([q]) * 64)
    if adobe is not None:
        out += seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += seg(0xC0, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([i + 1, (h << 4) | v, 0]) for i, (h, v) in enumerate(factors)))
    for tc, syms, length in ((0, _DC_SYMS, 4), (1, _AC_SYMS, 8)):
        counts = [0] * 16
        counts[length - 1] = len(syms)
        out += seg(0xC4, bytes([tc << 4]) + bytes(counts) + bytes(syms))
    scans = [list(range(n))] if one_scan else [[i] for i in range(n)]
    for comps in scans:
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([i + 1, 0]) for i in comps)
                   + bytes([0, 63, 0]))
        bits, preds = _Bits(), [0] * n
        if len(comps) == 1:  # non-interleaved: the component's own block grid
            i = comps[0]
            h, v = factors[i]
            rows = -(-(-(-height * v // vmax)) // 8)
            cols = -(-(-(-width * h // hmax)) // 8)
            preds[i] = _encode_blocks(bits, coefs[i][:rows, :cols].reshape(-1, 8, 8),
                                      preds[i], dc, ac)
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    for i in comps:
                        h, v = factors[i]
                        blk = coefs[i][my * v:(my + 1) * v, mx * h:(mx + 1) * h]
                        preds[i] = _encode_blocks(bits, blk.reshape(-1, 8, 8), preds[i], dc, ac)
        out += bits.flush()
    return out + b"\xff\xd9"


@pytest.mark.parametrize("case", [
    ("440", [(1, 2), (1, 1), (1, 1)], True),
    ("440_scans", [(1, 2), (1, 1), (1, 1)], False),
    ("420_scans", [(2, 2), (1, 1), (1, 1)], False),
    ("mixed", [(2, 2), (1, 2), (2, 1)], True),
    ("gray_2x2", [(2, 2)], True),
], ids=lambda c: c[0])
@pytest.mark.parametrize("size", [(37, 53), (131, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_hand_encoded_layouts(case, size, tmp_path, record_property):
    """Layouts PIL's writer does not make, written by the encoder above and
    decoded by PIL as the oracle: 4:4:0 (the h1v2 upsampler), one scan per
    component (blocks over each component's own extent), mixed factors and
    a gray plane declared 2 x 2."""
    _, factors, one_scan = case
    rgb = _image(*size, seed=11)
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    planes = [ycc[..., i] for i in range(len(factors))]
    path = tmp_path / "hand.jpg"
    path.write_bytes(_encode(planes, factors, one_scan=one_scan))
    _check(path, record_property)


def test_refuses_progressive_and_cmyk(tmp_path, record_property):
    """Progressive and CMYK files, once refused, decode as PIL's; sampling
    factors above 2 are still refused."""
    rgb = _image(40, 30, seed=1)
    Image.fromarray(rgb).save(tmp_path / "p.jpg", "JPEG", progressive=True)
    _check(tmp_path / "p.jpg", record_property)
    Image.fromarray(rgb).convert("CMYK").save(tmp_path / "c.jpg", "JPEG")
    _check(tmp_path / "c.jpg", record_property)
    with pytest.raises(ValueError, match="sampling factor 4x1"):
        decode_jpeg(_encode([rgb[..., 0]] * 3, [(4, 1), (1, 1), (1, 1)]))


@pytest.mark.parametrize("quality", [25, 90])
@pytest.mark.parametrize("sub", ["444", "422", "420"])
@pytest.mark.parametrize("size", [(37, 53), (131, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_matches_pil(size, sub, quality, tmp_path, record_property):
    """PIL's progressive scan script: DC first and refinement, AC spectral
    bands, AC refinement with EOB runs and correction bits."""
    path = tmp_path / "p.jpg"
    Image.fromarray(_image(*size, seed=quality + size[0])).save(
        path, "JPEG", quality=quality, subsampling=SUBSAMPLING[sub], progressive=True)
    assert b"\xff\xc2" in path.read_bytes()
    _check(path, record_property)


@pytest.mark.parametrize("option", ["restart", "gray", "optimize"])
def test_progressive_options_match_pil(option, tmp_path, record_property):
    path = tmp_path / "p.jpg"
    img = _image(131, 97, seed=4)
    kw = {"restart": {"restart_marker_blocks": 3}, "optimize": {"optimize": True}}.get(option, {})
    Image.fromarray(img[..., 0] if option == "gray" else img).save(
        path, "JPEG", quality=80, progressive=True, **kw)
    _check(path, record_property)


def _scans_cut(data: bytes, keep: int) -> bytes:
    """A JPEG with only its first `keep` scans (and EOI)."""
    pos, seen = 2, 0
    while True:
        marker, (length,) = data[pos + 1], struct.unpack_from(">H", data, pos + 2)
        if marker == 0xDA:
            seen += 1
            if seen > keep:
                return data[:pos] + b"\xff\xd9"
            end = pos + 2 + length
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
            pos = end
        else:
            pos += 2 + length


def test_progressive_scans_stopping_early(tmp_path, monkeypatch):
    """A file whose scans stop before the low AC coefficients are exact is
    refused: libjpeg-turbo smooths its blocks (jdcoefct.c), and the decode
    without smoothing is more than a level from PIL's."""
    from ddnm_tpu_torch.data import jpeg

    buf = io.BytesIO()
    Image.fromarray(_image(64, 48, seed=9)).save(buf, "JPEG", quality=85, progressive=True)
    cut = _scans_cut(buf.getvalue(), 3)
    pil = np.asarray(Image.open(io.BytesIO(cut)).convert("RGB")).astype(int)
    with pytest.raises(ValueError, match="x.jpg: progressive with unrefined low coefficients"):
        decode_jpeg(cut, "x.jpg")
    monkeypatch.setattr(jpeg, "_SMOOTHED", 1)  # skip the check: decode without smoothing
    assert np.abs(tio.decode_rgb8(cut).astype(int) - pil).max() > 1


@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_matches_pil(progressive, tmp_path, record_property):
    """PIL's CMYK JPEG (Adobe, inverted): the four planes within a level of
    PIL's, then Pillow's cmyk2rgb to RGB and L."""
    cmyk = np.random.default_rng(12).integers(0, 256, (53, 37, 4)).astype(np.uint8)
    cmyk[..., :3] = np.minimum(cmyk[..., :3], _image(37, 53, seed=12))
    path = tmp_path / "c.jpg"
    Image.fromarray(cmyk, "CMYK").save(path, "JPEG", quality=90, progressive=progressive)
    arr, mode = tio.decode_image(path.read_bytes())
    pil = Image.open(path)
    assert mode == pil.mode == "CMYK"
    assert np.abs(arr.astype(int) - np.asarray(pil).astype(int)).max() <= 1
    _check(path, record_property)
    np.testing.assert_array_equal(tio.convert(arr, mode, "L"), np.asarray(pil.convert("L")))


@pytest.mark.parametrize("adobe", [0, 2], ids=["cmyk", "ycck"])
@pytest.mark.parametrize("factors", [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)]],
                         ids=["444", "420"])
def test_four_components_hand_encoded(adobe, factors, tmp_path, record_property):
    """Adobe transform 0 (CMYK as stored) and 2 (YCCK, which libjpeg turns
    into CMYK with its YCbCr tables), written by the encoder above."""
    rgb = _image(37, 53, seed=13)
    k = np.random.default_rng(13).integers(0, 64, rgb.shape[:2]).astype(np.uint8)
    if adobe == 2:
        ycc = np.asarray(Image.fromarray(255 - rgb).convert("YCbCr"))
        planes = [ycc[..., i] for i in range(3)] + [k]
    else:
        planes = [rgb[..., i] for i in range(3)] + [k]
    path = tmp_path / "k.jpg"
    path.write_bytes(_encode(planes, factors, adobe=adobe))
    _check(path, record_property)
    pil = Image.open(path)
    arr, mode = tio.decode_image(path.read_bytes())
    assert mode == pil.mode == "CMYK"
    assert np.abs(arr.astype(int) - np.asarray(pil).astype(int)).max() <= 1


@pytest.mark.parametrize("fmt,word", [("WEBP", "WebP"), ("BMP", "BMP"), ("TIFF", "TIFF"),
                                      ("GIF", "GIF")])
def test_other_formats_refused_by_name(fmt, word, tmp_path):
    """WebP and BMP, once refused, now read as PIL reads them; TIFF and GIF
    are still refused by name."""
    rgb = _image(9, 7, seed=2)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, fmt, **({"lossless": True} if fmt == "WEBP" else {}))
    (tmp_path / "x.jpg").write_bytes(buf.getvalue())
    if fmt in ("WEBP", "BMP"):
        assert np.array_equal(tio.read_rgb8(tmp_path / "x.jpg"), rgb)
        return
    with pytest.raises(ValueError, match=f"x.jpg: {word} images are not supported"):
        tio.read_rgb8(tmp_path / "x.jpg")


def test_magic_bytes_not_suffix(tmp_path, record_property):
    """A PNG named .jpg and a JPEG named .png decode as what they are;
    load_mask takes a JPEG."""
    rgb = _image(37, 53, seed=5)
    Image.fromarray(rgb).save(tmp_path / "png.jpg", "PNG")
    assert np.array_equal(tio.read_rgb8(tmp_path / "png.jpg"), rgb)
    Image.fromarray(rgb).save(tmp_path / "jpeg.png", "JPEG", quality=90)
    _check(tmp_path / "jpeg.png", record_property)
    from ddnm_tpu.data.io import load_mask as j_load_mask

    Image.fromarray(rgb).save(tmp_path / "mask.jpg", "JPEG", quality=90)
    np.testing.assert_array_equal(tio.load_mask(tmp_path / "mask.jpg"),
                                  j_load_mask(tmp_path / "mask.jpg"))


def test_committed_fixtures_match_pil_decode():
    """Every committed JPEG fixture against PIL's decode stored beside it
    (tools/make_torch_jpeg_fixtures.py), and against PIL here."""
    oracle = np.load(REPO / "tests" / "fixtures" / "jpeg_pil_decode.npz")
    assert len(oracle.files) == 12
    for key in oracle.files:
        ours = tio.read_rgb8(REPO / key)
        stored = tio.decode_png(bytes(oracle[key]))
        assert stored.shape == ours.shape, key
        assert np.abs(ours.astype(int) - stored).max() <= 1, key
        assert np.array_equal(stored, np.asarray(Image.open(REPO / key).convert("RGB"))), key
