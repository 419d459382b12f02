"""The port's numpy WebP decoder (ddnm_tpu_torch/data/webp.py) against
PIL's decode (libwebp through `WebPAnimDecoder`, RGBA, fancy upsampling).

Images are made from seeded numpy (smooth waves plus noise) and written by
PIL: lossy VP8 at several qualities, methods and sizes that are not
multiples of 16 (PIL's encoder always writes the normal loop filter, with
segments and per-segment filter levels), lossless VP8L (predictor,
cross-colour, subtract-green, colour-indexing with pixel bundling, meta
codes, the colour cache), and alpha (`ALPH` compressed with VP8L and
filtered, or raw where compression does not pay). What PIL cannot write is
made by rewriting its files and decoded by PIL as the oracle: the first
partition re-encoded with a small boolean encoder (the simple loop filter,
sharpness, loop-filter deltas), and `ALPH` chunks stored raw with each of
the four filters. Gate: byte-equal pixels and PIL's mode ("RGBA" when the
file declares alpha, else "RGB")."""

import io
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ddnm_tpu_torch.data import webp
from ddnm_tpu_torch.data.io import convert, decode_image, has_alpha


def _waves(h: int, w: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 9.0 - k) for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _save(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _check(data: bytes) -> str:
    """Decode with the port and with PIL: same mode, same bytes; returns the mode."""
    pil = Image.open(io.BytesIO(data))
    ours, mode = webp.decode_webp(data)
    assert mode == pil.mode and has_alpha(mode) == ("A" in pil.getbands())
    ref = np.asarray(pil)
    assert ours.shape == ref.shape
    assert np.array_equal(ours, ref), f"{int((ours != ref).sum())} samples differ"
    for target in ("RGB", "L"):
        assert np.array_equal(convert(ours, mode, target), np.asarray(pil.convert(target)))
    return mode


def _chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos < len(data):
        tag, (size,) = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _riff(chunks: list) -> bytes:
    body = b"WEBP" + b"".join(t + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1)
                              for t, b in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("quality", [10, 50, 90, 100])
@pytest.mark.parametrize("size", [(16, 16), (37, 53), (97, 131)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossy_matches_pil(size, quality):
    assert _check(_save(_waves(*size, 3, seed=quality), quality=quality)) == "RGB"


@pytest.mark.parametrize("method", [0, 3, 6])
def test_lossy_methods_match_pil(method):
    data = _save(_waves(48, 40, 3, seed=method), quality=60, method=method)
    assert _chunks(data)[0][0] == b"VP8 "
    _check(data)


@pytest.mark.parametrize("size", [(1, 1), (1, 17), (17, 1), (3, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiny_images_match_pil(size):
    _check(_save(_waves(*size, 3, seed=1), quality=70))
    _check(_save(_waves(*size, 3, seed=2), lossless=True))


def test_gray_source_matches_pil():
    """PIL writes an "L" image as lossy YUV and reads it back as RGB."""
    assert _check(_save(_waves(40, 40, 1, seed=3)[..., 0], quality=80)) == "RGB"


class _BoolEncoder:
    """The VP8 boolean encoder (RFC 6386 section 7.3)."""

    def __init__(self):
        self.out, self.rng, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.rng - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.rng -= split
        else:
            self.rng = split
        while self.rng < 128:
            self.rng <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def finish(self) -> bytes:
        for _ in range(32):
            self.put(128, 0)
        return bytes(self.out)


def _reads(frame: bytes, monkeypatch) -> tuple[list, dict]:
    """(probability, bit) of every read the decoder makes from a VP8
    frame: the first partition's, and the token partitions' by macroblock
    row (a token read's row from the block's flat coefficient index)."""
    log, rows, readers, where = [], {}, [], {}
    init, bit, coeffs = webp._BoolReader.__init__, webp._BoolReader.bit, webp._BoolReader.coeffs
    mb_w = ((frame[6] | (frame[7] << 8)) & 0x3FFF) + 15 >> 4

    def logging_init(self, data):
        readers.append(self)
        init(self, data)

    def logging_bit(self, prob):
        b = bit(self, prob)
        if self is readers[0]:
            log.append((prob, b))
        else:
            rows.setdefault(where["row"], []).append((prob, b))
        return b

    def logging_coeffs(self, bands, ctx, dc_q, ac_q, n, base, idx, val):
        where["row"] = base // 400 // mb_w  # 400 coefficients a macroblock
        return coeffs(self, bands, ctx, dc_q, ac_q, n, base, idx, val)

    with monkeypatch.context() as m:
        m.setattr(webp._BoolReader, "__init__", logging_init)
        m.setattr(webp._BoolReader, "bit", logging_bit)
        m.setattr(webp._BoolReader, "coeffs", logging_coeffs)
        webp._decode_vp8(frame)
    return log, rows


def _encode_reads(reads: list) -> bytes:
    enc = _BoolEncoder()
    for prob, b in reads:
        enc.put(prob, b)
    return enc.finish()


def _frame(frame: bytes, part0: bytes, rest: bytes) -> bytes:
    """A VP8 frame's tag and header with a new first partition and the
    data after it."""
    tag = frame[0] | (frame[1] << 8) | (frame[2] << 16)
    tag = (tag & 0x1F) | (len(part0) << 5)
    return bytes([tag & 0xFF, (tag >> 8) & 0xFF, tag >> 16]) + frame[3:10] + part0 + rest


def _filter_header_at(log: list) -> int:
    """Where the loop-filter header starts among the first partition's reads."""
    i = 2  # colour space, clamping
    use_segment = log[i][1]
    i += 1
    if use_segment:
        update_map, update_data = log[i][1], log[i + 1][1]
        i += 2
        if update_data:
            i += 1
            for bits in (7, 7, 7, 7, 6, 6, 6, 6):
                i += 1 + (bits + 1) * log[i][1]
        if update_map:
            for _ in range(3):
                i += 1 + 8 * log[i][1]
    return i


def _literal(value: int, n: int) -> list:
    return [(128, (value >> (n - 1 - i)) & 1) for i in range(n)]


def _rewrite_filter_header(frame: bytes, monkeypatch, simple: int, sharpness: int,
                           deltas: tuple | None) -> bytes:
    """The frame with its loop-filter header replaced: the first partition
    is re-encoded from the decoder's reads with new filter bits."""
    log = _reads(frame, monkeypatch)[0]
    f = _filter_header_at(log)  # simple(1) level(6) sharpness(3) use_lf_delta(1) ...
    level = int("".join(str(b) for _, b in log[f + 1:f + 7]), 2)
    assert level > 0, "the frame must be filtered"
    assert log[f + 10][1] == 0, "PIL writes no loop-filter deltas"
    header = [(128, simple)] + log[f + 1:f + 7] + _literal(sharpness, 3)
    if deltas is None:
        header += [(128, 0)]
    else:
        header += [(128, 1), (128, 1)]
        for d in deltas:  # 4 reference-frame deltas, then 4 mode deltas
            header += [(128, 1)] + _literal(abs(d), 6) + [(128, int(d < 0))]
    old = (frame[0] | (frame[1] << 8) | (frame[2] << 16)) >> 5
    return _frame(frame, _encode_reads(log[:f] + header + log[f + 11:]), frame[10 + old:])


@pytest.mark.parametrize("simple,sharpness,deltas", [
    (1, 0, None), (1, 3, None), (0, 2, None), (0, 6, None),
    (0, 0, (5, 0, 0, 0, -7, 0, 0, 0)), (1, 5, (-3, 0, 0, 0, 9, 0, 0, 0)),
], ids=["simple", "simple_sharp3", "normal_sharp2", "normal_sharp6", "normal_deltas",
        "simple_sharp5_deltas"])
def test_loop_filter_variants_match_pil(simple, sharpness, deltas, monkeypatch):
    """The simple filter, sharpness and the reference / mode deltas (the
    mode delta moves 4x4-predicted macroblocks), which PIL's encoder never
    writes: PIL decodes the rewritten frame as the oracle."""
    data = _save(_waves(53, 70, 3, seed=5), quality=30)
    frame = _chunks(data)[0][1]
    new = _rewrite_filter_header(frame, monkeypatch, simple, sharpness, deltas)
    y0 = webp._decode_vp8(frame)[0]
    y1 = webp._decode_vp8(new)[0]
    assert not np.array_equal(y0, y1)  # the rewrite changed the filtering
    _check(_riff([(b"VP8 ", new)]))


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_token_partitions_match_pil(parts, monkeypatch):
    """2, 4 and 8 token partitions (macroblock rows dealt out in turn),
    which PIL's encoder never writes: the frame's token reads re-encoded
    into that many partitions, its partition count rewritten; PIL decodes
    the new frame as the oracle."""
    data = _save(_waves(150, 60, 3, seed=parts), quality=60)  # 10 macroblock rows
    frame = _chunks(data)[0][1]
    log, rows = _reads(frame, monkeypatch)
    f = _filter_header_at(log)
    assert log[f + 10][1] == 0  # no loop-filter deltas: the partition count follows
    at = f + 11
    assert log[at:at + 2] == [(128, 0), (128, 0)]  # one partition
    count = _literal(parts.bit_length() - 1, 2)
    part0 = _encode_reads(log[:at] + count + log[at + 2:])
    bodies = [_encode_reads([r for y in sorted(rows) if y % parts == k for r in rows[y]])
              for k in range(parts)]
    sizes = b"".join(len(b).to_bytes(3, "little") for b in bodies[:-1])
    new = _frame(frame, part0, sizes + b"".join(bodies))
    assert np.array_equal(webp._decode_vp8(new)[0], webp._decode_vp8(frame)[0])
    _check(_riff([(b"VP8 ", new)]))


def _signed_literal(v: int, bits: int) -> list:
    """A segment value as the header stores it: a flag, then magnitude and sign."""
    return [(128, 1)] + _literal(abs(v), bits) + [(128, int(v < 0))] if v else [(128, 0)]


def test_segment_values_as_deltas_match_pil(monkeypatch):
    """Segment quantisers and filter levels given as deltas from the frame's
    (PIL's encoder writes them absolute): the same frame with its segment
    header rewritten decodes to the same pixels, and PIL agrees."""
    data = _save(_waves(64, 80, 3, seed=21), quality=40)
    frame = _chunks(data)[0][1]
    log = _reads(frame, monkeypatch)[0]
    bits = lambda a, b: int("".join(str(x) for _, x in log[a:b]), 2)  # noqa: E731
    assert log[2][1] and log[4][1] and log[5][1]  # segments, their data, absolute
    i, values = 6, []
    for n in (7, 7, 7, 7, 6, 6, 6, 6):
        v = bits(i + 1, i + 1 + n) * (-1 if log[i + n + 1][1] else 1) if log[i][1] else 0
        values.append(v)
        i += 1 + (n + 1) * log[i][1]
    seg_end = i
    if log[3][1]:  # the segment map's probabilities
        for _ in range(3):
            i += 1 + 8 * log[i][1]
    f = i
    level = bits(f + 1, f + 7)
    assert log[f + 10][1] == 0
    base_q = bits(f + 13, f + 20)  # after the 2-bit partition count
    header = log[:5] + [(128, 0)]  # absolute -> delta
    for v, n in zip(values, (7, 7, 7, 7, 6, 6, 6, 6)):
        header += _signed_literal(v - (base_q if n == 7 else level), n)
    new = _frame(frame, _encode_reads(header + log[seg_end:]),
                 frame[10 + ((frame[0] | (frame[1] << 8) | (frame[2] << 16)) >> 5):])
    assert np.array_equal(webp._decode_vp8(new)[0], webp._decode_vp8(frame)[0])
    _check(_riff([(b"VP8 ", new)]))


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("channels", [3, 4])
def test_lossless_matches_pil(channels, method):
    data = _save(_waves(70, 50, channels, seed=channels), lossless=True, method=method)
    assert _chunks(data)[0][0] == b"VP8L"
    assert _check(data) == ("RGBA" if channels == 4 else "RGB")


def _stripes(seed: int) -> np.ndarray:
    """96 x 96: constant rows, constant columns, diagonals, anti-diagonals
    and a noisy ramp, one band each, which lead libwebp's lossless encoder
    to the left, top, top-left, top-right and clamped predictors."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:96, 0:96]
    img = np.zeros((96, 96, 3), np.int64)
    img[:32] = rng.integers(0, 256, (96, 1, 3))[:32]
    img[32:64] = rng.integers(0, 256, (1, 96, 3))
    diag = rng.integers(0, 256, (192, 3))
    img[64:, :32] = diag[(x - y) % 192][64:, :32]
    img[64:, 32:64] = diag[(x + y) % 192][64:, 32:64]
    ramp = x[..., None] * 3 + y[..., None] * 5 + rng.integers(0, 3, (96, 96, 3))
    img[64:, 64:] = ramp[64:, 64:] % 256
    return img.astype(np.uint8)


@pytest.mark.parametrize("method", [3, 5])
def test_lossless_predictor_modes_match_pil(method):
    """Predictors 1-4 and 11-13 (the smooth images above take 5, 7-10)."""
    _check(_save(_stripes(method), lossless=True, method=method))


def test_lossless_meta_codes_and_cache_match_pil():
    """A 96 px photograph at method 3: meta prefix codes (a prefix-code
    group per tile) and the colour cache."""
    src = Image.open(Path(__file__).resolve().parents[1] / "exp" / "datasets" / "celeba_hq"
                     / "00000.png").convert("RGB").resize((96, 96), Image.BICUBIC)
    _check(_save(np.asarray(src), lossless=True, method=3, quality=50))


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
def test_lossless_palette_matches_pil(colors):
    """Colour indexing with 8, 4, 2 and 1 pixels bundled a byte."""
    rng = np.random.default_rng(colors)
    pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
    _check(_save(pal[rng.integers(0, colors, (33, 45))], lossless=True))


@pytest.mark.parametrize("alpha_quality", [100, 50])
@pytest.mark.parametrize("method", [0, 3, 6])
def test_lossy_alpha_matches_pil(method, alpha_quality):
    """`ALPH` compressed with VP8L, filtered by method (horizontal,
    vertical), its levels quantised below alpha_quality 100."""
    data = _save(_waves(48, 40, 4, seed=method), quality=70, method=method,
                 alpha_quality=alpha_quality)
    tags = [t for t, _ in _chunks(data)]
    assert tags[:3] == [b"VP8X", b"ALPH", b"VP8 "]
    assert dict(_chunks(data))[b"ALPH"][0] & 3 == 1  # VP8L-compressed
    assert _check(data) == "RGBA"


def test_raw_alpha_matches_pil():
    """Noise alpha does not compress: PIL's writer stores it raw."""
    rgba = _waves(37, 53, 4, seed=7)
    rgba[..., 3] = np.random.default_rng(7).integers(0, 256, rgba.shape[:2])
    data = _save(rgba, quality=75)
    assert dict(_chunks(data))[b"ALPH"][0] & 3 == 0
    _check(data)


def _filter_alpha(a: np.ndarray, kind: int) -> np.ndarray:
    """libwebp's forward alpha filters: the residual of each prediction."""
    a = a.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if kind == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:] = a[:-1]
    else:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("kind", [0, 1, 2, 3], ids=["none", "horizontal", "vertical",
                                                     "gradient"])
def test_rewritten_raw_alpha_matches_pil(kind):
    """An `ALPH` chunk rewritten raw from the decoded plane, unfiltered or
    with each filter (PIL's writer never stores raw and filtered)."""
    data = _save(_waves(40, 48, 4, seed=8), quality=75)
    plane = np.asarray(Image.open(io.BytesIO(data)))[..., 3]
    chunk = bytes([kind << 2]) + _filter_alpha(plane, kind).tobytes() if kind else \
        bytes([0]) + plane.tobytes()
    new = _riff([(t, chunk if t == b"ALPH" else b) for t, b in _chunks(data)])
    _check(new)
    assert np.array_equal(webp.decode_webp(new)[0][..., 3], plane)


def test_alpha_declarations_set_the_mode():
    """libwebp's has_alpha, which PIL's mode follows: for VP8 the VP8X flag
    or an ALPH chunk (opaque when there is none, or no flag); for VP8L the
    header's bit, whatever the VP8X flag says."""
    data = _save(_waves(20, 24, 4, seed=9), quality=75)
    chunks = _chunks(data)
    vp8x = chunks[0][1]
    no_flag = [(b"VP8X", bytes([vp8x[0] & ~0x10]) + vp8x[1:])]
    assert _check(_riff(no_flag + chunks[1:])) == "RGBA"
    assert (webp.decode_webp(_riff(no_flag + chunks[1:]))[0][..., 3] == 255).all()
    no_alph = _riff([c for c in chunks if c[0] != b"ALPH"])
    assert _check(no_alph) == "RGBA"
    assert (webp.decode_webp(no_alph)[0][..., 3] == 255).all()
    assert _check(_riff(no_flag + [c for c in chunks[1:] if c[0] != b"ALPH"])) == "RGB"
    lossless = _chunks(_save(_waves(20, 24, 4, seed=9), lossless=True))[0][1]
    hdr = int.from_bytes(lossless[1:5], "little")
    no_bit = lossless[:1] + (hdr & ~(1 << 28)).to_bytes(4, "little") + lossless[5:]
    size = (23).to_bytes(3, "little") + (19).to_bytes(3, "little")
    assert _check(_riff([(b"VP8X", bytes([0x10, 0, 0, 0]) + size), (b"VP8L", no_bit)])) == "RGB"
    assert _check(_riff([(b"VP8X", bytes(4) + size), (b"VP8L", lossless)])) == "RGBA"


def test_refusals():
    frames = [Image.fromarray(_waves(16, 16, 3, seed=s)) for s in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50)
    with pytest.raises(ValueError, match="a.webp: animated WebP is not supported"):
        decode_image(buf.getvalue(), "a.webp")
    data = _save(_waves(16, 16, 3, seed=1), quality=50)
    with pytest.raises(ValueError, match="t.webp: truncated"):
        decode_image(data[:-40], "t.webp")
    with pytest.raises(ValueError, match="not a WebP"):
        webp.decode_webp(b"RIFF\0\0\0\0WAVEfmt ")
