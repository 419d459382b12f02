"""WebP decoding in numpy: the counterpart of PIL's `Image.open(f)` for
still WebP files (LSUN's lmdb values, folder datasets, uploads).

The machine that runs the port has no imaging package, so this module
decodes in Python and numpy, to the bytes libwebp's default decode into
RGBA gives (fancy upsampling on, no dithering), which is what PIL reads:

  - the RIFF container: a simple `VP8 ` or `VP8L` file, or `VP8X` with an
    `ALPH` chunk; ICC, EXIF and XMP chunks are skipped; an animation
    (`ANIM` / `ANMF`) raises ValueError;
  - VP8 lossy key frames (RFC 6386): the boolean entropy decoder, the
    intra mode and token trees, segments and their quantisers, the 16x16,
    4x4 and chroma intra predictors, the inverse WHT and DCT, and the
    simple and normal loop filters with sharpness and per-segment and
    mode deltas; then libwebp's "fancy" 9-3-3-1 chroma upsampling and its
    14-bit YUV -> RGB constants;
  - VP8L lossless: prefix codes and meta prefix codes, LZ77 copies with
    the 120-entry distance map, the colour cache, and the predictor,
    cross-colour, subtract-green and colour-indexing transforms;
  - `ALPH`: raw or VP8L-compressed planes, unfiltered (horizontal,
    vertical, gradient).

Mode is "RGBA" when libwebp's WebPGetFeatures says the file has alpha,
else "RGB", as PIL's `getbands()` reports it: for VP8L the header's alpha
bit (a VP8X flag does not override it), for VP8 the VP8X alpha flag or an
`ALPH` chunk (whose plane libwebp decodes only under the flag: without it
the alpha is opaque).

Entropy decoding walks the bitstream in Python; the inverse transforms,
the residual add of 16x16 and chroma blocks, the loop filter (one wave of
independent macroblocks at a time), the upsampling, the colour
conversion and the VP8L transforms other than the predictor run
vectorised in numpy.
"""

from __future__ import annotations

import struct

import numpy as np

from ddnm_tpu_torch.data import webp_tables as _tables
from ddnm_tpu_torch.data.jpeg import MAX_PIXELS

__all__ = ["decode_webp", "is_webp"]

_COEFF_PROBS = list(_tables.COEFF_PROBS)
_COEFF_UPDATE = list(_tables.COEFF_UPDATE_PROBS)
_BMODE_PROBS = np.frombuffer(_tables.BMODE_PROBS, np.uint8).reshape(10, 10, 9).tolist()
_DC_QUANT = list(_tables.DC_QUANT)
_AC_QUANT = np.frombuffer(_tables.AC_QUANT, "<u2").tolist()
_CODE_TO_PLANE = list(_tables.CODE_TO_PLANE)

# token position -> band, with a sentinel for position 16
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
# token position -> raster position in the 4x4 block
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# 4x4 intra mode tree; modes DC, TM, VE, HE, RD, VR, LD, VL, HD, HU = 0..9
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_DC, _TM, _VE, _HE = 0, 1, 2, 3
# the left shift that brings a range back to [128, 255]
_NORM = [0] + [8 - i.bit_length() for i in range(1, 256)]
_ALPHA_FLAG, _ANIMATION_FLAG = 0x10, 0x02


def is_webp(raw: bytes) -> bool:
    return raw[:4] == b"RIFF" and raw[8:12] == b"WEBP"


# ---------------------------------------------------------------- container


def decode_webp(raw: bytes, name: str = "<bytes>") -> tuple[np.ndarray, str]:
    """WebP bytes -> (uint8 (H, W, 3) or (H, W, 4), "RGB" or "RGBA")."""
    if not is_webp(raw) or len(raw) < 20:
        raise ValueError(f"{name}: not a WebP file")
    (riff_size,) = struct.unpack_from("<I", raw, 4)
    if riff_size < 12 or riff_size + 8 > len(raw):
        raise ValueError(f"{name}: truncated WebP file")
    end = 8 + riff_size
    chunks = []
    pos = 12
    while pos + 8 <= end:
        tag = raw[pos:pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        if pos + 8 + size > end:
            raise ValueError(f"{name}: truncated WebP chunk {tag!r}")
        chunks.append((tag, raw[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    if not chunks:
        raise ValueError(f"{name}: WebP without chunks")
    tags = [t for t, _ in chunks]
    if b"ANIM" in tags or b"ANMF" in tags:
        raise ValueError(f"{name}: animated WebP is not supported (still images only; "
                         "see ROADMAP.md)")
    alpha_chunk, canvas = None, None
    has_alpha = None
    if tags[0] == b"VP8X":
        body = chunks[0][1]
        if len(body) < 10:
            raise ValueError(f"{name}: short VP8X chunk")
        if body[0] & _ANIMATION_FLAG:
            raise ValueError(f"{name}: animated WebP is not supported (still images only; "
                             "see ROADMAP.md)")
        has_alpha = bool(body[0] & _ALPHA_FLAG)
        canvas = (1 + int.from_bytes(body[4:7], "little"), 1 + int.from_bytes(body[7:10], "little"))
        alpha_chunk = next((b for t, b in chunks if t == b"ALPH"), None)
    image = next(((t, b) for t, b in chunks if t in (b"VP8 ", b"VP8L")), None)
    if image is None:
        raise ValueError(f"{name}: WebP without a VP8 or VP8L bitstream")
    tag, body = image
    try:
        if tag == b"VP8L":
            argb, width, height, has_alpha = _decode_vp8l(body)
            out = _argb_to_rgba(argb)
        else:
            y, u, v, width, height = _decode_vp8(body)
            out = np.empty((height, width, 4), np.uint8)
            out[..., :3] = _yuv_to_rgb(y, u, v)
            out[..., 3] = 255
            if alpha_chunk is not None and has_alpha:  # libwebp ignores it without the flag
                out[..., 3] = _decode_alpha(alpha_chunk, width, height)
            has_alpha = bool(has_alpha) or alpha_chunk is not None
    except (IndexError, KeyError) as e:
        raise ValueError(f"{name}: corrupt WebP data ({e!r})") from None
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if canvas is not None and canvas != (width, height):
        raise ValueError(f"{name}: WebP canvas {canvas} differs from its image "
                         f"{(width, height)}")
    if has_alpha:
        return out, "RGBA"
    return np.ascontiguousarray(out[..., :3]), "RGB"


# ---------------------------------------------------------------- VP8 (lossy)


class _BoolReader:
    """The VP8 boolean entropy decoder (RFC 6386 section 7) in libwebp's
    form: `rng` holds range - 1, `value` the bits read so far of which the
    top 8 above `bits` are compared. Bytes past the end read as zeros and
    set `eof`."""

    __slots__ = ("buf", "pos", "value", "bits", "rng", "eof")

    def __init__(self, data: bytes):
        self.buf, self.pos = data, 0
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, False
        self._load()

    def _load(self) -> None:
        n = min(7, len(self.buf) - self.pos)
        if n > 0:
            self.value = (self.value << (8 * n)) | int.from_bytes(
                self.buf[self.pos:self.pos + n], "big")
            self.pos += n
            self.bits += 8 * n
        else:
            self.value <<= 8
            self.bits += 8
            self.eof = True

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = (self.rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng = self.rng - split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = _NORM[rng]
        self.rng = (rng << shift) - 1
        self.bits -= shift
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(0x80) else v

    def large_value(self, p: list) -> int:
        """A token's magnitude above 1 (libwebp GetLargeValue)."""
        bit = self.bit
        if not bit(p[3]):
            return 2 if not bit(p[4]) else 3 + bit(p[5])
        if not bit(p[6]):
            if not bit(p[7]):
                return 5 + bit(159)
            return 7 + 2 * bit(165) + bit(145)
        b1 = bit(p[8])
        cat = 2 * b1 + bit(p[9 + b1])
        v = 0
        for prob in _CAT_PROBS[cat]:
            v = 2 * v + bit(prob)
        return v + 3 + (8 << cat)

    def coeffs(self, bands: list, ctx: int, dc_q: int, ac_q: int, n: int,
               base: int, idx: list, val: list) -> int:
        """One block's tokens from position `n` (libwebp GetCoeffs):
        appends each non-zero dequantised coefficient's flat index (base +
        raster position) and value; returns the position after the last
        non-zero token (`n` itself when the block ends at once)."""
        bit = self.bit
        p = bands[n][ctx]
        while n < 16:
            if not bit(p[0]):  # no more tokens
                return n
            while not bit(p[1]):  # a zero token
                n += 1
                if n == 16:
                    return 16
                p = bands[n][0]
            if bit(p[2]):
                v = self.large_value(p)
                p = bands[n + 1][2]
            else:
                v = 1
                p = bands[n + 1][1]
            idx.append(base + _ZIGZAG[n])
            val.append((-v if bit(0x80) else v) * (ac_q if n else dc_q))
            n += 1
        return 16


def _clip(q: int, hi: int) -> int:
    return 0 if q < 0 else hi if q > hi else q


def _decode_vp8(data: bytes):
    """A VP8 key frame -> (Y, U, V) uint8 planes cropped to the picture,
    width, height."""
    if len(data) < 10:
        raise ValueError("truncated VP8 frame header")
    tag = data[0] | (data[1] << 8) | (data[2] << 16)
    key_frame, profile, show, part0 = not (tag & 1), (tag >> 1) & 7, (tag >> 4) & 1, tag >> 5
    if not key_frame:
        raise ValueError("VP8 frame is not a key frame")
    if profile > 3 or not show:
        raise ValueError("bad VP8 frame header")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("bad VP8 start code")
    width = (data[6] | (data[7] << 8)) & 0x3FFF
    height = (data[8] | (data[9] << 8)) & 0x3FFF
    if width == 0 or height == 0 or width * height > MAX_PIXELS:
        raise ValueError(f"VP8 frame of {width} x {height} pixels (at most {MAX_PIXELS})")
    buf = data[10:]
    if part0 > len(buf):
        raise ValueError("truncated VP8 first partition")
    br = _BoolReader(buf[:part0])
    rest = buf[part0:]
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4

    br.literal(2)  # colour space and clamping type: no effect on the decode
    # segment header
    use_segment = br.literal(1)
    update_map, absolute = 0, 1
    seg_quant, seg_filter = [0] * 4, [0] * 4
    seg_probs = [255, 255, 255]
    if use_segment:
        update_map = br.literal(1)
        if br.literal(1):
            absolute = br.literal(1)
            seg_quant = [br.signed(7) if br.literal(1) else 0 for _ in range(4)]
            seg_filter = [br.signed(6) if br.literal(1) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.literal(8) if br.literal(1) else 255 for _ in range(3)]
    # filter header
    simple, level, sharpness = br.literal(1), br.literal(6), br.literal(3)
    use_lf_delta = br.literal(1)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    if use_lf_delta and br.literal(1):
        for i in range(4):
            if br.literal(1):
                ref_delta[i] = br.signed(6)
        for i in range(4):
            if br.literal(1):
                mode_delta[i] = br.signed(6)
    filter_type = 0 if level == 0 else 1 if simple else 2
    # token partitions
    last = (1 << br.literal(2)) - 1
    if len(rest) < 3 * last:
        raise ValueError("truncated VP8 partition sizes")
    parts, start, left = [], 3 * last, len(rest) - 3 * last
    for p in range(last):
        size = min(int.from_bytes(rest[3 * p:3 * p + 3], "little"), left)
        parts.append(_BoolReader(rest[start:start + size]))
        start += size
        left -= size
    parts.append(_BoolReader(rest[start:]))
    # quantisers
    base_q = br.literal(7)
    dq = [br.signed(4) if br.literal(1) else 0 for _ in range(5)]  # y1dc y2dc y2ac uvdc uvac
    quant = []
    for s in range(4):
        if use_segment:
            q = seg_quant[s] + (0 if absolute else base_q)
        else:
            q = base_q
        y2ac = (_AC_QUANT[_clip(q + dq[2], 127)] * 101581) >> 16
        quant.append((_DC_QUANT[_clip(q + dq[0], 127)], _AC_QUANT[_clip(q, 127)],
                      _DC_QUANT[_clip(q + dq[1], 127)] * 2, max(y2ac, 8),
                      _DC_QUANT[_clip(q + dq[3], 117)], _AC_QUANT[_clip(q + dq[4], 127)]))
    br.literal(1)  # refresh entropy probabilities: no effect on one frame
    probs = []
    i = 0
    for t in range(4):
        bands = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                row = []
                for _ in range(11):
                    row.append(br.literal(8) if br.bit(_COEFF_UPDATE[i]) else _COEFF_PROBS[i])
                    i += 1
                ctxs.append(row)
            bands.append(ctxs)
        probs.append([bands[_BANDS[n]] for n in range(17)])
    use_skip = br.literal(1)
    skip_prob = br.literal(8) if use_skip else 0

    # per macroblock: segment, skip, modes (first partition, raster order)
    n_mb = mb_w * mb_h
    seg = [0] * n_mb
    skip = [0] * n_mb
    is4 = [0] * n_mb
    ymodes = [None] * n_mb
    uvmode = [0] * n_mb
    top = [0] * (4 * mb_w)
    for mb_y in range(mb_h):
        left_m = [0] * 4
        for mb_x in range(mb_w):
            m = mb_y * mb_w + mb_x
            if update_map:
                seg[m] = (br.bit(seg_probs[1]) if not br.bit(seg_probs[0])
                          else 2 + br.bit(seg_probs[2]))
            if use_skip:
                skip[m] = br.bit(skip_prob)
            if not br.bit(145):
                is4[m] = 1
                modes = []
                for y in range(4):
                    ymode = left_m[y]
                    for x in range(4):
                        prob = _BMODE_PROBS[top[4 * mb_x + x]][ymode]
                        i = _BMODE_TREE[br.bit(prob[0])]
                        while i > 0:
                            i = _BMODE_TREE[2 * i + br.bit(prob[i])]
                        ymode = -i
                        top[4 * mb_x + x] = ymode
                        modes.append(ymode)
                    left_m[y] = ymode
                ymodes[m] = modes
            else:
                ymode = ((_TM if br.bit(128) else _HE) if br.bit(156)
                         else (_VE if br.bit(163) else _DC))
                ymodes[m] = ymode
                top[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                left_m = [ymode] * 4
            uvmode[m] = (_DC if not br.bit(142) else _VE if not br.bit(114)
                         else _TM if br.bit(183) else _HE)
        if br.eof:
            raise ValueError("premature end of the VP8 first partition")

    # residual tokens (one partition per row, rows interleaved)
    idx: list = []
    val: list = []
    y2_mbs: list = []  # (macroblock, its Y2 block's flat base) for 16x16 blocks
    nonzero = [0] * n_mb
    top_nz = [0] * (9 * mb_w)  # per column: 4 Y, 2 U, 2 V, Y2
    for mb_y in range(mb_h):
        tbr = parts[mb_y & last]
        left_nz = [0] * 9
        for mb_x in range(mb_w):
            m = mb_y * mb_w + mb_x
            if skip[m]:
                t = top_nz[9 * mb_x:9 * mb_x + 9]
                t[:8] = [0] * 8
                left_nz[:8] = [0] * 8
                if not is4[m]:
                    t[8] = left_nz[8] = 0
                top_nz[9 * mb_x:9 * mb_x + 9] = t
                continue
            y1dc, y1ac, y2dc, y2ac, uvdc, uvac = quant[seg[m]]
            base = m * 400  # 25 blocks of 16: Y 0-15, U 16-19, V 20-23, Y2 24
            tn = top_nz[9 * mb_x:9 * mb_x + 9]
            n_before = len(idx)
            if not is4[m]:
                nz = tbr.coeffs(probs[1], tn[8] + left_nz[8], y2dc, y2ac, 0,
                                base + 384, idx, val)
                tn[8] = left_nz[8] = int(nz > 0)
                y2_mbs.append(m)
                first, ac = 1, probs[0]
            else:
                first, ac = 0, probs[3]
            for y in range(4):
                lft = left_nz[y]
                for x in range(4):
                    nz = tbr.coeffs(ac, lft + tn[x], y1dc, y1ac, first,
                                    base + 16 * (4 * y + x), idx, val)
                    lft = tn[x] = int(nz > first)
                left_nz[y] = lft
            for ch, off in ((0, 16), (2, 20)):
                for y in range(2):
                    lft = left_nz[4 + ch + y]
                    for x in range(2):
                        nz = tbr.coeffs(probs[2], lft + tn[4 + ch + x], uvdc, uvac, 0,
                                        base + 16 * (off + 2 * y + x), idx, val)
                        lft = tn[4 + ch + x] = int(nz > 0)
                    left_nz[4 + ch + y] = lft
            top_nz[9 * mb_x:9 * mb_x + 9] = tn
            nonzero[m] = len(idx) - n_before
        if tbr.eof:
            raise ValueError("premature end of a VP8 token partition")

    coef = np.zeros(n_mb * 400, np.int64)
    if idx:
        coef[np.asarray(idx, np.int64)] = val
    coef = coef.astype(np.int16).astype(np.int64).reshape(n_mb, 25, 16)
    has_dc = np.zeros(n_mb, bool)
    if y2_mbs:
        mbs = np.asarray(y2_mbs)
        dcs = _iwht(coef[mbs, 24])
        coef[mbs, :16, 0] = dcs
        has_dc[mbs] = (dcs != 0).any(axis=1)
    # a macroblock with no non-zero coefficient skips its inner loop-filter edges
    coded = np.asarray(nonzero) > 0
    if y2_mbs:
        # a 16x16 block's Y2 tokens count only through the DC they give
        y2_only = np.zeros(n_mb, bool)
        y2_only[mbs] = True
        ac_or_chroma = (coef[:, :24].reshape(n_mb, -1) != 0)
        ac_or_chroma[:, np.arange(16) * 16] = False
        coded = np.where(y2_only, ac_or_chroma.any(axis=1) | has_dc, coded)
    residual = _idct4(coef[:, :24].reshape(-1, 16)).reshape(n_mb, 24, 4, 4)

    ys, us, vs = _reconstruct(mb_w, mb_h, is4, ymodes, uvmode, residual)
    if filter_type:
        inner = [bool(is4[m] or coded[m]) for m in range(n_mb)]
        strengths = _filter_strengths(use_segment, absolute, seg_filter, level, sharpness,
                                      use_lf_delta, ref_delta, mode_delta)
        params = [strengths[seg[m]][is4[m]] for m in range(n_mb)]
        _loop_filter(ys, us, vs, mb_w, mb_h, params, inner, filter_type == 1)
    return (ys[:height, :width], us[:(height + 1) // 2, :(width + 1) // 2],
            vs[:(height + 1) // 2, :(width + 1) // 2], width, height)


def _iwht(x: np.ndarray) -> np.ndarray:
    """libwebp TransformWHT over (N, 16) raster Y2 blocks -> (N, 16) DCs
    of the 16 Y blocks in raster order, wrapped to int16 as stored."""
    i0, i1, i2, i3 = x[:, 0:4], x[:, 4:8], x[:, 8:12], x[:, 12:16]
    a0, a1, a2, a3 = i0 + i3, i1 + i2, i1 - i2, i0 - i3
    t0, t1, t2, t3 = a0 + a1, a3 + a2, a0 - a1, a3 - a2  # rows 0, 1, 2, 3
    t = np.stack([t0, t1, t2, t3], axis=1)  # (N, 4 rows, 4 cols)
    dc = t[:, :, 0] + 3
    a0, a1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    a2, a3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    out = np.stack([(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3], axis=2)
    return out.reshape(-1, 16).astype(np.int16).astype(np.int64)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct4(x: np.ndarray) -> np.ndarray:
    """libwebp TransformOne over (N, 16) raster blocks -> (N, 16) residuals
    (the value added to the prediction before clipping): columns, then rows
    with the rounder, then >> 3."""
    x = x.reshape(-1, 4, 4)
    i0, i1, i2, i3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]  # rows: vertical frequency
    a, b = i0 + i2, i0 - i2
    c, d = _mul2(i1) - _mul1(i3), _mul1(i1) + _mul2(i3)
    v = np.stack([a + d, b + c, b - c, a - d], axis=1)  # (N, row, col)
    h0, h1, h2, h3 = v[:, :, 0] + 4, v[:, :, 1], v[:, :, 2], v[:, :, 3]
    a, b = h0 + h2, h0 - h2
    c, d = _mul2(h1) - _mul1(h3), _mul1(h1) + _mul2(h3)
    out = np.stack([a + d, b + c, b - c, a - d], axis=2) >> 3
    return out.reshape(-1, 16)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, t: list, l: list, X: int) -> list:
    """A 4x4 intra prediction (libwebp dsp/dec.c) from the 8 samples above
    (A..H, the last 4 above-right), the 4 to the left (I..L) and the corner
    X; returns 16 samples in raster order."""
    A, B, C, D, E, F, G, H = t
    I, J, K, L = l
    if mode == 0:  # DC
        dc = (A + B + C + D + I + J + K + L + 4) >> 3
        return [dc] * 16
    if mode == 1:  # TM
        out = []
        for y in l:
            for x in t[:4]:
                v = x + y - X
                out.append(0 if v < 0 else 255 if v > 255 else v)
        return out
    if mode == 2:  # VE
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == 3:  # HE
        return ([_avg3(X, I, J)] * 4 + [_avg3(I, J, K)] * 4 + [_avg3(J, K, L)] * 4
                + [_avg3(K, L, L)] * 4)
    if mode == 4:  # RD
        jkl, ijk, xij, axi = _avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I)
        bax, cba, dcb = _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)
        return [axi, bax, cba, dcb, xij, axi, bax, cba, ijk, xij, axi, bax, jkl, ijk, xij, axi]
    if mode == 5:  # VR
        xa, ab, bc, cd = _avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)
        kji, jix, ixa = _avg3(K, J, I), _avg3(J, I, X), _avg3(I, X, A)
        xab, abc, bcd = _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)
        return [xa, ab, bc, cd, ixa, xab, abc, bcd, jix, xa, ab, bc, kji, ixa, xab, abc]
    if mode == 6:  # LD
        abc, bcd, cde, def_ = _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)
        efg, fgh, ghh = _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)
        return [abc, bcd, cde, def_, bcd, cde, def_, efg, cde, def_, efg, fgh,
                def_, efg, fgh, ghh]
    if mode == 7:  # VL
        ab, bc, cd, de = _avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)
        abc, bcd, cde, def_ = _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)
        efg, fgh = _avg3(E, F, G), _avg3(F, G, H)
        return [ab, bc, cd, de, abc, bcd, cde, def_, bc, cd, de, efg, bcd, cde, def_, fgh]
    if mode == 8:  # HD
        ix, ji, kj, lk = _avg2(I, X), _avg2(J, I), _avg2(K, J), _avg2(L, K)
        abc, xab, ixa = _avg3(A, B, C), _avg3(X, A, B), _avg3(I, X, A)
        jix, kji, lkj = _avg3(J, I, X), _avg3(K, J, I), _avg3(L, K, J)
        return [ix, ixa, xab, abc, ji, jix, ix, ixa, kj, kji, ji, jix, lk, lkj, kj, kji]
    # HU
    ij, jk, kl = _avg2(I, J), _avg2(J, K), _avg2(K, L)
    ijk, jkl, kll = _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)
    return [ij, ijk, jk, jkl, jk, jkl, kl, kll, kl, kll, L, L, L, L, L, L]


def _pred_block(mode: int, wb: np.ndarray, size: int, mb_x: int, mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction into wb[1:, 1:size + 1] from
    its border (row 0, column 0), libwebp's DC variants at the frame's
    top and left edges included."""
    top = wb[0, 1:size + 1]
    left = wb[1:size + 1, 0]
    shift = 4 if size == 16 else 3
    if mode == _DC:
        if mb_x and mb_y:
            dc = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif mb_y:  # left column of the frame: the samples above only
            dc = (int(top.sum()) + (size >> 1)) >> shift
        elif mb_x:  # top row of the frame: the samples to the left only
            dc = (int(left.sum()) + (size >> 1)) >> shift
        else:
            dc = 0x80
        return np.full((size, size), dc, np.int32)
    if mode == _TM:
        return np.clip(top[None, :] + left[:, None] - wb[0, 0], 0, 255)
    if mode == _VE:
        return np.broadcast_to(top[None, :], (size, size))
    return np.broadcast_to(left[:, None], (size, size))  # HE


def _reconstruct(mb_w, mb_h, is4, ymodes, uvmode, residual):
    """Intra prediction plus residual for every macroblock in raster order,
    with libwebp's borders: 127 above the frame, 129 left of it, the corner
    129 on later rows; the above-right samples of the last column repeat
    the last sample above. Returns unfiltered Y, U, V planes."""
    H, W = 16 * mb_h, 16 * mb_w
    ys = np.zeros((H, W), np.int32)
    us = np.zeros((H // 2, W // 2), np.int32)
    vs = np.zeros((H // 2, W // 2), np.int32)
    wb = np.zeros((17, 21), np.int32)
    wc = np.zeros((9, 9), np.int32)
    res_y = residual[:, :16].reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(-1, 16, 16)
    res_c = residual[:, 16:].reshape(-1, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5).reshape(
        -1, 2, 8, 8)
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            m = mb_y * mb_w + mb_x
            y0, x0 = 16 * mb_y, 16 * mb_x
            # luma border
            if mb_y:
                wb[0, 1:17] = ys[y0 - 1, x0:x0 + 16]
                wb[0, 0] = ys[y0 - 1, x0 - 1] if mb_x else 129
                if mb_x < mb_w - 1:
                    wb[0, 17:21] = ys[y0 - 1, x0 + 16:x0 + 20]
                else:
                    wb[0, 17:21] = ys[y0 - 1, x0 + 15]
            else:
                wb[0, :] = 127
            wb[1:17, 0] = ys[y0:y0 + 16, x0 - 1] if mb_x else 129
            if is4[m]:
                wb[4, 17:21] = wb[8, 17:21] = wb[12, 17:21] = wb[0, 17:21]
                res = res_y[m]
                for n, mode in enumerate(ymodes[m]):
                    by, bx = 4 * (n >> 2), 4 * (n & 3)
                    pred = _pred4(mode, wb[by, bx + 1:bx + 9].tolist(),
                                  wb[by + 1:by + 5, bx].tolist(), int(wb[by, bx]))
                    blk = np.asarray(pred, np.int32).reshape(4, 4) + res[by:by + 4, bx:bx + 4]
                    wb[by + 1:by + 5, bx + 1:bx + 5] = np.clip(blk, 0, 255)
            else:
                pred = _pred_block(ymodes[m], wb, 16, mb_x, mb_y)
                wb[1:17, 1:17] = np.clip(pred + res_y[m], 0, 255)
            ys[y0:y0 + 16, x0:x0 + 16] = wb[1:17, 1:17]
            # chroma
            c0y, c0x = 8 * mb_y, 8 * mb_x
            for k, plane in enumerate((us, vs)):
                if mb_y:
                    wc[0, 1:9] = plane[c0y - 1, c0x:c0x + 8]
                    wc[0, 0] = plane[c0y - 1, c0x - 1] if mb_x else 129
                else:
                    wc[0, :] = 127
                wc[1:9, 0] = plane[c0y:c0y + 8, c0x - 1] if mb_x else 129
                pred = _pred_block(uvmode[m], wc, 8, mb_x, mb_y)
                plane[c0y:c0y + 8, c0x:c0x + 8] = np.clip(pred + res_c[m, k], 0, 255)
    return ys, us, vs


def _filter_strengths(use_segment, absolute, seg_filter, level, sharpness, use_lf_delta,
                      ref_delta, mode_delta):
    """(limit, interior limit, hev threshold) per segment and 4x4 flag
    (libwebp PrecomputeFilterStrengths); limit 0: no filtering."""
    out = []
    for s in range(4):
        base = (seg_filter[s] + (0 if absolute else level)) if use_segment else level
        row = []
        for i4 in (0, 1):
            lvl = base
            if use_lf_delta:
                lvl += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lvl = 0 if lvl < 0 else 63 if lvl > 63 else lvl
            if lvl <= 0:
                row.append((0, 0, 0))
                continue
            ilevel = lvl
            if sharpness > 0:
                ilevel >>= 2 if sharpness > 4 else 1
                ilevel = min(ilevel, 9 - sharpness)
            ilevel = max(ilevel, 1)
            row.append((2 * lvl + ilevel, ilevel, 2 if lvl >= 40 else 1 if lvl >= 15 else 0))
        out.append(row)
    return out


def _edge(lines: np.ndarray, thresh: np.ndarray, ithresh: np.ndarray, hev_t: np.ndarray,
          kind: str) -> None:
    """Filter (k, n, 8) lines across an edge between samples 3 and 4 in
    place (libwebp DoFilter2 / 4 / 6 with NeedsFilter and Hev);
    thresholds (k, 1). kind: "simple", "mb" (macroblock edge) or "inner"."""
    p3, p2, p1, p0 = lines[..., 0], lines[..., 1], lines[..., 2], lines[..., 3]
    q0, q1, q2, q3 = lines[..., 4], lines[..., 5], lines[..., 6], lines[..., 7]
    thresh2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    if kind == "simple":
        hev = mask
    else:
        mask &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
                 & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
                 & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
        hev = mask & ((np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t))
    if not mask.any():
        return
    out = lines.copy()
    # DoFilter2 where the edge has high variance (everywhere for the simple filter)
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    out[..., 3] = np.where(hev, np.clip(p0 + a2, 0, 255), out[..., 3])
    out[..., 4] = np.where(hev, np.clip(q0 - a1, 0, 255), out[..., 4])
    rest = mask & ~hev
    if kind == "mb":  # DoFilter6
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for j, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2),
                     (6, q2 - a3)):
            out[..., j] = np.where(rest, np.clip(v, 0, 255), out[..., j])
    elif kind == "inner":  # DoFilter4
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for j, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
            out[..., j] = np.where(rest, np.clip(v, 0, 255), out[..., j])
    lines[...] = out


def _filter_planes(planes: list, size: int, mb_w: int, mb_h: int, params: list,
                   inner: list, simple: bool) -> None:
    """The loop filter over same-sized planes in place, macroblock order
    kept: a macroblock waits only for its left and above-right neighbours,
    so the macroblocks of one wave t = mb_x + 2 mb_y touch disjoint windows
    and are filtered together, every plane at once (left edge, inner
    vertical edges, top edge, inner horizontal edges). An edge a
    macroblock does not filter gets a threshold no line passes."""
    P = len(planes)
    H, W = planes[0].shape
    padded = np.zeros((P, H + 4, W + 4), np.int32)
    for k, plane in enumerate(planes):
        padded[k, 4:, 4:] = plane
    win = size + 4
    ar = np.arange(win)
    mb_kind, in_kind = ("simple", "simple") if simple else ("mb", "inner")
    for t in range(mb_w + 2 * (mb_h - 1)):
        mbs = [(x, (t - x) // 2) for x in range(max(0, t - 2 * (mb_h - 1)), min(mb_w, t + 1))
               if (t - x) % 2 == 0 and params[(t - x) // 2 * mb_w + x][0]]
        if not mbs:
            continue
        xs = np.asarray([x for x, _ in mbs])
        ys = np.asarray([y for _, y in mbs])
        rows = (size * ys)[:, None] + ar  # padded coordinates: window starts 4 above
        cols = (size * xs)[:, None] + ar
        w = padded[:, rows[:, :, None], cols[:, None, :]].reshape(-1, win, win)
        prm = np.tile(np.asarray([params[y * mb_w + x] for x, y in mbs]), (P, 1))
        limit, ilevel, hev_t = prm[:, 0, None], prm[:, 1, None], prm[:, 2, None]
        inn = np.tile(np.asarray([inner[y * mb_w + x] for x, y in mbs]), P)[:, None]
        left, top = np.tile(xs > 0, P)[:, None], np.tile(ys > 0, P)[:, None]
        _edge(w[:, 4:, 0:8], np.where(left, limit + 4, -1), ilevel, hev_t, mb_kind)
        for e in range(8, win, 4):
            _edge(w[:, 4:, e - 4:e + 4], np.where(inn, limit, -1), ilevel, hev_t, in_kind)
        _edge(w[:, 0:8, 4:].transpose(0, 2, 1), np.where(top, limit + 4, -1), ilevel, hev_t,
              mb_kind)
        for e in range(8, win, 4):
            _edge(w[:, e - 4:e + 4, 4:].transpose(0, 2, 1), np.where(inn, limit, -1), ilevel,
                  hev_t, in_kind)
        padded[:, rows[:, :, None], cols[:, None, :]] = w.reshape(P, len(mbs), win, win)
    for k, plane in enumerate(planes):
        plane[...] = padded[k, 4:, 4:]


def _loop_filter(ys, us, vs, mb_w, mb_h, params, inner, simple):
    _filter_planes([ys], 16, mb_w, mb_h, params, inner, simple)
    if not simple:  # the simple filter leaves chroma alone
        _filter_planes([us, vs], 8, mb_w, mb_h, params, inner, False)


def _fancy_upsample(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """libwebp's UpsampleRgbaLinePair over a whole chroma plane: each output
    row mixes its nearer chroma row N and farther row F (9-3-3-1, with the
    first row and an even height's last row from one chroma row)."""
    c = c.astype(np.int32)
    ch, cw = c.shape
    r = np.arange(height)
    k = (r + 1) // 2
    near = np.where(r % 2 == 1, k - 1, k)
    far = np.where(r % 2 == 1, k, k - 1)
    near[0] = far[0] = 0
    last = k >= ch
    near[last] = far[last] = ch - 1
    N, F = c[near], c[far]
    out = np.empty((height, width), np.int32)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        n0, n1, f0, f1 = N[:, :pairs], N[:, 1:pairs + 1], F[:, :pairs], F[:, 1:pairs + 1]
        avg = n0 + n1 + f0 + f1 + 8
        out[:, 1:2 * pairs:2] = (((avg + 2 * (n1 + f0)) >> 3) + n0) >> 1
        out[:, 2:2 * pairs + 1:2] = (((avg + 2 * (n0 + f1)) >> 3) + n1) >> 1
    if width % 2 == 0:
        out[:, width - 1] = (3 * N[:, cw - 1] + F[:, cw - 1] + 2) >> 2
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v >= 0) & (v < 1 << 14), v >> 6, np.where(v < 0, 0, 255))


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """libwebp VP8YUVToR/G/B (14-bit fixed point, MultHi) after fancy
    upsampling -> uint8 (H, W, 3)."""
    h, w = y.shape
    uu, vv = _fancy_upsample(u, h, w), _fancy_upsample(v, h, w)
    yy = (y.astype(np.int32) * 19077) >> 8
    r = _clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = _clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _clip8(yy + ((uu * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


# ---------------------------------------------------------------- VP8L (lossless)


class _BitReader:
    """LSB-first bits through 64-bit little-endian windows at every byte."""

    def __init__(self, data: bytes, pos: int = 0):
        self.n = len(data)
        buf = np.frombuffer(data + bytes(16), np.uint8)
        w = np.zeros(self.n + 8, np.uint64)
        for j in range(8):
            w |= buf[j:j + self.n + 8].astype(np.uint64) << np.uint64(8 * j)
        self.W = w.tolist()
        self.pos = pos

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.W[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.pos > 8 * self.n:
            raise ValueError("truncated VP8L data")


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABET = (256 + 24, 256, 256, 256, 40)


def _build_code(lengths: list) -> tuple:
    """Canonical prefix code from its lengths -> (lookup list indexed by the
    next `bits` stream bits, bits); entries are symbol << 5 | length. A code
    with one symbol reads no bits, as libwebp's."""
    n_used = sum(1 for x in lengths if x)
    if n_used == 0:
        raise ValueError("VP8L prefix code without symbols")
    if n_used == 1:
        return [next(i for i, x in enumerate(lengths) if x) << 5], 0
    max_len = max(lengths)
    count = [0] * (max_len + 1)
    for x in lengths:
        count[x] += 1
    count[0] = 0
    code, nxt = 0, [0] * (max_len + 2)
    for bits in range(1, max_len + 1):
        code = (code + count[bits - 1]) << 1
        nxt[bits] = code
    # Kraft: a complete code, as libwebp requires
    if sum(count[b] << (max_len - b) for b in range(1, max_len + 1)) != 1 << max_len:
        raise ValueError("VP8L prefix code is not complete")
    size = 1 << max_len
    table = [0] * size
    for sym, ln in enumerate(lengths):
        if not ln:
            continue
        c = nxt[ln]
        nxt[ln] += 1
        rev = int(format(c, f"0{ln}b")[::-1], 2)
        entry = (sym << 5) | ln
        for k in range(rev, size, 1 << ln):
            table[k] = entry
    return table, max_len


def _read_code(br: _BitReader, alphabet: int) -> tuple:
    if br.read(1):  # simple code: one or two symbols
        two = br.read(1)
        first = br.read(8 if br.read(1) else 1)
        lengths = [0] * max(alphabet, 256)
        lengths[first] = 1
        if two:
            lengths[br.read(8)] = 1
        return _build_code(lengths[:alphabet])  # a symbol past the alphabet is dropped
    n = br.read(4) + 4
    cl = [0] * 19
    for i in range(n):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    table, bits = _build_code(cl)
    mask = (1 << bits) - 1
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("VP8L code length count above the alphabet")
    else:
        max_symbol = alphabet
    lengths = [0] * alphabet
    sym, prev = 0, 8
    W = br.W
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        p = br.pos
        e = table[(W[p >> 3] >> (p & 7)) & mask]
        br.pos = p + (e & 31)
        c = e >> 5
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + offset
            if sym + rep > alphabet:
                raise ValueError("VP8L code lengths overrun the alphabet")
            lengths[sym:sym + rep] = [prev if c == 16 else 0] * rep
            sym += rep
    return _build_code(lengths)


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_distance(sym: int, br: _BitReader) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _decode_stream(br: _BitReader, xsize: int, ysize: int, level0: bool) -> list:
    """libwebp DecodeImageStream: transforms (level 0 only), colour cache,
    prefix codes (meta codes at level 0 only), then the entropy-coded
    pixels; returns ARGB ints with the transforms undone."""
    transforms = []
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError("VP8L transform repeated")
            seen.add(kind)
            if kind in (0, 1):  # predictor, cross-colour
                bits = br.read(3) + 2
                data = _decode_stream(br, _subsample(xsize, bits), _subsample(ysize, bits), False)
                transforms.append((kind, xsize, bits, data))
            elif kind == 3:  # colour indexing
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                data = _decode_stream(br, n, 1, False)
                transforms.append((kind, xsize, bits, data))
                xsize = _subsample(xsize, bits)
            else:  # subtract green
                transforms.append((kind, xsize, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("bad VP8L colour cache size")
    hbits, himage, hx = 0, None, 1
    if level0 and br.read(1):
        hbits = br.read(3) + 2
        hx = _subsample(xsize, hbits)
        himage = [(p >> 8) & 0xFFFF for p in
                  _decode_stream(br, hx, _subsample(ysize, hbits), False)]
    n_groups = max(himage) + 1 if himage else 1
    groups = []
    for _ in range(n_groups):
        codes = []
        for j in range(5):
            alphabet = _ALPHABET[j] + ((1 << cache_bits) if j == 0 and cache_bits else 0)
            codes.append(_read_code(br, alphabet))
        groups.append(codes)
    br.check()
    pixels = _decode_pixels(br, xsize, ysize, groups, himage, hbits, hx, cache_bits)
    for kind, width, bits, data in reversed(transforms):
        pixels = _inverse_transform(kind, width, ysize, bits, data, pixels)
    return pixels


def _decode_pixels(br, width, height, groups, himage, hbits, hx, cache_bits) -> list:
    """The LZ77 / literal / colour-cache pixel stream (libwebp
    DecodeImageData)."""
    total = width * height
    out = [0] * total
    W = br.W
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cshift = 32 - cache_bits
    cache_limit = 280 + (1 << cache_bits if cache_bits else 0)
    i = col = row = 0
    pos = br.pos
    gtab = [tuple((t, (1 << b) - 1) for t, b in g) for g in groups]
    group = gtab[0]
    while i < total:
        if himage is not None:
            group = gtab[himage[(row >> hbits) * hx + (col >> hbits)]]
        (tg, mg), (tr, mr), (tb, mb), (ta, ma), (td, md) = group
        e = tg[(W[pos >> 3] >> (pos & 7)) & mg]
        pos += e & 31
        code = e >> 5
        if code < 256:
            e = tr[(W[pos >> 3] >> (pos & 7)) & mr]
            pos += e & 31
            red = e >> 5
            e = tb[(W[pos >> 3] >> (pos & 7)) & mb]
            pos += e & 31
            blue = e >> 5
            e = ta[(W[pos >> 3] >> (pos & 7)) & ma]
            pos += e & 31
            px = ((e >> 5) << 24) | (red << 16) | (code << 8) | blue
            out[i] = px
            if cache is not None:
                cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> cshift] = px
            i += 1
            col += 1
            if col == width:
                col = 0
                row += 1
        elif code < 280:
            br.pos = pos
            length = _copy_distance(code - 256, br)
            pos = br.pos
            e = td[(W[pos >> 3] >> (pos & 7)) & md]
            pos += e & 31
            br.pos = pos
            dcode = _copy_distance(e >> 5, br)
            pos = br.pos
            if dcode > 120:
                dist = dcode - 120
            else:
                c = _CODE_TO_PLANE[dcode - 1]
                dist = max((c >> 4) * width + 8 - (c & 15), 1)
            if dist > i or length > total - i:
                raise ValueError("VP8L copy out of the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            if cache is not None:
                for px in out[i:i + length]:
                    cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> cshift] = px
            i += length
            col += length
            while col >= width:
                col -= width
                row += 1
        elif code < cache_limit:
            px = cache[code - 280]
            out[i] = px
            cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> cshift] = px
            i += 1
            col += 1
            if col == width:
                col = 0
                row += 1
        else:
            raise ValueError("bad VP8L symbol")
    br.pos = pos
    br.check()
    return out


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _average2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(t: int, l: int, tl: int) -> int:
    s = 0
    for sh in (24, 16, 8, 0):
        c = (tl >> sh) & 0xFF
        s += abs(((l >> sh) & 0xFF) - c) - abs(((t >> sh) & 0xFF) - c)
    return t if s <= 0 else l


def _clamp_full(l: int, t: int, tl: int) -> int:
    out = 0
    for sh in (24, 16, 8, 0):
        v = ((l >> sh) & 0xFF) + ((t >> sh) & 0xFF) - ((tl >> sh) & 0xFF)
        out |= (0 if v < 0 else 255 if v > 255 else v) << sh
    return out


def _clamp_half(l: int, t: int, tl: int) -> int:
    ave = _average2(l, t)
    out = 0
    for sh in (24, 16, 8, 0):
        a, b = (ave >> sh) & 0xFF, (tl >> sh) & 0xFF
        d = a - b
        v = a + (d // 2 if d >= 0 else -((-d) // 2))  # C division: toward zero
        out |= (0 if v < 0 else 255 if v > 255 else v) << sh
    return out


def _predict(mode: int, l: int, t: int, tr: int, tl: int) -> int:
    """VP8L predictors 3-13 from the left, top, top-right and top-left
    pixels (0, 14 and 15: black; 1 and 2: left and top, in the caller)."""
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _average2(_average2(l, tr), t)
    if mode == 6:
        return _average2(l, tl)
    if mode == 7:
        return _average2(l, t)
    if mode == 8:
        return _average2(tl, t)
    if mode == 9:
        return _average2(t, tr)
    if mode == 10:
        return _average2(_average2(l, tl), _average2(t, tr))
    if mode == 11:
        return _select(t, l, tl)
    if mode == 12:
        return _clamp_full(l, t, tl)
    return _clamp_half(l, t, tl)


def _inverse_transform(kind, width, height, bits, data, pixels) -> list:
    if kind == 2:  # subtract green
        a = np.asarray(pixels, np.uint32)
        g = (a >> 8) & 0xFF
        rb = ((a & 0x00FF00FF) + ((g << 16) | g)) & 0x00FF00FF
        return ((a & 0xFF00FF00) | rb).tolist()
    if kind == 1:  # cross-colour
        a = np.asarray(pixels, np.uint32).reshape(height, width)
        tiles = np.asarray(data, np.uint32).reshape(_subsample(height, bits),
                                                    _subsample(width, bits))
        m = tiles[np.arange(height)[:, None] >> bits, np.arange(width)[None, :] >> bits]
        s8 = lambda x: ((x.astype(np.int64) & 0xFF) ^ 0x80) - 0x80  # noqa: E731
        g2r, g2b, r2b = s8(m), s8(m >> 8), s8(m >> 16)
        green = s8(a >> 8)
        red = ((a >> 16) & 0xFF).astype(np.int64)
        blue = (a & 0xFF).astype(np.int64)
        red = (red + ((g2r * green) >> 5)) & 0xFF
        blue = (blue + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 0xFF
        out = (a & 0xFF00FF00).astype(np.int64) | (red << 16) | blue
        return out.astype(np.uint32).reshape(-1).tolist()
    if kind == 3:  # colour indexing
        cmap = np.zeros(1 << (8 >> bits), np.uint32)  # past the palette: transparent black
        pal = np.frombuffer(np.asarray(data, np.uint32).tobytes(), np.uint8).reshape(-1, 4)
        cmap[:len(data)] = np.cumsum(pal, axis=0, dtype=np.uint8).reshape(-1).view(np.uint32)
        packed_w = _subsample(width, bits)
        idx = ((np.asarray(pixels, np.uint32) >> 8) & 0xFF).reshape(height, packed_w)
        if bits:
            per = 1 << bits
            bpp = 8 >> bits
            shifts = (np.arange(per) * bpp).astype(np.uint32)
            idx = ((idx[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(height, -1)[:, :width]
        return cmap[idx].reshape(-1).tolist()
    # predictor
    tiles_w = _subsample(width, bits)
    modes = [(d >> 8) & 0xF for d in data]
    out = list(pixels)
    out[0] = _add(out[0], 0xFF000000)
    for x in range(1, width):
        out[x] = _add(out[x], out[x - 1])
    for y in range(1, height):
        base = y * width
        up = base - width
        out[base] = _add(out[base], out[up])
        trow = (y >> bits) * tiles_w
        for x in range(1, width):
            mode = modes[trow + (x >> bits)]
            i = base + x
            if mode == 1:
                pred = out[i - 1]
            elif mode == 2:
                pred = out[up + x]
            elif mode == 0 or mode > 13:
                pred = 0xFF000000
            else:
                pred = _predict(mode, out[i - 1], out[up + x], out[up + x + 1], out[up + x - 1])
            out[i] = _add(out[i], pred)
    return out


def _decode_vp8l(data: bytes):
    """A VP8L bitstream -> (ARGB uint32 (H, W), width, height, alpha bit)."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("bad VP8L signature")
    (hdr,) = struct.unpack_from("<I", data, 1)
    width, height = (hdr & 0x3FFF) + 1, ((hdr >> 14) & 0x3FFF) + 1
    alpha, version = (hdr >> 28) & 1, hdr >> 29
    if version:
        raise ValueError(f"VP8L version {version}")
    if width * height > MAX_PIXELS:
        raise ValueError(f"VP8L image of {width} x {height} pixels (at most {MAX_PIXELS})")
    br = _BitReader(data, 40)
    argb = _decode_stream(br, width, height, True)
    return np.asarray(argb, np.uint32).reshape(height, width), width, height, bool(alpha)


def _argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    return np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF, argb >> 24],
                    axis=-1).astype(np.uint8)


# ---------------------------------------------------------------- ALPH


def _decode_alpha(chunk: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk -> uint8 (H, W): raw or VP8L (green channel), then the
    unfilter (libwebp filters.c)."""
    if not chunk:
        raise ValueError("empty ALPH chunk")
    method, filt, pre, rsrv = chunk[0] & 3, (chunk[0] >> 2) & 3, (chunk[0] >> 4) & 3, chunk[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError("bad ALPH header")
    if method == 0:
        if len(chunk) - 1 < width * height:
            raise ValueError("truncated ALPH data")
        a = np.frombuffer(chunk, np.uint8, width * height, 1).reshape(height, width)
    else:
        br = _BitReader(chunk[1:])
        a = ((np.asarray(_decode_stream(br, width, height, True), np.uint32) >> 8)
             & 0xFF).astype(np.uint8).reshape(height, width)
    a = a.astype(np.int64)
    if filt == 0:
        return a.astype(np.uint8)
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 0xFF  # row 0 is filtered horizontally in every mode
    if filt == 1:  # horizontal: each row starts from the sample above its first
        for y in range(1, height):
            row = a[y].copy()
            row[0] += out[y - 1, 0]
            out[y] = np.cumsum(row) & 0xFF
    elif filt == 2:  # vertical
        out[1:] = (np.cumsum(a[1:], axis=0) + out[0]) & 0xFF
    else:  # gradient
        prev = out[0].tolist()
        for y in range(1, height):
            src = a[y].tolist()
            row = [0] * width
            left = tl = prev[0]
            for x in range(width):
                t = prev[x]
                g = left + t - tl
                left = (src[x] + (0 if g < 0 else 255 if g > 255 else g)) & 0xFF
                tl = t
                row[x] = left
            out[y] = row
            prev = row
    return out.astype(np.uint8)
